"""Post-process kernels: fog, motion blur, depth of field, FXAA, CAS.

Role-equivalents (all arkose/rendering/...):
  * fog           — postprocess/FogNode.cpp + shaders/postprocess/fog.comp
  * motion blur   — postprocess/MotionBlurNode.cpp, McGuire-style
                    tileMax -> neighborMax -> reconstruction filter
                    (shaders/motion-blur/*.comp)
  * depth of field— nodes/DepthOfFieldNode.cpp: physically-based CoC from
                    the camera (depth-of-field/calculateCoc.comp) + bokeh
                    gather blur (bokehBlur.comp)
  * FXAA          — nodes/FXAANode.cpp (FXAA 3.11-style luma edge blend)
  * CAS           — postprocess/CASNode.cpp (AMD FFX contrast-adaptive
                    sharpening)

All are (H, W, C) image kernels in jnp; XLA fuses each into a handful of
fused loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core.halton import fibonacci_disc
from arkoserenderer.ops.image import bilinear_sample, luminance


# ---------------------------------------------------------------------------
# Fog


def apply_fog(
    color: jax.Array,        # (H, W, 3)
    world_pos: jax.Array,    # (H, W, 3) reconstructed
    valid: jax.Array,        # (H, W) geometry coverage
    cam_pos: jax.Array,      # (3,)
    fog_color: jax.Array,    # (3,) pre-exposed
    density: float = 0.02,
    height_falloff: float = 0.1,
    base_height: float = 0.0,
) -> jax.Array:
    """Exponential height fog along the view distance."""
    dist = jnp.linalg.norm(world_pos - cam_pos, axis=-1)
    h = world_pos[..., 1] - base_height
    height_term = jnp.exp(-height_falloff * jnp.maximum(h, 0.0))
    transmittance = jnp.exp(-density * dist * height_term)
    transmittance = jnp.where(valid, transmittance, 1.0)[..., None]
    return color * transmittance + fog_color * (1.0 - transmittance)


# ---------------------------------------------------------------------------
# Motion blur (McGuire)


def _nearest_sample(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Single-gather nearest fetch at pixel-center coords (clamped). With a
    per-pixel uniform jitter in [-0.5, 0.5) added to the coords, its
    EXPECTATION equals the bilinear fetch — the stochastic-tap primitive
    shared by the motion-blur / DoF fast paths (TAA converges the noise)."""
    h, w = img.shape[0], img.shape[1]
    xi = jnp.clip((x - 0.5).round().astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((y - 0.5).round().astype(jnp.int32), 0, h - 1)
    return img.reshape(-1, img.shape[-1])[yi * w + xi]


def _pixel_noise(px, py, frame_index, salt: int) -> jax.Array:
    # Blue-noise mask lookup (ops/noise.py): same contract as the old
    # integer-hash white noise, but stochastic-tap error is high-frequency
    # (GpuScene.cpp:364-474 blue-noise binding analogue).
    from arkoserenderer.ops.noise import sample_blue_noise

    return sample_blue_noise(px, py, frame_index, salt)


def _white_pixel_noise(px, py, frame_index, salt: int) -> jax.Array:
    fi = frame_index if frame_index is not None else 0
    seed = (
        px.astype(jnp.uint32)
        + py.astype(jnp.uint32) * jnp.uint32(19349663)
        + jnp.asarray(fi).astype(jnp.uint32) * jnp.uint32(83492791)
        + jnp.uint32((salt * 374761393) & 0xFFFFFFFF)
    )
    seed = seed ^ (seed >> 16)
    seed = seed * jnp.uint32(0x7FEB352D)
    seed = seed ^ (seed >> 15)
    seed = seed * jnp.uint32(0x846CA68B)
    seed = seed ^ (seed >> 16)
    return (seed >> 8).astype(jnp.float32) * (1.0 / 16777216.0)


def motion_blur(
    color: jax.Array,     # (H, W, 3)
    velocity: jax.Array,  # (H, W, 2) pixels/frame
    depth: jax.Array,     # (H, W) reverse-Z
    shutter_scale: float = 0.5,   # 180-degree shutter
    tile: int = 16,
    num_taps: int = 8,
    max_blur_px: float = 24.0,
    stochastic: bool = False,   # jittered nearest taps (2 is plenty) + TAA
    frame_index: jax.Array | None = None,
) -> jax.Array:
    h, w = color.shape[0], color.shape[1]
    vel = velocity * shutter_scale
    speed = jnp.linalg.norm(vel, axis=-1, keepdims=True)
    vel = vel * (jnp.minimum(speed, max_blur_px) / jnp.maximum(speed, 1e-6))

    # tileMax: dominant velocity per tile; then neighborMax over 3x3 tiles.
    th, tw = h // tile, w // tile
    v_t = vel.reshape(th, tile, tw, tile, 2)
    sp_t = jnp.linalg.norm(v_t, axis=-1)
    flat = v_t.reshape(th, tile * tile * tw, 2)  # keep argmax simple per tile
    sp_flat = sp_t.transpose(0, 2, 1, 3).reshape(th, tw, tile * tile)
    v_tiles = v_t.transpose(0, 2, 1, 3, 4).reshape(th, tw, tile * tile, 2)
    idx = jnp.argmax(sp_flat, axis=-1)
    tile_max = jnp.take_along_axis(v_tiles, idx[..., None, None], axis=2)[:, :, 0]

    def shift2(a, dy, dx):
        ys = jnp.clip(jnp.arange(th) + dy, 0, th - 1)
        xs = jnp.clip(jnp.arange(tw) + dx, 0, tw - 1)
        return a[ys][:, xs]

    neighbor = tile_max
    best = jnp.linalg.norm(tile_max, axis=-1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cand = shift2(tile_max, dy, dx)
            cs = jnp.linalg.norm(cand, axis=-1)
            take = cs > best
            neighbor = jnp.where(take[..., None], cand, neighbor)
            best = jnp.maximum(best, cs)

    nmax = jnp.repeat(jnp.repeat(neighbor, tile, 0), tile, 1)  # (H, W, 2)

    xs = jnp.arange(w, dtype=jnp.float32) + 0.5
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5
    pxg, pyg = jnp.meshgrid(xs, ys)
    px = pxg.reshape(-1)
    py = pyg.reshape(-1)
    nv = nmax.reshape(-1, 2)

    acc = color.reshape(-1, 3)
    wsum = jnp.ones((acc.shape[0], 1))
    # Fetch color+velocity as ONE 5-channel image per tap (one gather op
    # instead of two on the stochastic path).
    cv = jnp.concatenate([color, vel], axis=-1)
    for i in range(num_taps):
        if stochastic:
            # Stratified jittered shutter position + sub-texel jitter: the
            # per-tap expectation equals the dense bilinear tap ladder.
            u = _pixel_noise(px, py, frame_index, 11 + i)
            t = (i + u) / num_taps - 0.5
            jx = _pixel_noise(px, py, frame_index, 21 + i) - 0.5
            jy = _pixel_noise(px, py, frame_index, 31 + i) - 0.5
            both = _nearest_sample(cv, px + nv[:, 0] * t + jx,
                                   py + nv[:, 1] * t + jy)
            c, sample_vel = both[:, :3], both[:, 3:5]
        else:
            t = (i + 1) / (num_taps + 1) - 0.5  # [-0.5, 0.5)
            sx = px + nv[:, 0] * t
            sy = py + nv[:, 1] * t
            c = bilinear_sample(color, sx, sy)
            sample_vel = bilinear_sample(vel, sx, sy)
        wgt = jnp.minimum(jnp.linalg.norm(sample_vel, axis=-1, keepdims=True), 1.0)
        if stochastic:
            # Keep the center-vs-taps weight ratio of the dense 8-tap
            # ladder: each of the M jittered taps stands for 8/M dense taps
            # (otherwise fewer taps over-weight the unblurred center).
            wgt = wgt * (8.0 / num_taps)
        acc = acc + c * wgt
        wsum = wsum + wgt
    return (acc / wsum).reshape(h, w, 3)


# ---------------------------------------------------------------------------
# Depth of field


def compute_coc(
    depth: jax.Array,          # (H, W) reverse-Z
    valid: jax.Array,          # (H, W)
    near: jax.Array,           # () camera near
    focus_depth: jax.Array,    # () meters
    aperture_px: jax.Array,    # () CoC scale (CameraState.aperture_px)
    max_coc: float = 16.0,
) -> jax.Array:
    """Signed circle of confusion in pixels (negative = in front of focus).

    Uses the infinite-far reverse-Z inversion z_view = near / depth
    (calculateCoc.comp's physically-based CoC with our depth convention).
    """
    z = near / jnp.maximum(depth, 1e-8)  # view-space distance, meters
    signed = aperture_px * (z - focus_depth) / jnp.maximum(z, 1e-4)
    signed = jnp.where(valid, signed, max_coc)  # background blurs fully
    return jnp.clip(signed, -max_coc, max_coc)


def depth_of_field(
    color: jax.Array,   # (H, W, 3)
    coc: jax.Array,     # (H, W) signed pixels
    num_taps: int = 24,
    stochastic_taps: int | None = None,  # jittered disc subset + TAA
    frame_index: jax.Array | None = None,
) -> jax.Array:
    """Scatter-as-gather bokeh blur: disc taps scaled by |CoC|, each tap
    weighted by whether ITS own CoC reaches back to the center pixel.

    ``stochastic_taps``: evaluate M per-pixel-rotated disc taps instead of
    the full fibonacci fan (each tap = ONE gather of a color+CoC packed
    image); the rotation re-randomizes per frame so TAA converges to the
    dense bokeh (24 -> 4 taps is ~12x fewer gather ops)."""
    h, w = color.shape[0], color.shape[1]
    xs = jnp.arange(w, dtype=jnp.float32) + 0.5
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5
    pxg, pyg = jnp.meshgrid(xs, ys)
    px = pxg.reshape(-1)
    py = pyg.reshape(-1)
    r = jnp.abs(coc).reshape(-1)

    acc = color.reshape(-1, 3)
    wsum = jnp.ones((acc.shape[0], 1))
    if stochastic_taps:
        cc = jnp.concatenate([color, jnp.abs(coc)[..., None]], axis=-1)
        base = jnp.asarray(fibonacci_disc(stochastic_taps))
        ang = _pixel_noise(px, py, frame_index, 41) * (2.0 * jnp.pi)
        ca, sa = jnp.cos(ang), jnp.sin(ang)
        for i in range(stochastic_taps):
            # Per-pixel rotated tap + radius jitter (area-preserving).
            u = _pixel_noise(px, py, frame_index, 51 + i)
            rad = r * jnp.sqrt(
                jnp.clip(base[i, 0] ** 2 + base[i, 1] ** 2 + (u - 0.5) * (2.0 / stochastic_taps), 0.0, 1.0)
            )
            phi = jnp.arctan2(base[i, 1], base[i, 0])
            dx = rad * (jnp.cos(phi) * ca - jnp.sin(phi) * sa)
            dy = rad * (jnp.sin(phi) * ca + jnp.cos(phi) * sa)
            dist = jnp.sqrt(dx * dx + dy * dy)
            both = _nearest_sample(cc, px + dx, py + dy)
            c, tap_coc = both[:, :3], both[:, 3]
            # Each jittered tap stands for num_taps/M dense disc taps
            # (keeps the center pixel's relative weight unchanged).
            wgt = jnp.clip(tap_coc - dist + 1.0, 0.0, 1.0)[:, None]
            wgt = wgt * (num_taps / stochastic_taps)
            acc = acc + c * wgt
            wsum = wsum + wgt
        return (acc / wsum).reshape(h, w, 3)
    taps = jnp.asarray(fibonacci_disc(num_taps))
    for i in range(num_taps):
        dx = taps[i, 0] * r
        dy = taps[i, 1] * r
        dist = jnp.sqrt(dx * dx + dy * dy)
        c = bilinear_sample(color, px + dx, py + dy)
        tap_coc = jnp.abs(bilinear_sample(coc[..., None], px + dx, py + dy)[:, 0])
        wgt = jnp.clip(tap_coc - dist + 1.0, 0.0, 1.0)[:, None]
        acc = acc + c * wgt
        wsum = wsum + wgt
    return (acc / wsum).reshape(h, w, 3)


# ---------------------------------------------------------------------------
# FXAA (3.11-style, simplified)


def fxaa(ldr: jax.Array, edge_threshold: float = 0.125, min_threshold: float = 0.0312) -> jax.Array:
    """Luma-driven edge anti-aliasing on the final LDR image."""
    h, w = ldr.shape[0], ldr.shape[1]
    luma = luminance(ldr)[..., 0]

    def shift(a, dy, dx):
        ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
        xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
        return a[ys][:, xs]

    l_c = luma
    l_n = shift(luma, -1, 0)
    l_s = shift(luma, 1, 0)
    l_e = shift(luma, 0, 1)
    l_w = shift(luma, 0, -1)
    l_min = jnp.minimum(l_c, jnp.minimum(jnp.minimum(l_n, l_s), jnp.minimum(l_e, l_w)))
    l_max = jnp.maximum(l_c, jnp.maximum(jnp.maximum(l_n, l_s), jnp.maximum(l_e, l_w)))
    contrast = l_max - l_min
    threshold = jnp.maximum(min_threshold, l_max * edge_threshold)
    active = contrast >= threshold

    # Blur direction perpendicular to the luma gradient.
    horiz = (jnp.abs(l_n + l_s - 2 * l_c) >= jnp.abs(l_e + l_w - 2 * l_c))[..., None]
    blur_a = jnp.where(horiz, shift_img(ldr, -1, 0), shift_img(ldr, 0, -1))
    blur_b = jnp.where(horiz, shift_img(ldr, 1, 0), shift_img(ldr, 0, 1))
    blended = 0.5 * ldr + 0.25 * (blur_a + blur_b)
    return jnp.where(active[..., None], blended, ldr)


def shift_img(img, dy, dx):
    """Edge-clamped static shift via pad+slice (elementwise data movement —
    index-array takes lower to the ~26 ms/op gather class on this chip)."""
    h, w = img.shape[0], img.shape[1]
    ay, ax = abs(dy), abs(dx)
    pad = [(ay, ay), (ax, ax)] + [(0, 0)] * (img.ndim - 2)
    p = jnp.pad(img, pad, mode="edge")
    return p[ay + dy : ay + dy + h, ax + dx : ax + dx + w]


def fxaa_active_mask(ldr, edge_threshold=0.125, min_threshold=0.0312):
    luma = luminance(ldr)[..., 0]
    l_n = shift_img(luma[..., None], -1, 0)[..., 0]
    l_s = shift_img(luma[..., None], 1, 0)[..., 0]
    l_e = shift_img(luma[..., None], 0, 1)[..., 0]
    l_w = shift_img(luma[..., None], 0, -1)[..., 0]
    l_min = jnp.minimum(luma, jnp.minimum(jnp.minimum(l_n, l_s), jnp.minimum(l_e, l_w)))
    l_max = jnp.maximum(luma, jnp.maximum(jnp.maximum(l_n, l_s), jnp.maximum(l_e, l_w)))
    contrast = l_max - l_min
    return contrast >= jnp.maximum(min_threshold, l_max * edge_threshold)


# ---------------------------------------------------------------------------
# CAS (contrast-adaptive sharpening)


def cas(ldr: jax.Array, sharpness: float = 0.5) -> jax.Array:
    """AMD FFX-CAS-style 3x3 adaptive sharpen on the LDR image."""
    n = shift_img(ldr, -1, 0)
    s = shift_img(ldr, 1, 0)
    e = shift_img(ldr, 0, 1)
    w_ = shift_img(ldr, 0, -1)
    mn = jnp.minimum(jnp.minimum(n, s), jnp.minimum(jnp.minimum(e, w_), ldr))
    mx = jnp.maximum(jnp.maximum(n, s), jnp.maximum(jnp.maximum(e, w_), ldr))
    # Per-pixel adaptive weight from local contrast headroom.
    amp = jnp.sqrt(jnp.clip(jnp.minimum(mn, 1.0 - mx) / jnp.maximum(mx, 1e-4), 0.0, 1.0))
    peak = -1.0 / (8.0 - 3.0 * sharpness)
    w_k = amp * peak
    out = (ldr + w_k * (n + s + e + w_)) / (1.0 + 4.0 * w_k)
    return jnp.clip(out, 0.0, 1.0)
