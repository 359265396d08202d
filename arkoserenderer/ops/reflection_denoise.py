"""FFX-SSSR-style reflection denoiser: reproject -> prefilter ->
resolve-temporal, as three distinct stages over persistent history state.

Role-equivalent to the reference's 4-compute-state denoiser chain
(arkose/rendering/nodes/RTReflectionsNode.cpp:23-288 dispatching
shaders/rt-reflections/{reproject,prefilter,resolveTemporal,historyCopy}.comp
from the FFX denoiser, shaders/rt-reflections/ffx-denoiser/*.h):

  * ``reproject``      — velocity-based history fetch with a DEPTH
                         disocclusion test against last frame's depth buffer
                         (reproject.comp's depth/normal consistency test).
  * ``prefilter``      — edge-aware spatial blur guided by depth + normal
                         similarity, radius scaled by roughness
                         (prefilter.comp's EAW pass). Static-shift taps only:
                         gather-free (index-array shifts would be gathers).
  * ``resolve_temporal`` — variance-guided temporal blend: per-pixel
                         luminance moments accumulate across frames; history
                         is clamped to mean +- gamma*sigma of the CURRENT
                         spatial neighborhood (resolveTemporal.comp), with a
                         sample-count ramp so fresh disocclusions converge
                         fast without ghosting. historyCopy is implicit (the
                         outputs ARE next frame's history in the registry).

State carried across frames: history color (H, W, 3), moments (H, W, 3)
= (mean-luma, mean-luma^2, sample count), previous depth (H, W).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.ops.image import (
    bilinear_sample,
    bilinear_sample_small_offset,
    luminance,
)
from arkoserenderer.ops.postprocess import shift_img


def reproject(
    history: jax.Array,      # (H, W, 3) resolved reflections, frame N-1
    moments_hist: jax.Array,  # (H, W, 3) luma moments + sample count, N-1
    prev_depth: jax.Array,   # (H, W) reverse-Z depth buffer, frame N-1
    depth: jax.Array,        # (H, W) current depth
    velocity: jax.Array,     # (H, W, 2) screen-space motion (pixels)
    px: jax.Array,           # (N,) current pixel centers x
    py: jax.Array,           # (N,) current pixel centers y (band-local)
    depth_tolerance: float = 2e-3,
):
    """Returns (hist_color, hist_moments, confidence in [0, 1])."""
    h, w = depth.shape
    vel = velocity.reshape(-1, 2)
    prev_x = px - vel[:, 0]
    prev_y = py - vel[:, 1]
    # All three history planes sample at the same coordinates: fetch them
    # as one 7-channel resample. Sub-pixel motion uses the gather-free
    # nine-shift path (ops/image.bilinear_sample_small_offset); fast motion
    # falls back to the gather path via lax.cond.
    packed = jnp.concatenate([history, moments_hist, prev_depth[..., None]], -1)
    max_v = jnp.max(jnp.abs(velocity))

    def _fast(_):
        return bilinear_sample_small_offset(
            packed, -velocity[..., 0], -velocity[..., 1]
        )

    def _slow(_):
        return bilinear_sample(packed, prev_x, prev_y).reshape(h, w, 7)

    fetched = jax.lax.cond(max_v <= 1.0, _fast, _slow, None)
    hist = fetched[..., 0:3]
    mom = fetched[..., 3:6]
    d_prev = fetched[..., 6]

    on_screen = (
        (prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0) & (prev_y < h)
    ).reshape(h, w)
    # Disocclusion test: the surface we land on last frame must be the same
    # surface. The threshold scales with the LOCAL depth gradient so grazing
    # surfaces (large dz/dpixel — e.g. floors) survive the raster's sub-pixel
    # Halton jitter, while true disocclusions (step edges to a different
    # surface) still trip it (reproject.comp's slope-scaled depth test).
    gx = jnp.abs(shift_img(depth[..., None], 0, 1) - shift_img(depth[..., None], 0, -1))[..., 0]
    gy = jnp.abs(shift_img(depth[..., None], 1, 0) - shift_img(depth[..., None], -1, 0))[..., 0]
    grad = 0.5 * jnp.maximum(gx, gy)
    tol = 2.0 * grad + depth_tolerance * jnp.maximum(jnp.abs(depth), 1e-4) + 1e-5
    depth_ok = jnp.abs(d_prev - depth) <= tol
    confidence = (on_screen & depth_ok).astype(jnp.float32)
    return hist, mom, confidence


def prefilter(
    refl: jax.Array,      # (H, W, 3) raw reflection radiance
    rough: jax.Array,     # (H, W, 1) perceptual roughness
    normal: jax.Array,    # (H, W, 3) world normals
    depth: jax.Array,     # (H, W) reverse-Z depth
    sigma_n: float = 32.0,
    depth_sigma: float = 4e-3,
) -> jax.Array:
    """Edge-aware spatial blur, radius scaled by roughness.

    Two rings of static-shift taps (8 at +-1, 8 at +-2); tap weights combine
    a normal-similarity power (prefilter.comp's normal weight), a relative
    depth term, and a roughness gate (mirror pixels pass through untouched).
    """
    d = depth[..., None]
    offsets1 = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1)]
    offsets2 = [(-2, 0), (2, 0), (0, -2), (0, 2), (-2, -2), (-2, 2), (2, -2), (2, 2)]

    acc = refl
    wacc = jnp.ones_like(d)
    for ring, offs in ((1.0, offsets1), (0.5, offsets2)):
        for dy, dx in offs:
            c = shift_img(refl, dy, dx)
            n = shift_img(normal, dy, dx)
            dd = shift_img(d, dy, dx)
            w_n = jnp.maximum(jnp.sum(n * normal, -1, keepdims=True), 0.0) ** sigma_n
            w_d = jnp.exp(-jnp.abs(dd - d) / depth_sigma)
            w = ring * w_n * w_d
            acc = acc + c * w
            wacc = wacc + w
    blurred = acc / wacc
    # Roughness gate: radius ~ 0 for mirrors, full blur by rough ~ 0.3.
    gate = jnp.clip(rough / 0.3, 0.0, 1.0)
    return refl + (blurred - refl) * gate


def resolve_temporal(
    filtered: jax.Array,    # (H, W, 3) prefiltered current reflections
    hist: jax.Array,        # (H, W, 3) reprojected history
    mom_hist: jax.Array,    # (H, W, 3) reprojected (m1, m2, count)
    confidence: jax.Array,  # (H, W) reprojection confidence
    first_frame: jax.Array,  # () bool-ish
    max_samples: float = 16.0,
    gamma: float = 1.2,
):
    """Variance-clamped exponential accumulation.

    Returns (resolved, new_moments). The history clamp box is mean +-
    gamma*sigma of the CURRENT frame's 3x3 spatial moments (resolveTemporal
    .comp's color-box clamp) — tighter than min/max clamping for glossy
    noise while still killing ghosting.
    """
    # 3x3 spatial box + moments of the current frame. The clamp box is the
    # neighborhood min/max expanded by gamma*sigma plus a small RELATIVE
    # epsilon: a pure mean+-sigma box collapses to a point in smooth regions
    # (sigma ~ 0) and would snap history to the current jittered frame every
    # time, destroying accumulation entirely.
    s1 = filtered
    s2 = filtered * filtered
    s_min = filtered
    s_max = filtered
    cnt = 1.0
    for dy, dx in [(-1, 0), (1, 0), (0, -1), (0, 1),
                   (-1, -1), (-1, 1), (1, -1), (1, 1)]:
        c = shift_img(filtered, dy, dx)
        s1 = s1 + c
        s2 = s2 + c * c
        s_min = jnp.minimum(s_min, c)
        s_max = jnp.maximum(s_max, c)
        cnt += 1.0
    mu = s1 / cnt
    sigma = jnp.sqrt(jnp.maximum(s2 / cnt - mu * mu, 0.0))
    # TEMPORAL variance from the accumulated luminance moments: pixels that
    # flicker across frames (aliased edges, glossy sparkle) get a wider box,
    # letting the history converge to the temporal MEAN instead of being
    # re-clamped into each frame's box (which loses energy on bright
    # flicker) — the FFX denoiser's variance-guided temporal weighting.
    sigma_t = jnp.sqrt(jnp.maximum(
        mom_hist[..., 1:2] - mom_hist[..., 0:1] ** 2, 0.0
    ))
    eps = gamma * sigma + 1.5 * sigma_t + 0.05 * mu + 1e-4
    hist_clamped = jnp.clip(hist, s_min - eps, s_max + eps)

    conf = confidence[..., None]
    reset = jnp.maximum(1.0 - conf, (first_frame != 0).astype(jnp.float32))
    n_prev = mom_hist[..., 2:3] * (1.0 - reset)
    n = jnp.minimum(n_prev + 1.0, max_samples)
    alpha = 1.0 / n                       # 1, 1/2, ... 1/max — fast converge
    resolved = hist_clamped + (filtered - hist_clamped) * alpha
    resolved = jnp.where(reset > 0.5, filtered, resolved)

    luma = luminance(resolved)
    m1 = mom_hist[..., 0:1] * (1.0 - alpha) + luma * alpha
    m2 = mom_hist[..., 1:2] * (1.0 - alpha) + luma * luma * alpha
    m1 = jnp.where(reset > 0.5, luma, m1)
    m2 = jnp.where(reset > 0.5, luma * luma, m2)
    new_moments = jnp.concatenate([m1, m2, n], axis=-1)
    return resolved, new_moments
