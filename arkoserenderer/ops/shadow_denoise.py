"""Sigma-style stochastic shadow denoiser (the reference's NRD slot).

The reference evaluates NRD's *sigma* denoiser over its ray-traced shadow
signal (arkose/rendering/backend/vulkan/features/nrd/VulkanNRD.cpp, exposed
through ExternalFeature.h:11-78): a stochastic 1-ray-per-pixel visibility
estimate (sun disk / light sphere sampled per frame) is reprojected,
variance-tracked, and spatially filtered into a stable penumbra.

This is the array-program equivalent, built from the same bones as the FFX reflection
chain (ops/reflection_denoise.py) but channel-generic over a LAST-axis stack
of scalar shadow planes, so the sun mask (C=1) and the local-light mask
stack (C=#lights) share one code path and ONE history resample:

  * ``reproject``        — velocity-based history fetch of all planes +
                           their luminance moments + last frame's depth as a
                           single packed resample; slope-scaled depth
                           disocclusion test shared across planes.
  * ``prefilter``        — variance-guided cross-bilateral blur: tap
                           weights combine normal and depth similarity,
                           and the blur GATE is the temporal sigma per
                           pixel — converged umbra/lit pixels pass through
                           untouched, noisy penumbra pixels blur. Static
                           shifts only (gather-free).
  * ``resolve_temporal`` — per-plane variance-clamped exponential
                           accumulation with a shared sample-count ramp
                           (disocclusions reconverge in a few frames).

State per denoised stack: masks (H, W, C), moments (H, W, 2C+1) laid out as
[m1 x C, m2 x C, shared count], previous depth (H, W).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops.image import (
    bilinear_sample,
    bilinear_sample_small_offset,
)
from arkoserenderer.ops.postprocess import shift_img


def initial_moments(h: int, w: int, c: int) -> jnp.ndarray:
    """Zero-sample moment plane layout [m1 x C, m2 x C, count]."""
    return jnp.zeros((h, w, 2 * c + 1), jnp.float32)


def normals_from_depth(world: jax.Array) -> jax.Array:
    """Geometric normals from reconstructed world positions (H, W, 3).

    The RT shadow passes run BEFORE the shading pass that publishes
    SceneNormal (they feed it), so the denoiser's edge-stopping normal is
    derived from the depth buffer — central world-position differences, the
    standard shadow-denoiser guide (NRD does the same when no normal input
    is bound). Sign is view-consistent, which is all the similarity weight
    needs."""
    dx = shift_img(world, 0, 1) - shift_img(world, 0, -1)
    dy = shift_img(world, 1, 0) - shift_img(world, -1, 0)
    n = jnp.cross(dy, dx)
    return n / jnp.sqrt(
        jnp.maximum(jnp.sum(n * n, -1, keepdims=True), 1e-20)
    )


def camera_velocity(
    world: jax.Array,       # (H, W, 3) reconstructed world positions
    px: jax.Array,          # (N,) current pixel centers x (frame coords)
    py: jax.Array,          # (N,) current pixel centers y (frame coords)
    prev_view_proj: jax.Array,  # (4, 4)
    width: int,
    frame_height: int,
) -> jax.Array:
    """(H, W, 2) camera-motion screen velocity in pixels (cur - prev).

    Object motion is not included (the G-buffer velocity that carries it is
    produced AFTER these passes); the disocclusion confidence test catches
    what this misses. Coordinate differences are band-invariant, so frame
    coords are fine under band sharding."""
    h, w = world.shape[:2]
    wp = world.reshape(-1, 3)
    clip = jnp.concatenate([wp, jnp.ones((wp.shape[0], 1), wp.dtype)], -1)
    clip = mx.matmul(clip, prev_view_proj.T)
    den = clip[:, 3:4]
    inv = jnp.where(jnp.abs(den) > 1e-10,
                    1.0 / jnp.where(den == 0, 1.0, den), 0.0)
    ndc = clip[:, :2] * inv
    px_prev = (ndc[:, 0] * 0.5 + 0.5) * width
    py_prev = (0.5 - ndc[:, 1] * 0.5) * frame_height
    return jnp.stack([px - px_prev, py - py_prev], -1).reshape(h, w, 2)


def reproject(
    hist: jax.Array,       # (H, W, C) resolved masks, frame N-1
    mom_hist: jax.Array,   # (H, W, 2C+1) [m1 x C, m2 x C, count], N-1
    prev_depth: jax.Array,  # (H, W) reverse-Z depth, frame N-1
    depth: jax.Array,      # (H, W) current depth
    velocity: jax.Array,   # (H, W, 2) screen-space motion (pixels)
    px: jax.Array,         # (N,) current pixel centers x
    py: jax.Array,         # (N,) current pixel centers y (band-local)
    depth_tolerance: float = 2e-3,
):
    """Returns (hist, mom_hist, confidence) resampled to current pixels."""
    h, w = depth.shape
    c = hist.shape[-1]
    vel = velocity.reshape(-1, 2)
    prev_x = px - vel[:, 0]
    prev_y = py - vel[:, 1]
    packed = jnp.concatenate([hist, mom_hist, prev_depth[..., None]], -1)
    max_v = jnp.max(jnp.abs(velocity))

    def _fast(_):
        return bilinear_sample_small_offset(
            packed, -velocity[..., 0], -velocity[..., 1]
        )

    def _slow(_):
        return bilinear_sample(packed, prev_x, prev_y).reshape(
            h, w, packed.shape[-1]
        )

    fetched = jax.lax.cond(max_v <= 1.0, _fast, _slow, None)
    hist_r = fetched[..., :c]
    mom_r = fetched[..., c:3 * c + 1]
    d_prev = fetched[..., 3 * c + 1]

    on_screen = (
        (prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0) & (prev_y < h)
    ).reshape(h, w)
    # Slope-scaled disocclusion test (reflection_denoise.reproject): grazing
    # surfaces survive sub-pixel jitter, step edges to another surface trip.
    gx = jnp.abs(shift_img(depth[..., None], 0, 1)
                 - shift_img(depth[..., None], 0, -1))[..., 0]
    gy = jnp.abs(shift_img(depth[..., None], 1, 0)
                 - shift_img(depth[..., None], -1, 0))[..., 0]
    grad = 0.5 * jnp.maximum(gx, gy)
    tol = 2.0 * grad + depth_tolerance * jnp.maximum(jnp.abs(depth), 1e-4) + 1e-5
    depth_ok = jnp.abs(d_prev - depth) <= tol
    confidence = (on_screen & depth_ok).astype(jnp.float32)
    return hist_r, mom_r, confidence


def prefilter(
    mask: jax.Array,      # (H, W, C) raw stochastic visibility
    normal: jax.Array,    # (H, W, 3) world normals
    depth: jax.Array,     # (H, W) reverse-Z depth
    mom_hist: jax.Array,  # (H, W, 2C+1) reprojected moments (temporal gate)
    sigma_n: float = 16.0,
    depth_sigma: float = 4e-3,
) -> jax.Array:
    """Variance-guided cross-bilateral blur of the stochastic masks.

    The gate is per-pixel-per-plane TEMPORAL sigma: penumbra pixels flicker
    between 0 and 1 across frames (sigma ~ 0.5 -> full blur) while stably
    lit/umbra pixels have sigma 0 and pass through EXACTLY. The 3x3 spatial
    sigma only helps during the first few frames (faded by the accumulated
    sample count): a permanent spatial-sigma gate would bleed shadow across
    the penumbra boundary into lit pixels forever (it stays high near any
    edge), a measured ~0.3 bias.
    """
    c = mask.shape[-1]
    d = depth[..., None]
    m1 = mom_hist[..., :c]
    m2 = mom_hist[..., c:2 * c]
    n_acc = mom_hist[..., 2 * c:2 * c + 1]
    sigma_t = jnp.sqrt(jnp.maximum(m2 - m1 * m1, 0.0))

    offsets1 = [(-1, 0), (1, 0), (0, -1), (0, 1),
                (-1, -1), (-1, 1), (1, -1), (1, 1)]
    offsets2 = [(-2, 0), (2, 0), (0, -2), (0, 2),
                (-2, -2), (-2, 2), (2, -2), (2, 2)]

    acc = mask
    s1 = mask
    s2 = mask * mask
    cnt = 1.0
    wacc = jnp.ones_like(mask)
    for ring, offs in ((1.0, offsets1), (0.5, offsets2)):
        for dy, dx in offs:
            m = shift_img(mask, dy, dx)
            n = shift_img(normal, dy, dx)
            dd = shift_img(d, dy, dx)
            m1_t = shift_img(m1, dy, dx)
            w_n = jnp.maximum(
                jnp.sum(n * normal, -1, keepdims=True), 0.0
            ) ** sigma_n
            w_d = jnp.exp(-jnp.abs(dd - d) / depth_sigma)
            # History-mean similarity: once the temporal mean exists, taps
            # from a different iso-visibility band (deeper/shallower in the
            # penumbra) are down-weighted, so the blur reduces VARIANCE
            # without flattening the penumbra GRADIENT. Neutral on the
            # first frames (all means ~equal), per-plane thereafter.
            w_m = jnp.exp(-jnp.abs(m1_t - m1) / 0.15)
            w = ring * w_n * w_d * w_m
            acc = acc + m * w
            wacc = wacc + w
            if ring == 1.0:
                s1 = s1 + m
                s2 = s2 + m * m
                cnt += 1.0
    blurred = acc / wacc
    mu = s1 / cnt
    sigma_s = jnp.sqrt(jnp.maximum(s2 / cnt - mu * mu, 0.0))
    cold = 1.0 / (1.0 + n_acc)  # 1 on the first frame, ~0 once accumulated
    gate = jnp.clip(sigma_t / 0.1 + (sigma_s / 0.1) * cold, 0.0, 1.0)
    return mask + (blurred - mask) * gate


def resolve_temporal(
    filtered: jax.Array,    # (H, W, C) prefiltered current masks
    raw: jax.Array,         # (H, W, C) RAW stochastic masks (for moments)
    hist: jax.Array,        # (H, W, C) reprojected history
    mom_hist: jax.Array,    # (H, W, 2C+1) reprojected moments
    confidence: jax.Array,  # (H, W) reprojection confidence
    first_frame: jax.Array,  # () bool-ish
    max_samples: float = 24.0,
    gamma: float = 1.0,
):
    """Variance-clamped accumulation per plane; shared sample-count ramp.

    Returns (resolved, new_moments); resolved is clipped to [0, 1] (it is a
    visibility fraction, and the clamp box math can overshoot slightly).

    The moments track the RAW per-frame estimate, never the filtered one:
    filtered values inherit the prefilter's spatial mixing, so accumulating
    THEM makes sigma_t nonzero wherever blur once happened, which keeps the
    prefilter gate open, which keeps sigma_t nonzero — a feedback loop that
    froze a measured ~0.3 shadow-leak bias into stably lit pixels. Raw
    moments break the loop: a pixel whose estimator is constant reads
    sigma_t = 0 and passes through untouched from frame 2 on.
    """
    c = filtered.shape[-1]
    s1 = filtered
    s2 = filtered * filtered
    s_min = filtered
    s_max = filtered
    cnt = 1.0
    for dy, dx in [(-1, 0), (1, 0), (0, -1), (0, 1),
                   (-1, -1), (-1, 1), (1, -1), (1, 1)]:
        m = shift_img(filtered, dy, dx)
        s1 = s1 + m
        s2 = s2 + m * m
        s_min = jnp.minimum(s_min, m)
        s_max = jnp.maximum(s_max, m)
        cnt += 1.0
    mu = s1 / cnt
    sigma = jnp.sqrt(jnp.maximum(s2 / cnt - mu * mu, 0.0))
    m1_h = mom_hist[..., :c]
    m2_h = mom_hist[..., c:2 * c]
    sigma_t = jnp.sqrt(jnp.maximum(m2_h - m1_h * m1_h, 0.0))
    # Temporal sigma widens the box in penumbras so the history converges to
    # the MEAN visibility instead of re-clamping into each frame's jittered
    # box (which would never settle); a small absolute epsilon keeps umbra /
    # lit regions from locking out genuine light changes.
    eps = gamma * sigma + 1.5 * sigma_t + 0.02
    hist_clamped = jnp.clip(hist, s_min - eps, s_max + eps)

    conf = confidence[..., None]
    reset = jnp.maximum(
        1.0 - conf, jnp.asarray(first_frame != 0).astype(jnp.float32)
    )
    n_prev = mom_hist[..., 2 * c:2 * c + 1] * (1.0 - reset)
    n = jnp.minimum(n_prev + 1.0, max_samples)
    alpha = 1.0 / n
    resolved = hist_clamped + (filtered - hist_clamped) * alpha
    resolved = jnp.where(reset > 0.5, filtered, resolved)
    resolved = jnp.clip(resolved, 0.0, 1.0)

    m1 = m1_h * (1.0 - alpha) + raw * alpha
    m2 = m2_h * (1.0 - alpha) + raw * raw * alpha
    m1 = jnp.where(reset > 0.5, raw, m1)
    m2 = jnp.where(reset > 0.5, raw * raw, m2)
    new_moments = jnp.concatenate([m1, m2, n], axis=-1)
    return resolved, new_moments


def denoise(
    noisy: jax.Array,       # (H, W, C) this frame's stochastic masks
    depth: jax.Array,       # (H, W)
    normal: jax.Array,      # (H, W, 3)
    velocity: jax.Array,    # (H, W, 2)
    hist: jax.Array,        # (H, W, C) previous resolved masks
    mom_hist: jax.Array,    # (H, W, 2C+1)
    prev_depth: jax.Array,  # (H, W)
    px: jax.Array,          # (N,) pixel centers
    py: jax.Array,          # (N,) pixel centers (band-local)
    first_frame,
):
    """Full chain: reproject -> prefilter -> resolve. Returns
    (resolved (H, W, C), new_moments (H, W, 2C+1))."""
    hist_r, mom_r, conf = reproject(
        hist, mom_hist, prev_depth, depth, velocity, px, py
    )
    filtered = prefilter(noisy, normal, depth, mom_r)
    return resolve_temporal(filtered, noisy, hist_r, mom_r, conf, first_frame)
