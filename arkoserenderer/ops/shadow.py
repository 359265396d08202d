"""Shadow-map projection + PCF filtering.

Role-equivalent to the reference's screen-space shadow projection compute
(arkose/rendering/shadow/DirectionalShadowProjectNode.cpp +
shaders/shadow/projectShadow.comp): given a light-space depth map rendered by
the depth-only raster path, produce a per-pixel [0,1] shadow mask with
disc-offset PCF. Uses reverse-Z depth consistently with ops/raster.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core.halton import fibonacci_disc
from arkoserenderer.core.mathx import transform_point_lanes


def project_to_shadow_uv(shadow_vp: jax.Array, world_pos: jax.Array):
    """(4,4) light view-proj + (N,3) world pos -> uv (N,2) in [0,1], depth (N,).

    Elementwise transform (no per-pixel dot — see transform_point_lanes)."""
    cx, cy, cz, w = transform_point_lanes(shadow_vp, world_pos)
    inv_w = jnp.where(jnp.abs(w) > 1e-12, 1.0 / jnp.where(w == 0, 1.0, w), 0.0)
    uv = jnp.stack(
        [cx * inv_w * 0.5 + 0.5, 0.5 - cy * inv_w * 0.5], axis=-1
    )
    return uv, cz * inv_w


def _fetch_shadow_depth(shadow_map: jax.Array, uv: jax.Array):
    """Nearest fetch with clamp; shadow_map is (S, S) reverse-Z depth."""
    s = shadow_map.shape[0]
    x = jnp.clip((uv[:, 0] * s).astype(jnp.int32), 0, s - 1)
    y = jnp.clip((uv[:, 1] * s).astype(jnp.int32), 0, s - 1)
    return shadow_map.reshape(-1)[y * s + x]


def sample_shadow_pcf(
    shadow_map: jax.Array,
    shadow_vp: jax.Array,
    world_pos: jax.Array,
    n_dot_l: jax.Array,
    constant_bias: float = 1.5e-3,
    slope_bias: float = 3.5e-3,
    radius_texels: float = 1.5,
    num_taps: int = 8,
) -> jax.Array:
    """(N,) shadow visibility in [0,1]; 1 = fully lit.

    Reverse-Z comparison: the receiver is lit when its light-space depth is
    >= the stored (closest-to-light = largest) depth minus bias. Slope bias
    scales with tan(acos(n.l)) like the reference's slope-scaled bias.
    """
    s = shadow_map.shape[0]
    uv, depth = project_to_shadow_uv(shadow_vp, world_pos)
    slope = jnp.sqrt(jnp.maximum(1.0 - n_dot_l**2, 0.0)) / jnp.maximum(n_dot_l, 0.1)
    bias = constant_bias + slope_bias * jnp.clip(slope, 0.0, 3.0)

    taps = jnp.asarray(fibonacci_disc(num_taps) * (radius_texels / s))
    inside = (
        (uv[:, 0] > 0.0) & (uv[:, 0] < 1.0) & (uv[:, 1] > 0.0) & (uv[:, 1] < 1.0)
    )

    def one_tap(i, acc):
        tap_uv = uv + taps[i]
        occ = _fetch_shadow_depth(shadow_map, tap_uv)
        lit = (depth + bias >= occ).astype(jnp.float32)
        return acc + lit

    lit = jax.lax.fori_loop(0, num_taps, one_tap, jnp.zeros(uv.shape[0])) / num_taps
    # Outside the shadow frustum: fully lit (sun covers the whole scene bounds).
    return jnp.where(inside, lit, 1.0)


# ---------------------------------------------------------------------------
# Variance shadow maps (the fast path)
#
# PCF taps are per-pixel random gathers, and 8 taps in a loop serialize.
# VSM moves the filtering to the shadow map itself (prefiltering with
# reduce_window, one pooling op) so the receiver needs ONE bilinear tap (4
# parallel row gathers) for smooth shadows. Role-equivalent to projectShadow.comp's PCF
# disc (arkose/shaders/shadow/projectShadow.comp) with equal-or-softer
# quality.


def shadow_moments(
    depth_map: jax.Array, blur_passes: int = 2, downsample: int = 2
) -> jax.Array:
    """(S, S) reverse-Z depth -> (S/k, S/k, 2) prefiltered (E[d], E[d^2]).

    Each blur pass is a 3x3 box via reduce_window; two passes approximate a
    5x5 tent like the reference's PCF disc radius. ``downsample``: averaging
    MOMENTS over 2x2 blocks is exact VSM prefiltering, and the receiver's
    gather table shrinks 4x at no quality cost beyond the (intended) extra
    softening."""
    k = downsample
    if k > 1 and depth_map.shape[0] % k == 0 and depth_map.shape[1] % k == 0:
        # kxk block mean on 2-D planes via strided reduce_window, not a
        # reshape to (h, k, w, k, 2) with tiny minor dims.
        def _down(x):
            return jax.lax.reduce_window(
                x, 0.0, jax.lax.add, (k, k), (k, k), "VALID"
            ) * (1.0 / (k * k))

        m = jnp.stack([_down(depth_map), _down(depth_map * depth_map)], axis=-1)
    else:
        m = jnp.stack([depth_map, depth_map * depth_map], axis=-1)
    for _ in range(blur_passes):
        m = jax.lax.reduce_window(
            m, 0.0, jax.lax.add, (3, 3, 1), (1, 1, 1), "SAME"
        ) * (1.0 / 9.0)
    return m


def sample_vsm(
    moments: jax.Array,     # (S, S, 2)
    shadow_vp: jax.Array,
    world_pos: jax.Array,   # (N, 3)
    n_dot_l: jax.Array,
    constant_bias: float = 1.5e-3,
    slope_bias: float = 2.0e-3,
    min_variance: float = 1e-6,
    bleed_reduction: float = 0.25,
    taps: str = "bilinear",          # | "stochastic" (1 jittered tap + TAA)
    noise2: jax.Array | None = None,  # (N, 2) in [0,1) for stochastic taps
) -> jax.Array:
    """(N,) shadow visibility via Chebyshev upper bound (reverse-Z).

    One bilinear moment tap (4 row gathers, all parallel) — or a single
    stochastically-jittered nearest tap whose expectation equals bilinear
    (TAA converges the variance; the moments are prefiltered so the noise
    amplitude is small). Light-bleed is clipped by rescaling the tail
    probability (standard VSM bleed fix)."""
    s = moments.shape[0]
    uv, depth = project_to_shadow_uv(shadow_vp, world_pos)
    slope = jnp.sqrt(jnp.maximum(1.0 - n_dot_l**2, 0.0)) / jnp.maximum(n_dot_l, 0.1)
    bias = constant_bias + slope_bias * jnp.clip(slope, 0.0, 3.0)
    d = depth + bias

    x = jnp.clip(uv[:, 0] * s - 0.5, 0.0, s - 1.0)
    y = jnp.clip(uv[:, 1] * s - 0.5, 0.0, s - 1.0)
    flat = moments.reshape(-1, 2)
    if taps == "stochastic" and noise2 is not None:
        # round(x + u - 0.5), u~U[0,1) has E = bilinear weighting per axis.
        xi = jnp.clip(jnp.round(x + noise2[:, 0] - 0.5), 0.0, s - 1.0).astype(jnp.int32)
        yi = jnp.clip(jnp.round(y + noise2[:, 1] - 0.5), 0.0, s - 1.0).astype(jnp.int32)
        m = flat[yi * s + xi]
    else:
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        x1i = jnp.minimum(x0i + 1, s - 1)
        y1i = jnp.minimum(y0i + 1, s - 1)
        m00 = flat[y0i * s + x0i]
        m10 = flat[y0i * s + x1i]
        m01 = flat[y1i * s + x0i]
        m11 = flat[y1i * s + x1i]
        m = (m00 * (1 - fx) + m10 * fx) * (1 - fy) + (m01 * (1 - fx) + m11 * fx) * fy

    mean = m[:, 0]
    var = jnp.maximum(m[:, 1] - mean * mean, min_variance)
    # Reverse-Z: receiver lit when its depth >= occluder mean.
    diff = mean - d
    p = var / (var + diff * diff)
    p = jnp.clip((p - bleed_reduction) / (1.0 - bleed_reduction), 0.0, 1.0)
    lit = jnp.where(d >= mean, 1.0, p)

    inside = (
        (uv[:, 0] > 0.0) & (uv[:, 0] < 1.0) & (uv[:, 1] > 0.0) & (uv[:, 1] < 1.0)
    )
    return jnp.where(inside, lit, 1.0)
