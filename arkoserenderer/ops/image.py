"""Image-space helpers: bilinear resampling, pyramids, separable blurs.

Shared by the post chain (TAA reprojection, bloom pyramid, DoF, motion blur
— the counterparts of the reference's postprocess compute shaders). All
functions are pure jnp over (H, W, C) images and fuse under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def bilinear_sample(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Sample (H, W, C) at float pixel coords (x, y are (N,) pixel-center
    based: sampling at x=0.5 hits texel 0's center). Clamp addressing."""
    h, w = img.shape[0], img.shape[1]
    fx = x - 0.5
    fy = y - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0)[:, None]
    ty = (fy - y0)[:, None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    flat = img.reshape(-1, img.shape[-1])
    c00 = flat[y0i * w + x0i]
    c10 = flat[y0i * w + x1i]
    c01 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    return (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty


def downsample2x(img: jax.Array) -> jax.Array:
    """Exact 2x2 box downsample; H and W must be even.

    Strided reduce_window rather than reshape(h//2, 2, w//2, 2, c): no
    intermediate with tiny minor dims is materialized."""
    return jax.lax.reduce_window(
        img, 0.0, jax.lax.add, (2, 2, 1), (2, 2, 1), "VALID"
    ) * 0.25


def upsample2x(img: jax.Array, halo_rows=None) -> jax.Array:
    """2x nearest upsample followed by a 3x3 tent — cheap bilinear-ish.

    ``halo_rows``: optional (top, bottom) COARSE-level neighbor rows
    (band_halo_rows) for seam-exact upsampling under pixel-band sharding —
    after the 2x repeat, the row adjacent to the band edge is exactly the
    neighbor band's coarse boundary row."""
    up = jnp.repeat(jnp.repeat(img, 2, axis=0), 2, axis=1)
    if halo_rows is not None:
        halo_rows = (jnp.repeat(halo_rows[0], 2, axis=1),
                     jnp.repeat(halo_rows[1], 2, axis=1))
    return blur3(up, halo_rows=halo_rows)


def blur3(img: jax.Array, halo_rows=None) -> jax.Array:
    """3x3 binomial ([1,2,1]/4 separable) blur with edge clamp.

    Implemented with edge-pad + static slices (pure data movement that
    fuses with the arithmetic) — NOT index-array takes, which lower to
    gathers.

    ``halo_rows``: optional (top, bottom) neighbor-band rows (see
    band_halo_rows) replacing the row-axis edge clamp, making the stencil
    seam-exact under pixel-band sharding.
    """
    k = (0.25, 0.5, 0.25)

    def conv_axis(x, axis):
        if axis == 0 and halo_rows is not None:
            p = jnp.concatenate([halo_rows[0], x, halo_rows[1]], axis=0)
        else:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (1, 1)
            p = jnp.pad(x, pad, mode="edge")
        n = x.shape[axis]

        def sl(off):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(off, off + n)
            return p[tuple(idx)]

        return k[0] * sl(0) + k[1] * sl(1) + k[2] * sl(2)

    return conv_axis(conv_axis(img, 0), 1)


def neighborhood_min_max(img: jax.Array):
    """Per-pixel 3x3 min / max (for TAA neighborhood clamping).

    reduce_window is one fused pooling op; 'SAME' padding with +-inf init equals edge-clamp semantics exactly."""
    lo = jax.lax.reduce_window(
        img, jnp.inf, jax.lax.min, (3, 3, 1), (1, 1, 1), "SAME"
    )
    hi = jax.lax.reduce_window(
        img, -jnp.inf, jax.lax.max, (3, 3, 1), (1, 1, 1), "SAME"
    )
    return lo, hi


def sample_catmull_rom(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """9-tap Catmull-Rom resampling (the optimized bilinear-tap formulation
    used for sharper TAA history, cf. the reference's optional Catmull-Rom
    history in taa.comp)."""
    h, w = img.shape[0], img.shape[1]
    fx = x - 0.5
    fy = y - 0.5
    cx = jnp.floor(fx - 0.5) + 0.5  # center tap
    cy = jnp.floor(fy - 0.5) + 0.5
    tx = fx - cx
    ty = fy - cy

    def weights(t):
        t2 = t * t
        t3 = t2 * t
        w0 = -0.5 * t3 + t2 - 0.5 * t
        w1 = 1.5 * t3 - 2.5 * t2 + 1.0
        w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
        w3 = 0.5 * t3 - 0.5 * t2
        return w0, w1, w2, w3

    wx = weights(tx)
    wy = weights(ty)
    acc = 0.0
    for j, wyj in enumerate(wy):
        for i, wxi in enumerate(wx):
            xi = jnp.clip((cx + (i - 1)).astype(jnp.int32), 0, w - 1)
            yj = jnp.clip((cy + (j - 1)).astype(jnp.int32), 0, h - 1)
            acc = acc + img.reshape(-1, img.shape[-1])[yj * w + xi] * (wxi * wyj)[:, None]
    return acc


def band_halo_rows(img: jax.Array, axis_name: str, n_shards: int):
    """Neighbor bands' boundary rows for seam-exact banded stencils.

    Under pixel-band SPMD each device holds a horizontal band; stencils and
    upsamples near band edges need the adjacent device's rows. Returns
    (top, bottom) single rows fetched over the mesh axis with ppermute (ICI
    traffic: one row each way); the frame's outer edges fall back to edge
    clamp, exactly like the single-device path."""
    i = jax.lax.axis_index(axis_name)
    from_above = jax.lax.ppermute(
        img[-1:], axis_name, [(d, d + 1) for d in range(n_shards - 1)]
    )
    from_below = jax.lax.ppermute(
        img[:1], axis_name, [(d + 1, d) for d in range(n_shards - 1)]
    )
    top = jnp.where(i == 0, img[:1], from_above)
    bottom = jnp.where(i == n_shards - 1, img[-1:], from_below)
    return top, bottom


def upsample_bilinear_k(img: jax.Array, k: int, halo_rows=None) -> jax.Array:
    """(h, w, c) -> (h*k, w*k, c) separable bilinear upsample, edge clamp.

    Built from edge-pad + static slices + per-phase lerps (all elementwise —
    no gathers, unlike jax.image.resize which costs a full gather-class op
    on this chip). ``halo_rows`` = (top, bottom) rows from band_halo_rows for
    seam-exact upsampling of a sharded band."""
    if k == 1:
        return img

    def axis_up(x, axis):
        n = x.shape[axis]
        if axis == 0 and halo_rows is not None:
            p = jnp.concatenate([halo_rows[0], x, halo_rows[1]], axis=0)
        else:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (1, 1)
            p = jnp.pad(x, pad, mode="edge")

        def sl(off):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(off, off + n)
            return p[tuple(idx)]

        prev, cur, nxt = sl(0), sl(1), sl(2)
        phases = []
        for ph in range(k):
            f = (ph + 0.5) / k - 0.5
            if f < 0:
                phases.append(cur * (1.0 + f) + prev * (-f))
            else:
                phases.append(cur * (1.0 - f) + nxt * f)
        s = jnp.stack(phases, axis=axis + 1)
        shape = list(x.shape)
        shape[axis] = n * k
        return s.reshape(shape)

    return axis_up(axis_up(img, 0), 1)


def resize_bilinear_rational(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """(h, w, c) -> (out_h, out_w, c) bilinear resample for RATIONAL scale
    factors, gather-free.

    Output rows with the same phase p (j = p + k*t for out_n = in_n * k / m
    in lowest terms) map to input rows start_p + m*t — a strided static
    slice. Each phase is a lerp of two such slices; phases interleave with a
    stack+reshape. Everything is elementwise data movement: no gathers, no
    jax.image.resize (both are ~26 ms/op-class on this chip at 1080p)."""
    import math

    def axis_resize(x, out_n, axis):
        in_n = x.shape[axis]
        if out_n == in_n:
            return x
        g = math.gcd(out_n, in_n)
        k, m = out_n // g, in_n // g  # out_n = in_n * k / m
        assert k <= 16, (
            f"resize {in_n}->{out_n}: phase count {k} too large — pick "
            f"render/display dims with a small rational ratio"
        )
        pad = [(0, 0)] * x.ndim
        pad[axis] = (1, 1)
        p_arr = jnp.pad(x, pad, mode="edge")  # index i -> padded i+1

        def strided(start, step, count):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(start + 1, start + 1 + (count - 1) * step + 1, step)
            return p_arr[tuple(idx)]

        t_count = out_n // k
        phases = []
        for p in range(k):
            y = (p + 0.5) * m / k - 0.5
            y0 = math.floor(y)
            f = y - y0
            lo = strided(max(y0, -1), m, t_count)
            hi = strided(max(y0, -1) + 1, m, t_count)
            phases.append(lo * (1.0 - f) + hi * f)
        s = jnp.stack(phases, axis=axis + 1)  # (..., t_count, k, ...)
        shape = list(x.shape)
        shape[axis] = out_n
        return s.reshape(shape)

    return axis_resize(axis_resize(img, out_h, 0), out_w, 1)


def resize_bilinear_rational_jittered(
    img: jax.Array, out_h: int, out_w: int, jitter_x, jitter_y
) -> jax.Array:
    """Jitter-compensated rational upsample, gather-free (the TAA-U /
    temporal-super-resolution resample).

    Like resize_bilinear_rational, but the input was rendered with a
    sub-pixel camera jitter of (+jitter_x, +jitter_y) pixels (traced
    scalars, |j| <= 0.5 — mathx.apply_jitter convention: projected points
    MOVE by +j, so input sample k holds the scene at unjittered position
    k - j, and interpolating the scene at coordinate y means reading the
    array at y + j). Each output phase becomes FOUR static strided slices
    weighted by traced triangle weights (exactly two adjacent taps are
    nonzero); structure stays static, weights ride the jitter.
    """
    import math

    def axis_resize(x, out_n, axis, j):
        in_n = x.shape[axis]
        g = math.gcd(out_n, in_n)
        k, m = out_n // g, in_n // g  # out_n = in_n * k / m
        assert k <= 16, f"resize {in_n}->{out_n}: phase count {k} too large"
        pad = [(0, 0)] * x.ndim
        pad[axis] = (2, 2)
        p_arr = jnp.pad(x, pad, mode="edge")  # index i -> padded i+2

        def strided(start, step, count):
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(start + 2, start + 2 + (count - 1) * step + 1, step)
            return p_arr[tuple(idx)]

        t_count = out_n // k
        j = jnp.asarray(j, jnp.float32)
        phases = []
        for p in range(k):
            y0 = (p + 0.5) * m / k - 0.5
            base = math.floor(y0)
            yrel = (y0 - base) + j  # traced, in [-0.5, 1.5)
            acc = None
            for t in (-1, 0, 1, 2):
                wt = jnp.maximum(0.0, 1.0 - jnp.abs(yrel - t))
                sl = strided(base + t, m, t_count) * wt
                acc = sl if acc is None else acc + sl
            phases.append(acc)
        s = jnp.stack(phases, axis=axis + 1)  # (..., t_count, k, ...)
        shape = list(x.shape)
        shape[axis] = out_n
        return s.reshape(shape)

    out = axis_resize(img, out_h, 0, jitter_y)  # same-res still shifts by j
    out = axis_resize(out, out_w, 1, jitter_x)
    return out


def luminance(rgb: jax.Array) -> jax.Array:
    return jnp.sum(rgb * jnp.array([0.2126, 0.7152, 0.0722]), axis=-1, keepdims=True)


def bilinear_sample_small_offset(img: jax.Array, ox: jax.Array, oy: jax.Array) -> jax.Array:
    """Bilinear resample of (H, W, C) at per-pixel offsets (x + ox, y + oy)
    with |ox|, |oy| <= 1 — GATHER-FREE: nine weighted static shifts (pure
    elementwise data movement), each weighted by the separable triangle
    kernel evaluated at the per-pixel offset. The TAA/denoiser reprojection
    fast path: with a near-static camera the motion field is sub-pixel, so
    the history fetch needs no gather.

    ``ox``/``oy``: (H, W) pixel offsets (sample position relative to each
    pixel's own center). Edge-clamped like bilinear_sample.
    """
    from arkoserenderer.ops.postprocess import shift_img

    out = jnp.zeros_like(img)
    axo = ox[..., None]
    ayo = oy[..., None]
    for sy in (-1, 0, 1):
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(sy - ayo))
        for sx in (-1, 0, 1):
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(sx - axo))
            w = wx * wy
            out = out + shift_img(img, sy, sx) * w
    return out


def upsample_nearest_depth(half_img: jax.Array, half_depth: jax.Array,
                           full_depth: jax.Array) -> jax.Array:
    """(H/2, W/2, C) half-res values -> (H, W, C) guided by depth: each full
    pixel picks, from a 2x2 window of half-res cells, the one whose depth is
    closest to its own (nearest-depth upsampling — the standard half-res
    RT/AO reconstruction; avoids leaking values across silhouettes).
    All candidates come from static shifts + repeats: gather-free."""
    from arkoserenderer.ops.postprocess import shift_img

    def up(a):
        return jnp.repeat(jnp.repeat(a, 2, 0), 2, 1)

    cands = []
    depths = []
    for dy in (0, 1):
        for dx in (0, 1):
            cands.append(up(shift_img(half_img, dy, dx)))
            depths.append(up(shift_img(half_depth[..., None], dy, dx))[..., 0])
    best = cands[0]
    best_err = jnp.abs(depths[0] - full_depth)
    for c, d in zip(cands[1:], depths[1:]):
        err = jnp.abs(d - full_depth)
        take = err < best_err
        best = jnp.where(take[..., None], c, best)
        best_err = jnp.minimum(best_err, err)
    return best
