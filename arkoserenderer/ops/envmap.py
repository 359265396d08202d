"""Equirectangular environment map sampling.

Role-equivalent to the reference's sky-view/environment sampling
(arkose/rendering/nodes/SkyViewNode.cpp + shaders/sky-view): direction ->
equirect UV -> bilinear fetch from an HBM-resident (H, W, 3) radiance map.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def direction_to_equirect_uv(d: jax.Array) -> jax.Array:
    """(N,3) unit directions -> (N,2) uv; v=0 at +Y (up), u wraps at -Z."""
    u = jnp.arctan2(d[:, 0], -d[:, 2]) / (2.0 * jnp.pi) + 0.5
    v = jnp.arccos(jnp.clip(d[:, 1], -1.0, 1.0)) / jnp.pi
    return jnp.stack([u, v], axis=-1)


def sample_equirect(env: jax.Array, d: jax.Array) -> jax.Array:
    """Bilinear sample of an equirect (H, W, 3) map along (N, 3) directions.
    U wraps, V clamps."""
    h, w = env.shape[0], env.shape[1]
    uv = direction_to_equirect_uv(d)
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0.astype(jnp.int32) + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, h - 1)
    flat = env.reshape(-1, env.shape[-1])
    c00 = flat[y0i * w + x0i]
    c10 = flat[y0i * w + x1i]
    c01 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def average_radiance(env: jax.Array) -> jax.Array:
    """Solid-angle-weighted mean radiance (cheap flat-ambient estimate)."""
    h = env.shape[0]
    theta = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * jnp.pi
    weights = jnp.sin(theta)[:, None, None]
    return jnp.sum(env * weights, axis=(0, 1)) / (jnp.sum(weights) * env.shape[1])


# -- SH-2 irradiance (the reference ships an SH library in common/ and uses
# -- probe irradiance for GI; this is the env-map equivalent for the no-DDGI
# -- ambient path: Ramamoorthi-Hanrahan "An Efficient Representation for
# -- Irradiance Environment Maps" evaluated per-normal) -----------------------


def sh2_project(env: jax.Array) -> jax.Array:
    """(H, W, 3) equirect radiance -> (9, 3) SH-2 IRRADIANCE coefficients.

    The convolution factors A_l (pi, 2pi/3, pi/4) are folded in, so
    ``sh2_irradiance(coeffs, n)`` returns irradiance directly. A one-time
    2048x9 reduction — negligible next to any frame work, so it can live
    inside jit without a precompute step.
    """
    h, w = env.shape[0], env.shape[1]
    theta = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h * jnp.pi
    phi = ((jnp.arange(w, dtype=jnp.float32) + 0.5) / w - 0.5) * 2.0 * jnp.pi
    st = jnp.sin(theta)[:, None]
    ct = jnp.cos(theta)[:, None]
    # Match direction_to_equirect_uv: v=0 at +Y, u wraps at -Z, x=sin*sin(phi)
    x = st * jnp.sin(phi)[None, :]
    y = ct * jnp.ones_like(phi)[None, :]
    z = -st * jnp.cos(phi)[None, :]
    d_omega = jnp.broadcast_to(st, (h, w)) * ((jnp.pi / h) * (2.0 * jnp.pi / w))

    c0 = 0.282095
    c1 = 0.488603
    c2 = 1.092548
    c3 = 0.315392
    c4 = 0.546274
    basis = jnp.stack([
        jnp.full_like(x, c0),
        c1 * y, c1 * z, c1 * x,
        c2 * x * y, c2 * y * z,
        c3 * (3.0 * z * z - 1.0),
        c2 * x * z, c4 * (x * x - y * y),
    ])                                                   # (9, H, W)
    coeffs = jnp.einsum("bhw,hwc->bc", basis * d_omega[None], env)
    a = jnp.array([jnp.pi, 2.0 * jnp.pi / 3.0, 2.0 * jnp.pi / 3.0,
                   2.0 * jnp.pi / 3.0, jnp.pi / 4.0, jnp.pi / 4.0,
                   jnp.pi / 4.0, jnp.pi / 4.0, jnp.pi / 4.0])
    return coeffs * a[:, None]


def sh2_irradiance(coeffs: jax.Array, n: jax.Array) -> jax.Array:
    """(9, 3) folded coeffs + (N, 3) unit normals -> (N, 3) irradiance."""
    x, y, z = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    c0 = 0.282095
    c1 = 0.488603
    c2 = 1.092548
    c3 = 0.315392
    c4 = 0.546274
    bs = [
        jnp.full_like(x, c0),
        c1 * y, c1 * z, c1 * x,
        c2 * x * y, c2 * y * z,
        c3 * (3.0 * z * z - 1.0),
        c2 * x * z, c4 * (x * x - y * y),
    ]                                                    # 9 x (N, 1)
    # Elementwise accumulation (fuses; a per-pixel dot would not).
    out = bs[0] * coeffs[0][None, :]
    for i in range(1, 9):
        out = out + bs[i] * coeffs[i][None, :]
    return jnp.maximum(out, 0.0)


def ambient_of_normal(env: jax.Array, n: jax.Array, brightness=1.0) -> jax.Array:
    """(N, 3) diffuse 'ambient' (irradiance / pi) per normal — the quantity
    LightingCompose multiplies by diffuse albedo (lightingCompose.comp's
    DDGI term, with the env map standing in for probes)."""
    return sh2_irradiance(sh2_project(env), n) * (brightness / jnp.pi)
