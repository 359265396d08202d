"""Physically-based BRDF evaluation (Filament-style).

Role-equivalent to the reference's shared GLSL BRDF library
(arkose/shaders/common/brdf.glsl) which follows the publicly documented
Filament material model (https://google.github.io/filament/Filament.html):
GGX NDF, height-correlated Smith visibility, Schlick Fresnel, Lambert
diffuse, and a Kelemen-visibility clearcoat lobe. Implemented here as
batched jnp over (N, ...) pixel arrays — the whole screen is one SIMD wave.

All directions point *away* from the surface point and are unit length:
``l`` toward the light, ``v`` toward the camera, ``n`` the shading normal.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.core.mathx import normalize, vdot

DIELECTRIC_F0 = 0.04
MIN_ROUGHNESS = 0.045  # avoid infinite highlights (same motivation as Filament)


def d_ggx(n_dot_h, alpha):
    a2 = alpha * alpha
    f = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / (jnp.pi * f * f + 1e-20)


def v_smith_ggx_correlated(n_dot_v, n_dot_l, alpha):
    a2 = alpha * alpha
    lv = n_dot_l * jnp.sqrt((n_dot_v - n_dot_v * a2) * n_dot_v + a2)
    ll = n_dot_v * jnp.sqrt((n_dot_l - n_dot_l * a2) * n_dot_l + a2)
    return 0.5 / (lv + ll + 1e-20)


def f_schlick(u, f0, f90=1.0):
    return f0 + (f90 - f0) * (1.0 - u) ** 5


def v_kelemen(l_dot_h):
    return 0.25 / jnp.maximum(l_dot_h * l_dot_h, 1e-6)


def base_f0(base_color, metallic, reflectance=DIELECTRIC_F0):
    """Dielectrics get scalar reflectance, metals get tinted base color."""
    return reflectance * (1.0 - metallic) + base_color * metallic


def evaluate(
    l,
    v,
    n,
    base_color,
    roughness,
    metallic,
    clearcoat=None,
    clearcoat_roughness=None,
):
    """Full surface response f(l, v) * <n.l>, per pixel.

    Inputs are (N,3) directions / colors and (N,1) scalars. Returns (N,3)
    outgoing radiance per unit incoming illuminance (multiply by light
    color/intensity and shadow term).
    """
    h = normalize(l + v)
    n_dot_v = jnp.abs(vdot(n, v)) + 1e-5
    n_dot_l = jnp.clip(vdot(n, l), 0.0, 1.0)
    n_dot_h = jnp.clip(vdot(n, h), 0.0, 1.0)
    l_dot_h = jnp.clip(vdot(l, h), 0.0, 1.0)

    rough = jnp.maximum(roughness, MIN_ROUGHNESS)
    alpha = rough * rough  # perceptual -> linear roughness

    f0 = base_f0(base_color, metallic)
    f = f_schlick(l_dot_h, f0)
    d = d_ggx(n_dot_h, alpha)
    vis = v_smith_ggx_correlated(n_dot_v, n_dot_l, alpha)
    specular = d * vis * f

    diffuse_color = base_color * (1.0 - metallic)
    diffuse = diffuse_color / jnp.pi

    fr = diffuse + specular

    if clearcoat is not None:
        cc_rough = jnp.clip(clearcoat_roughness, 0.1, 1.0)
        cc_alpha = cc_rough * cc_rough
        dc = d_ggx(n_dot_h, cc_alpha)
        vc = v_kelemen(l_dot_h)
        fc = f_schlick(l_dot_h, DIELECTRIC_F0) * clearcoat
        # Base layer is attenuated by the clearcoat Fresnel (energy cons.).
        fr = fr * (1.0 - fc) + dc * vc * fc

    return fr * n_dot_l


def sample_ggx_vndf(v_ts, alpha, u1, u2):
    """Sample the GGX distribution of visible normals (Heitz 2018, JCGT 7(4)).

    ``v_ts``: (N,3) view direction in tangent space (+Z = normal). Returns
    (N,3) sampled half-vector in tangent space. Used by RT reflections
    (counterpart of the reference's sampleGGXVNDF in brdf.glsl, itself the
    published reference implementation of the paper).
    """
    a = alpha
    vh = normalize(jnp.stack([a * v_ts[:, 0], a * v_ts[:, 1], v_ts[:, 2]], axis=-1))
    lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
    inv = 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-20))
    t1 = jnp.where(
        (lensq > 1e-12)[:, None],
        jnp.stack([-vh[:, 1] * inv, vh[:, 0] * inv, jnp.zeros_like(inv)], axis=-1),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[:, 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[:, None] * t1 + p2[:, None] * t2 + p3[:, None] * vh
    ne = jnp.stack(
        [a * nh[:, 0], a * nh[:, 1], jnp.maximum(nh[:, 2], 0.0)], axis=-1
    )
    return normalize(ne)


def env_fresnel_roughness(n_dot_v, f0, roughness):
    """Fresnel with roughness-aware grazing response for ambient/IBL terms."""
    f90 = jnp.maximum(1.0 - roughness, f0)
    return f0 + (f90 - f0) * (1.0 - n_dot_v) ** 5
