"""Anisotropic texture filtering (ops/mattex quality="anisoN").

The reference enables 16x sampler anisotropy everywhere
(backend/vulkan/VulkanSampler.cpp:66-67); the isotropic max-axis trilinear
path over-blurs grazing footprints. This pins the anisoN tap march against
a brute-force footprint integral.
"""

import numpy as np
import jax.numpy as jnp

from arkoserenderer.assets.procedural import checkerboard_texture
from arkoserenderer.ops import mattex
from arkoserenderer.scene.scene import Material


CHECKER_ID = 4  # ids 0-3 are the pool's reserved defaults


def _images():
    white = np.full((1, 1, 4), 255, np.uint8)
    checker = checkerboard_texture(64, 8)
    return [(white, False, 0)] * CHECKER_ID + [(checker, False, 0)]


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _bilinear(img, u, v):
    """Bilinear tap in LINEAR space (the packed sampler decodes base.rgb
    per texel before filtering — mattex._unpack12)."""
    h, w = img.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    def at(xi, yi):
        return _srgb_to_linear(img[yi % h, xi % w, :3].astype(np.float64) / 255.0)
    return (at(x0, y0) * (1 - fx) * (1 - fy) + at(x0 + 1, y0) * fx * (1 - fy)
            + at(x0, y0 + 1) * (1 - fx) * fy + at(x0 + 1, y0 + 1) * fx * fy)


def test_aniso_beats_trilinear_on_grazing_footprints():
    imgs = _images()
    rows, meta = mattex.build_packed_materials(
        [Material(base_color_tex=CHECKER_ID)], imgs)
    rows_d = jnp.asarray(rows)

    rng = np.random.default_rng(5)
    n = 48
    uv = rng.uniform(0.25, 0.75, (n, 2)).astype(np.float32)
    # Strongly anisotropic footprint: 16 texels along u, ~1.3 along v.
    duv_dx = np.tile(np.array([0.25, 0.0], np.float32), (n, 1))
    duv_dy = np.tile(np.array([0.0, 0.02], np.float32), (n, 1))
    meta_px = jnp.asarray(np.tile(meta[0], (n, 1)))

    def run(quality):
        ms = mattex.sample_packed(
            rows_d, meta_px, jnp.asarray(uv), jnp.asarray(duv_dx),
            jnp.asarray(duv_dy), quality=quality)
        return np.asarray(ms.base[:, :3], np.float64)

    tri = run("trilinear")
    a4 = run("aniso4")

    # Brute-force footprint integral of the mip-0 texture.
    checker = imgs[CHECKER_ID][0]
    truth = np.zeros((n, 3))
    ss, ts = np.linspace(-0.5, 0.5, 33), np.linspace(-0.5, 0.5, 9)
    for i in range(n):
        acc = np.zeros(3)
        for s in ss:
            for t in ts:
                u = uv[i, 0] + s * duv_dx[i, 0]
                v = uv[i, 1] + t * duv_dy[i, 1]
                acc += _bilinear(checker, u, v)
        truth[i] = acc / (len(ss) * len(ts))

    err_tri = np.abs(tri - truth).mean()
    err_a4 = np.abs(a4 - truth).mean()
    assert err_a4 < err_tri * 0.75, (err_a4, err_tri)
    assert err_a4 < 0.08, err_a4


def test_aniso_matches_trilinear_on_isotropic_footprints():
    """With square footprints the tap march must degenerate to ~trilinear."""
    imgs = _images()
    rows, meta = mattex.build_packed_materials(
        [Material(base_color_tex=CHECKER_ID)], imgs)
    rng = np.random.default_rng(6)
    n = 48
    uv = rng.uniform(0.2, 0.8, (n, 2)).astype(np.float32)
    d = np.tile(np.array([0.03, 0.0], np.float32), (n, 1))
    dy = np.tile(np.array([0.0, 0.03], np.float32), (n, 1))
    meta_px = jnp.asarray(np.tile(meta[0], (n, 1)))
    tri = np.asarray(mattex.sample_packed(
        jnp.asarray(rows), meta_px, jnp.asarray(uv), jnp.asarray(d),
        jnp.asarray(dy), quality="trilinear").base)
    a4 = np.asarray(mattex.sample_packed(
        jnp.asarray(rows), meta_px, jnp.asarray(uv), jnp.asarray(d),
        jnp.asarray(dy), quality="aniso4").base)
    assert np.abs(tri - a4).max() < 0.06, np.abs(tri - a4).max()
