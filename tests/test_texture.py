import jax.numpy as jnp
import numpy as np

from arkoserenderer.ops import texture as tx


def make_pool(imgs, srgb=False, wrap=tx.WRAP_REPEAT, mipmapped=True):
    b = tx.TexturePoolBuilder(max_textures=16, pool_capacity=1 << 20)
    ids = [b.add(i, srgb=srgb, wrap=wrap, mipmapped=mipmapped) for i in imgs]
    return b.finalize(), ids


def test_pack_unpack_roundtrip(rng):
    img = rng.integers(0, 256, size=(4, 4, 4), dtype=np.uint8)
    packed = tx.pack_rgba8(img)
    un = np.asarray(tx.unpack_rgba8(jnp.asarray(packed)))
    np.testing.assert_allclose(un.reshape(4, 4, 4), img / 255.0, atol=1e-6)


def test_mip_chain_sizes():
    img = np.zeros((8, 16, 4), np.uint8)
    mips = tx.generate_mip_chain(img)
    assert [(m.shape[0], m.shape[1]) for m in mips] == [
        (8, 16), (4, 8), (2, 4), (1, 2), (1, 1),
    ]


def test_mip_chain_srgb_aware():
    # A 0/255 sRGB checkerboard averages to linear 0.5, which re-encodes to
    # ~188 — the naive gamma-space average (128) darkens mips by ~24%.
    img = np.zeros((2, 2, 4), np.uint8)
    img[..., 3] = 255
    img[0, 0, :3] = img[1, 1, :3] = 255
    srgb_mips = tx.generate_mip_chain(img, srgb=True)
    raw_mips = tx.generate_mip_chain(img, srgb=False)
    assert abs(int(srgb_mips[1][0, 0, 0]) - 188) <= 1
    assert abs(int(raw_mips[1][0, 0, 0]) - 128) <= 1
    # Alpha stays linear in both modes.
    assert srgb_mips[1][0, 0, 3] == 255


def test_nearest_texel_at_center(rng):
    img = rng.integers(0, 256, size=(8, 8, 4), dtype=np.uint8)
    pool, (tid,) = make_pool([img])
    # Sample exactly at texel centers: bilinear == the texel.
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    uv = np.stack([(xs.ravel() + 0.5) / 8, (ys.ravel() + 0.5) / 8], -1).astype(np.float32)
    ids = jnp.full((64,), tid, jnp.int32)
    out = np.asarray(tx.sample_trilinear(pool, ids, jnp.asarray(uv), decode_srgb=False))
    np.testing.assert_allclose(out, img.reshape(-1, 4) / 255.0, atol=1e-5)


def test_bilinear_midpoint():
    img = np.zeros((1, 2, 4), np.uint8)
    img[0, 0] = [0, 0, 0, 255]
    img[0, 1] = [200, 100, 50, 255]
    pool, (tid,) = make_pool([img], mipmapped=False)
    uv = jnp.array([[0.5, 0.5]], jnp.float32)  # midway between the two texels
    out = np.asarray(tx.sample_trilinear(pool, jnp.array([tid]), uv, decode_srgb=False))
    np.testing.assert_allclose(out[0, :3], np.array([100, 50, 25]) / 255.0, atol=1e-5)


def test_wrap_vs_clamp():
    img = np.zeros((1, 4, 4), np.uint8)
    img[0, 0] = [255, 0, 0, 255]
    img[0, 3] = [0, 255, 0, 255]
    pool_r, (tid_r,) = make_pool([img], wrap=tx.WRAP_REPEAT, mipmapped=False)
    pool_c, (tid_c,) = make_pool([img], wrap=tx.WRAP_CLAMP, mipmapped=False)
    uv = jnp.array([[1.0 + 0.125, 0.5]], jnp.float32)  # first texel center, next tile
    out_r = np.asarray(tx.sample_trilinear(pool_r, jnp.array([tid_r]), uv, decode_srgb=False))
    out_c = np.asarray(tx.sample_trilinear(pool_c, jnp.array([tid_c]), uv, decode_srgb=False))
    np.testing.assert_allclose(out_r[0, :3], [1, 0, 0], atol=1e-5)  # wrapped to texel 0
    np.testing.assert_allclose(out_c[0, :3], [0, 1, 0], atol=1e-5)  # clamped to texel 3


def test_lod_selects_coarse_mip(rng):
    # Checkerboard averages to mid-gray in coarse mips.
    img = np.zeros((64, 64, 4), np.uint8)
    img[::2, ::2] = 255
    img[1::2, 1::2] = 255
    img[..., 3] = 255
    pool, (tid,) = make_pool([img])
    uv = jnp.array([[32.5 / 64, 32.5 / 64]], jnp.float32)  # texel (32,32) center
    ids = jnp.array([tid])
    fine = np.asarray(tx.sample_trilinear(pool, ids, uv, jnp.array([0.0]), decode_srgb=False))
    coarse = np.asarray(tx.sample_trilinear(pool, ids, uv, jnp.array([6.0]), decode_srgb=False))
    assert abs(coarse[0, 0] - 0.5) < 0.02
    assert abs(fine[0, 0] - 0.5) > 0.2  # fine mip has contrast at that point
    # Gradient-based LOD: one full texture per pixel -> coarsest mip.
    lod = np.asarray(tx.compute_lod(pool, ids, jnp.array([[1.0, 0.0]]), jnp.array([[0.0, 1.0]])))
    assert lod[0] > 5.5


def test_srgb_decode_monotonic():
    c = jnp.linspace(0.0, 1.0, 32)
    lin = np.asarray(tx.srgb_to_linear(c))
    assert np.all(np.diff(lin) > 0)
    np.testing.assert_allclose(np.asarray(tx.linear_to_srgb(jnp.asarray(lin))), np.asarray(c), atol=1e-5)
    # spot values
    np.testing.assert_allclose(np.asarray(tx.srgb_to_linear(jnp.array([0.5]))), [0.21404114], atol=1e-6)


def test_default_textures_exist():
    b = tx.TexturePoolBuilder(max_textures=8, pool_capacity=4096)
    pool = b.finalize()
    ids = jnp.arange(4)
    uv = jnp.full((4, 2), 0.5)
    out = np.asarray(tx.sample_trilinear(pool, ids, uv, decode_srgb=False))
    np.testing.assert_allclose(out[0], [1, 1, 1, 1], atol=1e-3)         # white
    np.testing.assert_allclose(out[1], [0, 0, 0, 1], atol=1e-3)         # black
    np.testing.assert_allclose(out[2][:3], [0.502, 0.502, 1.0], atol=1e-2)  # flat normal


def test_bilinear_quality_close_to_trilinear(rng):
    """texture_quality="bilinear" (nearest-mip, 4 taps) must stay close to
    trilinear — it only drops the cross-mip lerp, so error is bounded by the
    difference between adjacent mips."""
    b = tx.TexturePoolBuilder(max_textures=8, pool_capacity=65536)
    img = (rng.random((64, 64, 4)) * 255).astype(np.uint8)
    tid = b.add(img, srgb=False)
    pool = b.finalize()
    n = 256
    uv = jnp.asarray(rng.random((n, 2)), jnp.float32)
    # Mid-chain LOD: worst case for nearest-mip popping.
    duv = jnp.full((n, 2), 4.0 / 64.0, jnp.float32)  # ~LOD 2
    tri = tx.sample_grad(pool, jnp.full((n,), tid, jnp.int32), uv, duv, duv * 0)
    bil = tx.sample_grad(
        pool, jnp.full((n,), tid, jnp.int32), uv, duv, duv * 0, quality="bilinear"
    )
    assert jnp.max(jnp.abs(tri - bil)) < 0.35
    assert jnp.mean(jnp.abs(tri - bil)) < 0.08


def test_pow2_mask_addressing_matches_mod(rng):
    """With pow2=True the REPEAT wrap uses a bitmask — must be bit-identical
    to the jnp.mod path for power-of-two textures, incl. negative coords."""
    b = tx.TexturePoolBuilder(max_textures=8, pool_capacity=1 << 18)
    tid = b.add((rng.random((128, 64, 4)) * 255).astype(np.uint8), srgb=False)
    cid = b.add((rng.random((32, 32, 4)) * 255).astype(np.uint8), srgb=False,
                wrap=tx.WRAP_CLAMP)
    pool = b.finalize()
    assert b.all_pow2
    n = 1024
    uv = jnp.asarray((rng.random((n, 2)).astype(np.float32) - 0.5) * 6.0)
    for t in (tid, cid):
        ids = jnp.full((n,), t, jnp.int32)
        lod = jnp.asarray(rng.random(n).astype(np.float32) * 4.0)
        ref = tx.sample_trilinear(pool, ids, uv, lod, decode_srgb=False)
        got = tx.sample_trilinear(pool, ids, uv, lod, decode_srgb=False, pow2=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_non_pow2_detected(rng):
    b = tx.TexturePoolBuilder(max_textures=8, pool_capacity=1 << 18)
    b.add((rng.random((48, 64, 4)) * 255).astype(np.uint8), srgb=False,
          mipmapped=False)
    assert not b.all_pow2
