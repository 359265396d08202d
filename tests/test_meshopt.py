"""Native meshlet builder + BC compression (and their NumPy fallbacks)."""

import numpy as np
import pytest

from arkoserenderer.assets import meshopt
from arkoserenderer.assets.procedural import make_uv_sphere


@pytest.fixture(scope="module")
def sphere():
    return make_uv_sphere(1.0, rings=16, sectors=32)


def _check_meshlets(m, tris, positions, max_verts, max_tris):
    t = len(tris)
    assert m.count >= 1
    # Ranges tile the triangle list exactly.
    assert m.tri_offset[0] == 0
    np.testing.assert_array_equal(
        m.tri_offset[1:], m.tri_offset[:-1] + m.tri_count[:-1]
    )
    assert m.tri_offset[-1] + m.tri_count[-1] == t
    # Budgets respected.
    assert m.tri_count.max() <= max_tris
    for i in range(m.count):
        seg = tris[m.tri_offset[i] : m.tri_offset[i] + m.tri_count[i]]
        assert len(np.unique(seg)) <= max_verts
        # Sphere contains all meshlet vertices.
        pts = positions[seg.reshape(-1)]
        d = np.linalg.norm(pts - m.sphere[i, :3], axis=-1)
        assert d.max() <= m.sphere[i, 3] + 1e-4


def test_meshlets_native_or_fallback(sphere):
    tris = sphere.indices.reshape(-1, 3)
    m = meshopt.build_meshlets(sphere.positions, tris, max_verts=64, max_tris=126)
    _check_meshlets(m, tris, sphere.positions, 64, 126)
    # A sphere's meshlets have meaningful normal cones (mostly < 1).
    assert (m.cone[:, 3] < 0.999).any()


def test_meshlets_numpy_fallback_matches(sphere, monkeypatch):
    tris = sphere.indices.reshape(-1, 3)
    native = meshopt.build_meshlets(sphere.positions, tris)
    monkeypatch.setattr(meshopt, "_lib", False)
    fallback = meshopt.build_meshlets(sphere.positions, tris)
    np.testing.assert_array_equal(native.tri_offset, fallback.tri_offset)
    np.testing.assert_array_equal(native.tri_count, fallback.tri_count)
    np.testing.assert_allclose(native.sphere, fallback.sphere, rtol=1e-4, atol=1e-4)


def test_bc4_roundtrip_quality(rng):
    img = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    blocks = meshopt.compress_bc4(img)
    back = meshopt.decompress_bc4(blocks, 32, 32)
    # Block compression is lossy; error bounded by block range / 7.
    assert np.abs(back.astype(int) - img.astype(int)).mean() < 24
    # Flat blocks are exact.
    flat = np.full((8, 8), 137, np.uint8)
    np.testing.assert_array_equal(
        meshopt.decompress_bc4(meshopt.compress_bc4(flat), 8, 8), flat
    )


def test_bc4_smooth_gradient_tight(rng):
    x = np.linspace(40, 80, 16).astype(np.uint8)
    img = np.tile(x[None, :], (16, 1))
    back = meshopt.decompress_bc4(meshopt.compress_bc4(img), 16, 16)
    assert np.abs(back.astype(int) - img.astype(int)).max() <= 4


def test_bc5_layout(rng):
    r = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    g = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    blocks = meshopt.compress_bc5(r, g)
    assert blocks.shape == (16, 16)  # 16 blocks, 16 bytes each
    rb = meshopt.decompress_bc4(blocks[:, :8], 16, 16)
    gb = meshopt.decompress_bc4(blocks[:, 8:], 16, 16)
    assert np.abs(rb.astype(int) - r.astype(int)).mean() < 24
    assert np.abs(gb.astype(int) - g.astype(int)).mean() < 24


def test_bc4_fallback_matches_native(rng, monkeypatch):
    img = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    native = meshopt.compress_bc4(img)
    monkeypatch.setattr(meshopt, "_lib", False)
    fallback = meshopt.compress_bc4(img)
    np.testing.assert_array_equal(native, fallback)
