"""The Triton stage-4 raster kernel (interpret mode) against the XLA
reference, and the per-platform choice between them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.ops import raster
from arkoserenderer.ops.raster_pallas import rasterize_tiles_pallas

W, H = 64, 64
CFG = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64, max_global_tris=32)
kernel = functools.partial(rasterize_tiles_pallas, interpret=True)


def random_scene(rng, n=60):
    centers = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(-10, -2, n)], -1
    )
    offs = rng.normal(size=(n, 3, 3)) * 0.8
    verts = (centers[:, None] + offs).astype(np.float32).reshape(-1, 3)
    idx = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    proj = mx.perspective_reverse_z(np.radians(70.0), W / H, 0.1, 100.0)
    clip = np.asarray(mx.transform_points_h(proj, jnp.asarray(verts)))
    return clip, idx


def setup_bins(rng, n=60, height=H, y_offset=0, cfg=CFG):
    clip, idx = random_scene(rng, n)
    setup = raster.setup_triangles(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(len(idx), bool), W, H,
        cull_backfaces=False,
    )
    return setup, raster.bin_triangles(setup, W, height, cfg, y_offset=y_offset)


def assert_same(got, ref):
    (vis, depth), (vis_ref, depth_ref) = got, ref
    np.testing.assert_allclose(np.asarray(depth), np.asarray(depth_ref), atol=1e-6)
    a, b = np.asarray(vis), np.asarray(vis_ref)
    np.testing.assert_array_equal(a == -1, b == -1)
    assert (a != b).mean() < 0.001  # ids may differ only at exact depth ties


def test_pallas_matches_xla_raster(rng):
    setup, bins = setup_bins(rng)
    assert_same(kernel(setup, bins, W, H, CFG),
                raster.rasterize_tiles_reference(setup, bins, W, H, CFG))


def test_pallas_includes_global_list(rng):
    # One huge floor triangle (goes to the global list) + small ones.
    clip, idx = random_scene(rng, 20)
    big = np.array(
        [[-50, -1, 50], [50, -1, 50], [0, -1, -50]], np.float32
    )
    proj = mx.perspective_reverse_z(np.radians(70.0), W / H, 0.1, 100.0)
    big_clip = np.asarray(mx.transform_points_h(proj, jnp.asarray(big)))
    clip = np.concatenate([clip, big_clip])
    idx = np.concatenate([idx, [[len(clip) - 3, len(clip) - 2, len(clip) - 1]]]).astype(np.int32)
    cfg = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64,
                       max_tiles_per_tri=4, max_global_tris=32)
    setup = raster.setup_triangles(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(len(idx), bool), W, H,
        cull_backfaces=False, w_eps=0.1,
    )
    bins = raster.bin_triangles(setup, W, H, cfg)
    assert int(bins.global_count) >= 1
    assert_same(kernel(setup, bins, W, H, cfg),
                raster.rasterize_tiles_reference(setup, bins, W, H, cfg))


def test_kernel_depth_only_matches_reference(rng):
    setup, bins = setup_bins(rng)
    vis, depth = kernel(setup, bins, W, H, CFG, depth_only=True)
    _, depth_ref = raster.rasterize_tiles_reference(
        setup, bins, W, H, CFG, depth_only=True)
    assert (np.asarray(vis) == -1).all()
    np.testing.assert_array_equal(np.asarray(depth), np.asarray(depth_ref))


def test_kernel_depth_limit_matches_reference(rng):
    """Depth peeling: each layer keeps the nearest fragment behind the
    previous layer's depth."""
    setup, bins = setup_bins(rng)
    _, first = raster.rasterize_tiles_reference(setup, bins, W, H, CFG)
    got = kernel(setup, bins, W, H, CFG, depth_limit=first)
    ref = raster.rasterize_tiles_reference(setup, bins, W, H, CFG,
                                           depth_limit=first)
    assert_same(got, ref)
    second = np.asarray(ref[1])
    covered = second > 0
    assert covered.any()
    assert (second[covered] < np.asarray(first)[covered]).all()


@pytest.mark.parametrize("band", [0, 1, 3])
def test_kernel_y_offset_band_matches_reference(rng, band):
    """A 16-row band at a traced row offset (the pixel-band sharding)."""
    y0 = 16 * band
    setup, bins = setup_bins(rng, height=16, y_offset=y0)
    got = jax.jit(lambda s, b, y: kernel(s, b, W, 16, CFG, y_offset=y))(
        setup, bins, jnp.int32(y0))
    assert_same(got, raster.rasterize_tiles_reference(setup, bins, W, 16, CFG,
                                                      y_offset=y0))


def test_kernel_rejects_tiles_that_are_not_a_power_of_two(rng):
    cfg = RasterConfig(tile_h=8, tile_w=24, max_tris_per_tile=64)
    setup, _ = setup_bins(rng)
    bins = raster.bin_triangles(setup, 48, H, cfg)
    with pytest.raises(ValueError, match="power of two"):
        kernel(setup, bins, 48, H, cfg)


def _traced_dispatch(rng):
    setup, bins = setup_bins(rng, n=8)
    return jax.jit(lambda s, b: raster.rasterize_tiles(s, b, W, H, CFG)).trace(
        setup, bins)


def test_dispatch_runs_reference_on_cpu(rng):
    setup, bins = setup_bins(rng)
    got = jax.jit(lambda s, b: raster.rasterize_tiles(s, b, W, H, CFG))(setup, bins)
    ref = raster.rasterize_tiles_reference(setup, bins, W, H, CFG)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    text = _traced_dispatch(rng).lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" not in text


def test_dispatch_lowers_the_triton_kernel_for_cuda(rng):
    text = _traced_dispatch(rng).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "raster_tiles" in text


@pytest.mark.parametrize("platforms", [("rocm",), ("cpu", "rocm")])
def test_dispatch_refuses_other_platforms(rng, platforms):
    with pytest.raises(NotImplementedError, match="platform_index"):
        _traced_dispatch(rng).lower(lowering_platforms=platforms)


def test_pipeline_with_pallas_raster(monkeypatch):
    """A whole frame with the kernel (interpret mode) in place of the
    reference raster matches the reference frame."""
    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig

    cfg = PipelineConfig(
        width=96, height=96,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256,
                            max_global_tris=64),
        shadow_map_size=128,
    )
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    img_xla = np.array(Renderer(scene, cam, cfg, taa=False, bloom=False)
                       .render_frame())

    monkeypatch.setattr(raster, "rasterize_tiles", kernel)
    scene2, cam2 = build_test_scene(viewport=(96, 96), n_spheres=1)
    img_pallas = np.array(Renderer(scene2, cam2, cfg, taa=False, bloom=False)
                          .render_frame())
    np.testing.assert_allclose(img_pallas, img_xla, atol=1e-5)
