"""Path tracer tests: convergence, GI behavior, and raster cross-check."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.models.pathtracer import PathTracer

W = H = 64


@pytest.fixture(scope="module")
def tracer():
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    return PathTracer(scene, cam, W, H, max_bounces=2)


def test_progressive_accumulation_converges(tracer):
    tracer.render_sample(2)
    a = np.array(tracer.radiance())
    tracer.render_sample(6)
    b = np.array(tracer.radiance())
    tracer.render_sample(8)
    c = np.array(tracer.radiance())
    assert np.isfinite(c).all()
    # Variance between successive estimates decreases with samples.
    d_ab = np.abs(b - a).mean()
    d_bc = np.abs(c - b).mean()
    assert d_bc < d_ab
    assert tracer.sample_count == 16


def test_image_is_lit_and_ldr_valid(tracer):
    ldr = np.array(tracer.ldr())
    assert ldr.shape == (H, W, 3)
    assert 0.05 < ldr.mean() < 0.95
    assert ldr.std() > 0.05


def test_reset_on_camera_move(tracer):
    tracer.render_sample(1)
    n0 = tracer.sample_count
    assert n0 > 0
    tracer.camera.position = tracer.camera.position + np.array([0.1, 0, 0], np.float32)
    tracer.render_sample(1)
    assert tracer.sample_count == 1  # accumulation restarted


def test_indirect_light_present():
    # Sky-only illumination (no sun): under the box between floor bounces,
    # pure direct sun would be black, but sky + bounce light is not.
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    scene.sun = None
    tr = PathTracer(scene, cam, W, H, max_bounces=2)
    tr.render_sample(8)
    img = np.array(tr.radiance())
    assert img.mean() > 1e-3  # sky lighting reaches surfaces


@pytest.mark.heavy
def test_matches_raster_rough_energy():
    # The raster pipeline's direct+ambient approximation and the path tracer
    # should agree on overall image brightness within ~3x (sanity check that
    # units/exposure are consistent across both pipelines).
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig

    scene, cam = build_test_scene(viewport=(W, H))
    cfg = PipelineConfig(
        width=W, height=H,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
        shadow_map_size=128,
    )
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    raster_img = np.array(r.render_frame())

    scene2, cam2 = build_test_scene(viewport=(W, H))
    tr = PathTracer(scene2, cam2, W, H, max_bounces=2)
    tr.render_sample(8)
    pt_img = np.array(tr.ldr())
    ratio = pt_img.mean() / raster_img.mean()
    # Round-2 tightening (was 3x in round 1): SH-2 env ambient + honest RT
    # energy brought the raster pipeline within ~10% of the path tracer;
    # residual gap is multi-bounce interreflection the raster path lacks.
    assert 0.7 < ratio < 1.4, f"brightness mismatch: {ratio}"
