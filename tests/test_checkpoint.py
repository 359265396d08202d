"""Checkpoint/resume + frame-retry recovery (SURVEY §6.3/6.4 analogues)."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def test_checkpoint_resume_continues_taa_history(tmp_path):
    """Save after 3 frames, restore into a FRESH renderer: frame 4 must be
    identical to rendering frame 4 without the interruption."""
    path = str(tmp_path / "ckpt.npz")

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=True, bloom=False)
    for _ in range(3):
        r.render_frame()
    r.save_checkpoint(path)
    expected = np.array(r.render_frame())  # frame 4, uninterrupted

    scene2, cam2 = build_test_scene(viewport=(96, 96), n_spheres=1)
    r2 = Renderer(scene2, cam2, CFG, taa=True, bloom=False)
    r2.load_checkpoint(path)
    assert r2.frame_index == 3
    resumed = np.array(r2.render_frame())  # frame 4, resumed
    np.testing.assert_allclose(resumed, expected, atol=1e-5)


@pytest.mark.heavy  # multi-frame convergence: nightly lane
def test_pathtracer_checkpoint_resume_bitexact(tmp_path):
    from arkoserenderer.models.pathtracer import PathTracer

    path = str(tmp_path / "pt.npz")
    scene, cam = build_test_scene(viewport=(64, 64), n_spheres=1)
    t = PathTracer(scene, cam, 64, 64, max_bounces=2, seed=3)
    t.render_sample(8)
    straight = np.array(t.radiance())

    scene2, cam2 = build_test_scene(viewport=(64, 64), n_spheres=1)
    t2 = PathTracer(scene2, cam2, 64, 64, max_bounces=2, seed=3)
    t2.render_sample(4)
    t2.save_checkpoint(path)

    scene3, cam3 = build_test_scene(viewport=(64, 64), n_spheres=1)
    t3 = PathTracer(scene3, cam3, 64, 64, max_bounces=2, seed=3)
    t3.load_checkpoint(path)
    assert t3.sample_count == 4
    t3.render_sample(4)
    np.testing.assert_allclose(np.array(t3.radiance()), straight, atol=1e-6)


def test_render_frame_safe_recovers_from_one_failure():
    """First attempt raises (injected); the retry reconstructs the pipeline,
    restores persistent state, and produces the frame."""
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=True, bloom=False)
    r.render_frame()
    hist_before = np.array(r.state["TAAHistory"])

    calls = {"n": 0}
    orig = r.pipeline.render_frame

    def flaky(*a, **kw):
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected device loss")
        return orig(*a, **kw)

    r.pipeline.render_frame = flaky
    out = np.array(r.render_frame_safe())
    assert np.isfinite(out).all() and out.max() > 0
    # Persistent history survived the reconstruct (not re-cleared).
    assert np.abs(np.array(r.state["TAAHistory"]) - hist_before).max() > 0  # advanced
    assert calls["n"] == 1


def test_render_frame_safe_gives_up_after_retries():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)

    def always_fail(*a, **kw):
        raise RuntimeError("permanent failure")

    r.pipeline.render_frame = always_fail
    with pytest.raises(RuntimeError, match="permanent failure"):
        r.render_frame_safe(retries=1)
