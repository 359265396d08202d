"""Baked asset roundtrip: bake a glTF, reload, render identically."""

from pathlib import Path

import numpy as np
import pytest

from arkoserenderer.assets.baked import AssetCache, load_baked, save_baked
from arkoserenderer.assets.procedural import build_test_scene

SAMPLES = Path("/root/reference/assets/assets/sample/models")


def test_procedural_scene_roundtrip(tmp_path):
    scene, cam = build_test_scene(viewport=(96, 96))
    path = tmp_path / "test.arkscene.npz"
    save_baked(scene, path)
    loaded = load_baked(path, limits=scene.limits)
    assert len(loaded.segments) == len(scene.segments)
    assert len(loaded.materials) == len(scene.materials)
    assert len(loaded.instances) == len(scene.instances)
    a = scene.build()
    b = loaded.build()
    np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))
    np.testing.assert_array_equal(np.asarray(a.indices), np.asarray(b.indices))
    np.testing.assert_array_equal(
        np.asarray(a.textures.texels), np.asarray(b.textures.texels)
    )
    np.testing.assert_allclose(
        np.asarray(a.materials.base_color_factor),
        np.asarray(b.materials.base_color_factor),
    )


@pytest.mark.skipif(not SAMPLES.exists(), reason="no sample assets")
def test_skinned_gltf_roundtrip_renders(tmp_path):
    from arkoserenderer.assets.gltf import load_gltf
    from arkoserenderer.core.types import RasterConfig, SceneLimits
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight

    lim = SceneLimits(max_vertices=1 << 16, max_indices=3 << 16, max_drawables=16,
                      max_materials=8, max_textures=16, texture_pool_texels=1 << 21)
    from arkoserenderer.scene.scene import Scene

    scene = Scene(limits=lim)
    load_gltf(scene, SAMPLES / "CesiumMan" / "CesiumMan.gltf", max_texture_size=64)
    scene.sun = DirectionalLight()
    path = tmp_path / "man.arkscene.npz"
    save_baked(scene, path)
    loaded = load_baked(path, limits=lim)
    assert loaded.skeletons and loaded.animations
    cam = Camera(viewport=(64, 64))
    center, radius = loaded.bounding_sphere()
    cam.look_at(center + np.array([0, 0, radius * 2.5]), center)
    cfg = PipelineConfig(width=64, height=64,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
                         shadow_map_size=128)
    r = Renderer(loaded, cam, cfg, taa=False, bloom=False)
    img = np.array(r.render_frame(delta_time=0.3))
    assert np.isfinite(img).all()


def test_bake_tool_cli(tmp_path):
    if not SAMPLES.exists():
        pytest.skip("no sample assets")
    import sys
    sys.path.insert(0, "/root/repo/tools")
    import bake

    out = tmp_path / "box.arkscene.npz"
    bake.main([str(SAMPLES / "CornellBox" / "CornellBox.gltf"), str(out), "--meshlets"])
    assert out.exists()
    loaded = load_baked(out, limits=None)
    assert len(loaded.segments) >= 1


def test_asset_cache(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("1")
    cache = AssetCache()
    calls = []

    def loader(path):
        calls.append(path)
        return open(path).read()

    assert cache.load(p, loader) == "1"
    assert cache.load(p, loader) == "1"
    assert len(calls) == 1  # cache hit
    import os, time
    time.sleep(0.01)
    p.write_text("2")
    os.utime(p)
    assert cache.load(p, loader) == "2"  # mtime invalidation
    assert len(calls) == 2
