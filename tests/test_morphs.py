"""Morph targets: scene integration + SimpleMorph reference asset."""

from pathlib import Path

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene, make_uv_sphere
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
    shadow_map_size=128,
)
MORPH_GLTF = Path(
    "/root/reference/assets/assets/engine/test/morph/SimpleMorph/SimpleMorph.gltf"
)


def test_morph_weights_deform_geometry():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    # Give the sphere a morph target that puffs it up.
    seg = scene.segments[1]
    seg.morph_pos = seg.normals[None] * 0.5  # (1, V, 3) inflate along normals
    seg.morph_nrm = np.zeros((1, len(seg.normals), 3), np.float32)
    assert scene.static_info().has_morphs

    r = Renderer(scene, cam, CFG, taa=False, bloom=False)

    def sphere_pixels():
        vis = np.asarray(r.state["Visibility"])
        orig = np.asarray(r.state["vis.setup"].orig_tri)
        ti = np.asarray(r.scene_arrays.tri_instance)
        on = vis[vis >= 0]
        return int((ti[orig[on]] == 1).sum())  # instance 1 = the sphere

    scene.set_morph_weights(np.array([0.0], np.float32))
    img0 = np.array(r.render_frame())
    px0 = sphere_pixels()
    scene.set_morph_weights(np.array([1.0], np.float32))
    img1 = np.array(r.render_frame())
    px1 = sphere_pixels()
    assert px1 > px0 * 1.5  # inflated sphere covers many more pixels
    assert np.abs(img1 - img0).max() > 0.05


@pytest.mark.skipif(not MORPH_GLTF.exists(), reason="no reference test asset")
def test_simple_morph_gltf_animates():
    from arkoserenderer.assets.gltf import load_gltf
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight
    from arkoserenderer.scene.scene import Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 12, max_indices=3 << 12, max_drawables=8,
        max_materials=4, max_textures=8, texture_pool_texels=1 << 16,
    ))
    load_gltf(scene, MORPH_GLTF)
    info = scene.static_info()
    assert info.has_morphs
    # Light the (+Z-facing) triangle head-on and add sky so it's visible.
    scene.sun = DirectionalLight(direction=np.array([0.1, -0.3, -1.0], np.float32))
    from arkoserenderer.assets.procedural import gradient_env_map

    scene.set_env_map(gradient_env_map(16), brightness=8000.0)
    cam = Camera(viewport=(64, 64))
    center, radius = scene.bounding_sphere()
    cam.look_at(center + np.array([0, radius, radius * 2.5]), center)
    cfg = PipelineConfig(width=64, height=64,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                         shadow_map_size=128)
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    # The morph weights animate via the clip; geometry must move over time.
    imgs = [np.array(r.render_frame(delta_time=0.35)) for _ in range(4)]
    deltas = [np.abs(imgs[i + 1] - imgs[i]).max() for i in range(3)]
    assert max(deltas) > 0.02, f"morph animation static: {deltas}"


def test_multiple_independent_morph_blocks():
    """Round 3: multiple morphing meshes per scene (the reference has no
    one-morph-limit; each morphed instance owns a vertex-pool block with
    independent weights)."""
    from arkoserenderer.assets.procedural import make_uv_sphere

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    # First morph mesh: the built-in sphere (instance 1, segment 1).
    seg = scene.segments[1]
    seg.morph_pos = seg.normals[None] * 0.5
    seg.morph_nrm = np.zeros((1, len(seg.normals), 3), np.float32)
    # Second morph mesh: a far-apart sphere (no occlusion overlap with the
    # first from the test camera).
    sph = make_uv_sphere(0.5, rings=12, sectors=24)
    sph.material = seg.material
    sph.morph_pos = sph.normals[None] * 0.5
    sph.morph_nrm = np.zeros((1, len(sph.normals), 3), np.float32)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (2.4, 0.5, 2.0)
    second_inst = len(scene.instances)
    scene.add_instance(scene.add_segment(sph), w)
    info = scene.static_info()
    assert info.has_morphs and len(info.morph_vertex_base) == 2

    r = Renderer(scene, cam, CFG, taa=False, bloom=False)

    def pixels_of(inst):
        vis = np.asarray(r.state["Visibility"])
        orig = np.asarray(r.state["vis.setup"].orig_tri)
        ti = np.asarray(r.scene_arrays.tri_instance)
        on = vis[vis >= 0]
        return int((ti[orig[on]] == inst).sum())

    scene.set_morph_weights(np.array([0.0], np.float32), block=0)
    scene.set_morph_weights(np.array([0.0], np.float32), block=1)
    r.render_frame()
    a0, b0 = pixels_of(1), pixels_of(second_inst)

    # Inflate ONLY block 1 (the second morphed instance).
    scene.set_morph_weights(np.array([1.0], np.float32), block=1)
    r.render_frame()
    a1, b1 = pixels_of(1), pixels_of(second_inst)
    assert b1 > b0 * 1.4, (b0, b1)        # second sphere inflated
    assert abs(a1 - a0) <= max(3, a0 // 20), (a0, a1)  # first untouched

    # Now inflate block 0 as well: both large.
    scene.set_morph_weights(np.array([1.0], np.float32), block=0)
    r.render_frame()
    a2 = pixels_of(1)
    assert a2 > a0 * 1.4, (a0, a2)
