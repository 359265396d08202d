"""Discrete mesh LOD chains: distance-band selection inside jit
(MeshAsset LOD analogue, arkcore/asset/MeshAsset.h)."""

import numpy as np

from arkoserenderer.assets.procedural import build_test_scene, make_uv_sphere
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.scene import Material

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
    shadow_map_size=128,
)


def _lod_scene(push_back: float):
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=0)
    red = scene.add_material(Material(
        base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
    blue = scene.add_material(Material(
        base_color_factor=np.array([0.1, 0.1, 0.9, 1.0], np.float32)))
    hi = make_uv_sphere(0.6, rings=16, sectors=32)
    hi.material = red
    lo = make_uv_sphere(0.6, rings=6, sectors=12)
    lo.material = blue
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (0.0, 0.6, -push_back)
    scene.add_instance_lods(
        [scene.add_segment(hi), scene.add_segment(lo)], w, distances=[8.0]
    )
    return scene, cam


def _dominant_instance(r):
    vis = np.asarray(r.state["Visibility"])
    orig = np.asarray(r.state["vis.setup"].orig_tri)
    ti = np.asarray(r.scene_arrays.tri_instance)
    on = vis[vis >= 0]
    inst = ti[orig[on]]
    inst = inst[inst >= 2]  # drop the floor (0) and the box (1)
    return int(np.bincount(inst).argmax()) if len(inst) else -1


def test_lod_selects_by_distance():
    scene, cam = _lod_scene(0.0)       # near: camera within 8m
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.render_frame()
    near_inst = _dominant_instance(r)

    scene2, cam2 = _lod_scene(12.0)    # pushed past the 8m switch
    r2 = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    r2.render_frame()
    far_inst = _dominant_instance(r2)

    assert near_inst >= 0 and far_inst >= 0
    assert near_inst != far_inst       # a different LOD drawable rendered
    # Materials differ per level, so the images prove which level drew.
    mats = np.asarray(r.scene_arrays.inst_material)
    assert mats[near_inst] != mats[far_inst]


def test_lod_levels_never_double_draw():
    scene, cam = _lod_scene(0.0)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.render_frame()
    vis = np.asarray(r.state["Visibility"])
    orig = np.asarray(r.state["vis.setup"].orig_tri)
    ti = np.asarray(r.scene_arrays.tri_instance)
    insts = set(ti[orig[vis[vis >= 0]]].tolist()) - {0, 1}  # floor, box
    assert len(insts) == 1  # exactly one LOD level visible
