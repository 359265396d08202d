"""Hair ribbon rendering + AO baking."""

import numpy as np

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.scene import Material

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def add_test_hair(scene, n_strands=24):
    rng = np.random.default_rng(3)
    pts, segs = [], []
    for _ in range(n_strands):
        root = np.array([rng.uniform(-0.5, 0.5), 1.2, rng.uniform(-0.5, 0.5)])
        n_pts = 6
        strand = [root + np.array([0, -0.12 * i, 0.02 * i * i]) for i in range(n_pts)]
        pts.extend(strand)
        segs.append(n_pts - 1)
    mat = scene.add_material(Material(
        base_color_factor=np.array([0.35, 0.22, 0.08, 1.0], np.float32),
        roughness_factor=0.5, double_sided=True,
    ))
    scene.add_hair(np.array(pts, np.float32), np.array(segs), material=mat,
                   radius=0.02)


def test_hair_renders_and_faces_camera():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    add_test_hair(scene)
    assert scene.static_info().has_hair
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()
    # Hair instance is the last one; its triangles must appear on screen.
    vis = np.asarray(r.state["Visibility"])
    setup_orig = np.asarray(r.state["vis.setup"].orig_tri)
    tri_inst = np.asarray(r.scene_arrays.tri_instance)
    on_screen = vis[vis >= 0]
    insts = tri_inst[setup_orig[on_screen]]
    hair_inst = len(scene.instances) - 1
    assert (insts == hair_inst).any(), "no hair pixels rendered"


def test_bake_vertex_ao_concavity():
    from arkoserenderer.ops.bake_ao import bake_vertex_ao

    scene, cam = build_test_scene(viewport=(64, 64), n_spheres=1)
    arrays = scene.build(with_bvh=True)
    ao, bent = bake_vertex_ao(arrays, num_rays=16, max_distance=1.5)
    valid = np.asarray(arrays.tri_valid)
    used = np.unique(np.asarray(arrays.indices)[valid].reshape(-1))
    a = ao[used]
    assert np.isfinite(a).all()
    assert a.min() < 0.9      # contact areas are occluded
    assert a.max() > 0.95     # open areas unoccluded
    n = bent[used]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-3)
