"""Meshlet-granularity culling in the geometry pass."""

import numpy as np

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def test_meshlet_culling_image_matches():
    scene, cam = build_test_scene(viewport=(96, 96))
    scene.enable_meshlets = True
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    assert r.cfg.scene.has_meshlets
    img_m = np.array(r.render_frame())

    scene2, cam2 = build_test_scene(viewport=(96, 96))
    r2 = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    img = np.array(r2.render_frame())
    # Conservative culling must not change the image.
    np.testing.assert_allclose(img_m, img, atol=1e-5)


def test_meshlet_arrays_populated():
    scene, cam = build_test_scene(viewport=(96, 96))
    scene.enable_meshlets = True
    arrays = scene.build()
    assert int(np.asarray(arrays.meshlet_valid).sum()) > 4
    spheres = np.asarray(arrays.meshlet_sphere)
    assert (spheres[:, 3] > 0).all()
    # Every valid triangle belongs to a meshlet of its own instance.
    tm = np.asarray(arrays.tri_meshlet)
    valid = np.asarray(arrays.tri_valid)
    mi = np.asarray(arrays.meshlet_instance)
    ti = np.asarray(arrays.tri_instance)
    np.testing.assert_array_equal(mi[tm[valid]], ti[valid])
