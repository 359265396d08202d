"""Local (spot) shadow atlas: per-light depth raster + PCF in shading
(LocalShadowDrawNode + ShadowMapAtlas analogues)."""

import numpy as np

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.lights import SpotLight

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
    shadow_map_size=128, local_shadow_map_size=64,
)


def _scene_with_spot(cast_shadows):
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    scene.sun.illuminance_lux = 2000.0  # dim the sun so the spot dominates
    # The sphere sits at (-2, 0.6, 0); hang the spot right above it.
    scene.spots.append(SpotLight(
        position=np.array([-2.0, 3.5, 0.0], np.float32),
        direction=np.array([0.0, -1.0, 0.0], np.float32),
        luminous_intensity_cd=60000.0,
        outer_cone_angle=np.radians(50.0), inner_cone_angle=np.radians(35.0),
        cast_shadows=cast_shadows,
    ))
    return scene, cam


def test_spot_shadow_atlas_occludes():
    scene, cam = _scene_with_spot(True)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img_s = np.array(r.render_frame())
    atlas = np.asarray(r.state["ShadowMap.locals"])
    assert atlas.shape == (1, 64, 64)
    floor_d = np.median(atlas[0][atlas[0] > 0])
    # The sphere is closer to the light than the floor (reverse-Z: larger).
    assert atlas[0].max() > floor_d * 1.3

    scene2, cam2 = _scene_with_spot(False)
    r2 = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    img_n = np.array(r2.render_frame())
    # cast_shadows=False must not even build the atlas pass.
    assert "ShadowMap.locals" not in r2.state
    d = np.abs(img_s - img_n).max(-1)
    assert np.isfinite(img_s).all() and np.isfinite(img_n).all()
    assert d.max() > 0.02          # the sphere's spot shadow darkens the floor
    assert (d > 0.01).sum() > 15   # over a real region, not one pixel
    # The shadowed region is DARKER with shadows on.
    yy, xx = np.nonzero(d > 0.01)
    assert (img_s[yy, xx].mean() < img_n[yy, xx].mean())


def test_spot_without_casting_matches_baseline_light():
    """A non-casting spot still lights the scene (atlas skipped, light on)."""
    scene, cam = _scene_with_spot(False)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img = np.array(r.render_frame())

    scene2, cam2 = build_test_scene(viewport=(96, 96), n_spheres=1)
    scene2.sun.illuminance_lux = 2000.0
    r2 = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    img0 = np.array(r2.render_frame())
    assert np.abs(img - img0).max() > 0.02  # the spot visibly contributes
