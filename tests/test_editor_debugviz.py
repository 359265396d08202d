"""Editor logic, gizmo math, and debug visualization modes."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.editor import EditorScene, gizmo_axis_drag

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def test_editor_select_move_rebuild():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.render_frame()
    vis = np.asarray(r.state["Visibility"])
    ys, xs = np.nonzero(vis >= 0)
    ed = EditorScene(scene=scene)
    sel = ed.select_from_pick(r.pick(int(xs[len(xs) // 2]), int(ys[len(ys) // 2])))
    assert sel is not None
    before = ed.selected_transform().copy()
    ed.translate((1.0, 0.0, 0.0))
    after = ed.selected_transform()
    assert after[0, 3] == pytest.approx(before[0, 3] + 1.0)
    # Previous transform retained for velocity.
    _, _, prev, *_ = scene.instances[sel]
    assert prev is not None
    ed.rotate((0, 1, 0), 0.5)
    ed.scale(2.0)
    assert np.linalg.norm(ed.selected_transform()[:3, 0]) > np.linalg.norm(before[:3, 0])


def test_gizmo_axis_drag_sign_and_scale():
    from arkoserenderer.scene.camera import Camera

    cam = Camera(viewport=(200, 200))
    cam.look_at((0, 0, 10), (0, 0, 0))
    obj = np.zeros(3, np.float32)
    x_axis = np.array([1.0, 0, 0], np.float32)
    # Dragging right along +X's screen direction gives positive distance.
    d = gizmo_axis_drag(cam, x_axis, obj, np.array([100, 100]), np.array([130, 100]))
    assert d > 0
    d_back = gizmo_axis_drag(cam, x_axis, obj, np.array([100, 100]), np.array([70, 100]))
    assert d_back < 0
    # Axis pointing at the camera: no movement.
    z_axis = np.array([0, 0, 1.0], np.float32)
    dz = gizmo_axis_drag(cam, z_axis, obj, np.array([100, 100]), np.array([130, 100]))
    assert abs(dz) < 10.0  # degenerate-ish, bounded


@pytest.mark.parametrize("mode", ["visibility", "instance", "depth", "normal",
                                  "base_color", "roughness"])
def test_debug_visualize_modes(mode):
    from arkoserenderer.rendering.passes.debugviz import DebugVisualizePass

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.pipeline.passes.append(DebugVisualizePass(mode))
    r.pipeline.construct_all()
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert img.std() > 0.01  # something visible


def test_light_icon_billboards():
    """IconManager analogue: lightbulb splats at light positions, tinted by
    light color, depth-tested against the scene."""
    from arkoserenderer.scene.lights import PointLight

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    scene.points.append(PointLight(
        position=np.array([0.0, 2.5, 0.0], np.float32),
        color=np.array([1.0, 0.2, 0.1], np.float32),
        luminous_intensity_cd=500.0,
    ))
    r = Renderer(scene, cam, CFG, taa=False, bloom=False, light_icons=True)
    img = np.array(r.render_frame())

    scene2, cam2 = build_test_scene(viewport=(96, 96), n_spheres=1)
    scene2.points.append(PointLight(
        position=np.array([0.0, 2.5, 0.0], np.float32),
        color=np.array([1.0, 0.2, 0.1], np.float32),
        luminous_intensity_cd=500.0,
    ))
    r2 = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    img0 = np.array(r2.render_frame())

    d = np.abs(img - img0).max(-1)
    assert 10 < (d > 0.05).sum() < 200          # a small splat, not a wash
    yy, xx = np.nonzero(d > 0.05)
    # The icon is tinted by the light's chromaticity (red-dominant).
    assert img[yy, xx, 0].mean() > img[yy, xx, 2].mean()
