"""Single-layer transparency (Forward translucent pass analogue)."""

import numpy as np

from arkoserenderer.assets.procedural import build_test_scene, make_box
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.scene import BLEND_TRANSLUCENT, Material

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def scene_with_glass(alpha):
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    glass = scene.add_material(Material(
        base_color_factor=np.array([0.4, 0.6, 0.9, alpha], np.float32),
        roughness_factor=0.1, blend_mode=BLEND_TRANSLUCENT,
    ))
    box = make_box((1.6, 1.6, 0.1))
    box.material = glass
    bid = scene.add_segment(box)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (-2.0, 1.0, 1.6)  # in front of the first sphere
    scene.add_instance(bid, w)
    return scene, cam


def test_translucency_blends_not_occludes():
    scene, cam = scene_with_glass(0.5)
    assert scene.static_info().has_translucent
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img_glass = np.array(r.render_frame())

    scene_op, cam2 = scene_with_glass(0.0)  # fully transparent
    r2 = Renderer(scene_op, cam2, CFG, taa=False, bloom=False)
    img_clear = np.array(r2.render_frame())

    scene3, cam3 = build_test_scene(viewport=(96, 96), n_spheres=1)
    r3 = Renderer(scene3, cam3, CFG, taa=False, bloom=False)
    img_none = np.array(r3.render_frame())

    # alpha=0 glass leaves the image essentially unchanged (tiny drift is
    # allowed: the extra instance enlarges the scene bounds, refitting the
    # sun shadow projection and shifting PCF taps slightly).
    assert np.abs(img_clear - img_none).mean() < 2e-3
    # alpha=0.5 glass changes some pixels but the scene remains visible
    # behind it (not fully occluded).
    diff = np.abs(img_glass - img_none).mean(-1)
    assert (diff > 0.02).any()
    changed = diff > 0.02
    # BLENDING, not occlusion: a denser pane (alpha 0.95) must diverge from
    # the background strictly more than the 0.5 pane on the same pixels —
    # i.e. the background's (1 - alpha) share really is present. (A plain
    # correlation threshold here was fragile: the pane's own lit surface
    # dominates the few covered pixels.)
    scene_d, cam_d = scene_with_glass(0.95)
    r_d = Renderer(scene_d, cam_d, CFG, taa=False, bloom=False)
    img_dense = np.array(r_d.render_frame())
    d_05 = np.abs(img_glass - img_none).mean(-1)[changed].mean()
    d_95 = np.abs(img_dense - img_none).mean(-1)[changed].mean()
    assert d_05 < 0.75 * d_95, (d_05, d_95)


def scene_with_glass_panes(with_back: bool):
    """Parallel translucent pane(s) in front of the sphere — the back pane
    is a surface single-layer transparency cannot represent."""
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    front = scene.add_material(Material(
        base_color_factor=np.array([0.9, 0.3, 0.2, 0.5], np.float32),
        roughness_factor=0.1, blend_mode=BLEND_TRANSLUCENT,
    ))
    back = scene.add_material(Material(
        base_color_factor=np.array([0.2, 0.4, 0.9, 0.5], np.float32),
        roughness_factor=0.1, blend_mode=BLEND_TRANSLUCENT,
    ))
    # The test camera sits at (4, 2.5, 5): place the back pane ALONG the
    # camera ray through the front pane so it is genuinely occluded.
    cam_pos = np.array([4.0, 2.5, 5.0], np.float32)
    p_front = np.array([-2.0, 1.0, 2.2], np.float32)
    ray = (p_front - cam_pos) / np.linalg.norm(p_front - cam_pos)
    p_back = p_front + ray * 0.9
    panes = [(front, p_front, 1.6)] + ([(back, p_back, 2.4)] if with_back else [])
    for mat, pos, size in panes:
        pane = make_box((size, size, 0.05))
        pane.material = mat
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = pos
        scene.add_instance(scene.add_segment(pane), w)
    return scene, cam


def _render(with_back, layers):
    scene, cam = scene_with_glass_panes(with_back)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False, oit_layers=layers)
    return np.array(r.render_frame())


def test_depth_peeled_oit_shows_second_layer():
    """A back pane hidden behind the front pane is INVISIBLE to 1-layer
    transparency but contributes with depth peeling. (Each pane is a thin
    box = 2 faces, so the front pane alone saturates layers 1-2; peeling 4
    layers reaches through it to the back pane.)"""
    base1 = _render(with_back=False, layers=1)
    both1 = _render(with_back=True, layers=1)
    base4 = _render(with_back=False, layers=4)
    both4 = _render(with_back=True, layers=4)
    assert np.isfinite(both4).all()

    # Overlap region = pixels covered by the front pane: where base1 differs
    # from a no-pane render is irrelevant; instead compare the back pane's
    # visible effect under each mode.
    d1 = np.abs(both1 - base1).max(-1)
    d4 = np.abs(both4 - base4).max(-1)
    # Peeling reveals the back pane in many pixels where 1-layer cannot
    # (pixels where the back pane is strictly behind the front pane).
    newly_visible = (d4 > 0.02) & (d1 <= 0.002)
    assert newly_visible.sum() > 40
