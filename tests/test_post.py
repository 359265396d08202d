"""Unit + integration tests for the post chain (SSAO, compose, fog, MB, DoF,
FXAA, CAS) — BASELINE config #2's feature set."""

import jax.numpy as jnp
import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.ops import postprocess as pp
from arkoserenderer.rendering.pipeline import PipelineConfig

W, H = 128, 128
CFG = PipelineConfig(
    width=W, height=H,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256, bin_chunk=512),
    shadow_map_size=256,
)


def test_full_post_chain_renders():
    scene, cam = build_test_scene(viewport=(W, H))
    cam.focus_depth = 6.0
    r = Renderer(
        scene, cam, CFG,
        ssao=True, fog=True, motion_blur=True, depth_of_field=True,
        fxaa=True, cas=True, film_grain=0.01,
    )
    img = np.array(r.render_frames(2))
    assert np.isfinite(img).all()
    assert 0.02 < img.mean() < 0.98
    assert img.std() > 0.03
    ao = np.asarray(r.state["SSAO"])
    assert ao.min() < 0.95  # something is occluded
    assert ao.max() <= 1.0


def test_ssao_darkens_concave_corner():
    # Two perpendicular planes forming a corner: AO at the corner < AO in
    # the open area.
    from arkoserenderer.scene.scene import Scene, MeshSegment
    from arkoserenderer.assets.procedural import make_plane, make_box
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.lights import DirectionalLight

    lim = SceneLimits(max_vertices=1 << 12, max_indices=3 << 12, max_drawables=8,
                      max_materials=4, max_textures=8, texture_pool_texels=1 << 16)
    scene = Scene(limits=lim)
    fid = scene.add_segment(make_plane(20.0))
    scene.add_instance(fid, np.eye(4, dtype=np.float32))
    box = make_box((2.0, 2.0, 2.0))
    bid = scene.add_segment(box)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (0.0, 1.0, 0.0)
    scene.add_instance(bid, w)
    scene.sun = DirectionalLight()
    cam = Camera(viewport=(W, H))
    cam.look_at((4.0, 3.0, 6.0), (0.0, 0.5, 0.0))
    r = Renderer(scene, cam, CFG, ssao=True, taa=False, bloom=False)
    r.render_frame()
    ao = np.asarray(r.state["SSAO"])
    vis = np.asarray(r.state["Visibility"])
    covered = vis >= 0
    assert ao[covered].min() < 0.85  # corners darkened
    assert ao[covered].max() > 0.97  # open floor unoccluded


def test_motion_blur_streaks_moving_camera():
    scene, cam = build_test_scene(viewport=(W, H))
    r = Renderer(scene, cam, CFG, motion_blur=True, taa=False, bloom=False)
    r.render_frame()
    # Move the camera laterally -> velocity != 0 -> blur changes the image
    # more than a static re-render would.
    cam.position = cam.position + np.array([0.4, 0.0, 0.0], np.float32)
    a = np.array(r.render_frame())
    vel = np.asarray(r.state["SceneVelocity"])
    assert np.abs(vel).max() > 1.0  # real motion vectors


def test_dof_blurs_defocused_background():
    # At 128px the physically-correct CoC of a 30mm lens is sub-pixel, so
    # use a fast telephoto (85mm f/1.4) focused close: the far floor gets a
    # multi-pixel CoC and visibly blurs.
    def make(enabled):
        scene, cam = build_test_scene(viewport=(W, H))
        cam.focal_length_mm = 85.0
        cam.f_number = 1.4
        cam.focus_depth = 2.0
        r = Renderer(scene, cam, CFG, depth_of_field=enabled, taa=False, bloom=False)
        return np.array(r.render_frame())

    img_dof = make(True)
    img_ref = make(False)

    def hf_energy(img):
        g = img.mean(-1)
        return np.abs(np.diff(g, axis=1)).mean()

    assert hf_energy(img_dof) < 0.8 * hf_energy(img_ref)


def test_fxaa_reduces_edge_aliasing():
    rng = np.random.default_rng(0)
    # Hard vertical edge.
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 16:] = 1.0
    out = np.asarray(pp.fxaa(jnp.asarray(img)))
    # Edge softened: intermediate values appear.
    assert ((out > 0.1) & (out < 0.9)).any()
    # Flat regions untouched.
    np.testing.assert_allclose(out[:, :8], 0.0, atol=1e-6)


def test_cas_sharpens_soft_edge():
    x = np.linspace(0, 1, 32, dtype=np.float32)
    img = np.broadcast_to(x[None, :, None], (32, 32, 3)).copy()
    out = np.asarray(pp.cas(jnp.asarray(img), sharpness=0.8))
    # Center gradient slope increases.
    mid = np.s_[16, 10:22, 0]
    assert np.abs(np.diff(out[mid])).mean() >= np.abs(np.diff(img[mid])).mean() * 0.99


def test_fog_fades_distant_geometry():
    scene, cam = build_test_scene(viewport=(W, H))
    r = Renderer(scene, cam, CFG, fog=True, taa=False, bloom=False)
    r_nofog_scene, cam2 = build_test_scene(viewport=(W, H))
    r2 = Renderer(r_nofog_scene, cam2, CFG, fog=False, taa=False, bloom=False)
    a = np.array(r.render_frame())
    b = np.array(r2.render_frame())
    assert np.abs(a - b).mean() > 1e-4  # fog visibly changes the frame
