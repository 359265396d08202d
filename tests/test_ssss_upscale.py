"""SSSS (config #5 component) and the upscaler slot (DLSS analogue)."""

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


def test_ssss_blurs_only_subsurface_materials():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    scene.materials[2].subsurface = 1.0  # the sphere becomes "skin"
    r = Renderer(scene, cam, CFG, ssss=True, taa=False, bloom=False)
    img_sss = np.array(r.render_frame())

    scene2, cam2 = build_test_scene(viewport=(96, 96), n_spheres=1)
    scene2.materials[2].subsurface = 1.0
    r2 = Renderer(scene2, cam2, CFG, ssss=False, taa=False, bloom=False)
    img_ref = np.array(r2.render_frame())

    mat = np.asarray(r.state["SceneMaterial"])
    skin = mat[..., 3] > 0.5
    assert skin.any()
    diff = np.abs(img_sss - img_ref).mean(-1)
    # Skin pixels change, non-skin pixels unchanged.
    assert diff[skin].mean() > diff[~skin].mean() * 3
    assert diff[~skin].max() < 1e-4


def test_upscale_pass_produces_display_res():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False, upscale_to=(192, 192))
    r.render_frame()
    out = np.asarray(r.state["LDRDisplay"])
    assert out.shape == (192, 192, 3)
    assert np.isfinite(out).all()
    assert 0.0 <= out.min() and out.max() <= 1.0
    # Upscaled image resembles the low-res one (downsample back and compare).
    low = np.asarray(r.state["LDR"])
    ds = out.reshape(96, 2, 96, 2, 3).mean((1, 3))
    assert np.abs(ds - low).mean() < 0.05


def test_ideal_render_resolution():
    from arkoserenderer.ops.upscale import ideal_render_resolution

    w, h = ideal_render_resolution(1920, 1080, "quality")
    assert w <= 1920 / 1.4 and h <= 1080 / 1.4
    assert w % 8 == 0 and h % 8 == 0


@pytest.mark.heavy  # multi-frame convergence: nightly lane
def test_temporal_upscale_converges_toward_native():
    """TSR north star (DLSSNode slot): a STATIC scene rendered at 2/3 res
    with jittered temporal accumulation converges toward the native
    display-res render, and beats the spatial upscaler clearly."""
    import dataclasses

    rw, rh, dw, dh = 96, 96, 144, 144
    cfg_r = dataclasses.replace(CFG, width=rw, height=rh)

    def fresh(upscale_mode):
        scene, cam = build_test_scene(viewport=(rw, rh), n_spheres=1)
        return Renderer(scene, cam, cfg_r, bloom=False, vignette=0.0,
                        upscale_to=(dw, dh), upscale_mode=upscale_mode)

    # Native reference: same scene rendered directly at display res,
    # no jitter, no TAA.
    scene_n, cam_n = build_test_scene(viewport=(dw, dh), n_spheres=1)
    cam_n.jitter_enabled = False
    cfg_n = dataclasses.replace(CFG, width=dw, height=dh)
    r_native = Renderer(scene_n, cam_n, cfg_n, taa=False, bloom=False,
                        vignette=0.0)
    native = np.array(r_native.render_frame())

    r_tsr = fresh("temporal")
    for _ in range(24):  # > one 16-frame jitter period
        out_tsr = r_tsr.render_frame()
    tsr = np.array(out_tsr)
    assert tsr.shape == (dh, dw, 3)

    r_sp = fresh("spatial")
    for _ in range(24):
        out_sp = r_sp.render_frame()
    spatial = np.array(out_sp)

    inner = (slice(8, -8), slice(8, -8))
    err_tsr = np.abs(tsr - native)[inner].mean()
    err_sp = np.abs(spatial - native)[inner].mean()
    assert err_tsr < 0.8 * err_sp, (err_tsr, err_sp)
    assert err_tsr < 0.02, err_tsr
