"""Pixel-band SPMD tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.parallel.sharded import ShardedRenderer
from arkoserenderer.rendering.pipeline import PipelineConfig

W, H = 128, 128
CFG = PipelineConfig(
    width=W,
    height=H,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256, bin_chunk=512),
    shadow_map_size=256,
)


@pytest.mark.heavy
@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_matches_single_device(n_devices):
    # Bloom ON: the pyramid exchanges one halo row per level over the mesh
    # axis (ppermute), so even the wide blur chain matches the
    # single-device render exactly (round-1 carve-out removed).
    scene, cam = build_test_scene(viewport=(W, H))
    ref = Renderer(scene, cam, CFG)
    a = np.asarray(ref.render_frame())

    scene2, cam2 = build_test_scene(viewport=(W, H))
    shr = ShardedRenderer(scene2, cam2, CFG, n_devices=n_devices)
    b = np.array(shr.render_frame())

    assert b.shape == (H, W, 3)
    mism = np.abs(a - b) > 1e-5
    assert mism.mean() < 1e-3, f"sharded render diverges: {mism.mean():.4f}"


def test_sharded_multi_frame_stable():
    scene, cam = build_test_scene(viewport=(W, H))
    shr = ShardedRenderer(scene, cam, CFG, n_devices=8, bloom=False)
    for _ in range(3):
        img = np.array(shr.render_frame())
    assert np.all(np.isfinite(img))
    assert 0.05 < img.mean() < 0.95


def test_sharded_matches_with_spot_shadow_atlas_and_icons():
    """The round-closing passes (local shadow atlas, icon billboards) must
    be band-correct: each device rasterizes the full (small) spot atlas and
    splats icons only into its own band."""
    from arkoserenderer.scene.lights import SpotLight
    import dataclasses

    cfg = dataclasses.replace(CFG, local_shadow_map_size=64)

    def make():
        scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
        scene.spots.append(SpotLight(
            position=np.array([-2.0, 3.5, 0.0], np.float32),
            direction=np.array([0.0, -1.0, 0.0], np.float32),
            luminous_intensity_cd=60000.0,
            outer_cone_angle=np.radians(50.0),
            inner_cone_angle=np.radians(35.0),
        ))
        return scene, cam

    scene, cam = make()
    ref = Renderer(scene, cam, cfg, bloom=False, light_icons=True)
    a = np.asarray(ref.render_frame())

    scene2, cam2 = make()
    shr = ShardedRenderer(scene2, cam2, cfg, n_devices=4, bloom=False,
                          light_icons=True)
    b = np.array(shr.render_frame())
    mism = np.abs(a - b) > 1e-5
    assert mism.mean() < 1e-3, f"sharded spot/icon render diverges: {mism.mean():.4f}"


@pytest.mark.heavy
def test_sharded_matches_single_device_ssao():
    """SSAO under pixel-band SPMD: occlusion fetches read the all_gather-ed
    full-frame depth and the blur exchanges halo rows — band-exact."""
    scene, cam = build_test_scene(viewport=(W, H))
    ref = Renderer(scene, cam, CFG, ssao=True, bloom=False)
    a = np.asarray(ref.render_frame())

    scene2, cam2 = build_test_scene(viewport=(W, H))
    shr = ShardedRenderer(scene2, cam2, CFG, n_devices=4, ssao=True, bloom=False)
    b = np.array(shr.render_frame())
    mism = np.abs(a - b) > 1e-5
    assert mism.mean() < 1e-3, f"sharded SSAO diverges: {mism.mean():.4f}"


@pytest.mark.heavy
def test_sharded_matches_single_device_rt():
    """RT shadows + reflections under pixel-band SPMD: rays trace
    band-local; the denoiser runs replicated on gathered planes. Two frames
    exercise the temporal history slicing. A shadow-casting spot pulls
    RTLocalShadowPass (per-light any-hit masks) into the sharded frame."""
    from arkoserenderer.scene.lights import SpotLight

    def make():
        scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
        scene.spots.append(SpotLight(
            position=np.array([0.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.2, -1.0, -0.1], np.float32),
            luminous_intensity_cd=150000.0,
            cast_shadows=True,
        ))
        return scene, cam

    scene, cam = make()
    ref = Renderer(scene, cam, CFG, rt_shadows=True, rt_reflections=True,
                   taa=False, bloom=False)
    for _ in range(2):
        a = np.array(ref.render_frame())

    scene2, cam2 = make()
    shr = ShardedRenderer(scene2, cam2, CFG, n_devices=4, rt_shadows=True,
                          rt_reflections=True, taa=False, bloom=False)
    for _ in range(2):
        b = np.array(shr.render_frame())
    mism = np.abs(a - b) > 1e-5
    assert mism.mean() < 1e-3, f"sharded RT diverges: {mism.mean():.4f}"


@pytest.mark.heavy
def test_sharded_matches_single_device_ddgi():
    """DDGI under pixel-band SPMD: probe updates run replicated
    (deterministic => consistent across devices); per-pixel probe sampling
    is band-local."""
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    ref = Renderer(scene, cam, CFG, ddgi=True, taa=False, bloom=False)
    for _ in range(2):
        a = np.array(ref.render_frame())

    scene2, cam2 = build_test_scene(viewport=(W, H), n_spheres=1)
    shr = ShardedRenderer(scene2, cam2, CFG, n_devices=4, ddgi=True,
                          taa=False, bloom=False)
    for _ in range(2):
        b = np.array(shr.render_frame())
    mism = np.abs(a - b) > 1e-5
    assert mism.mean() < 1e-3, f"sharded DDGI diverges: {mism.mean():.4f}"


@pytest.mark.heavy
def test_sharded_matches_single_device_soft_shadows():
    """SOFT RT shadows under pixel-band SPMD: stochastic cone/disk rays
    sample blue noise at band-GLOBAL pixel coords (same sequence as the
    single-device render) and the sigma denoiser runs replicated over
    gathered planes — so three frames of sun + local soft shadows must
    match single-device exactly, temporal history slicing included."""
    from arkoserenderer.scene.lights import SpotLight

    def make():
        scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
        scene.sun.angular_radius_deg = 6.0
        scene.spots.append(SpotLight(
            position=np.array([0.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.2, -1.0, -0.1], np.float32),
            luminous_intensity_cd=150000.0,
            cast_shadows=True,
            source_radius=0.3,
        ))
        return scene, cam

    scene, cam = make()
    ref = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False)
    for _ in range(3):
        a = np.array(ref.render_frame())

    scene2, cam2 = make()
    shr = ShardedRenderer(scene2, cam2, CFG, n_devices=4, rt_shadows=True,
                          taa=False, bloom=False)
    for _ in range(3):
        b = np.array(shr.render_frame())
    mism = np.abs(a - b) > 1e-5
    assert mism.mean() < 1e-3, f"sharded soft shadows diverge: {mism.mean():.4f}"


@pytest.mark.heavy
def test_dryrun_full_execute_8_devices(monkeypatch):
    """The multichip dry run's ARK_DRYRUN_FULL=1 path, CI-covered so it
    can't rot: compile AND EXECUTE all three sharded configs
    (forward+SSAO, RT shadows+reflections, DDGI) on the full 8-device mesh.
    ``dryrun_multichip`` re-execs into a hermetic virtual-CPU subprocess, so
    this runs identically under any pytest platform config; it raises on any
    non-finite pixel or failed collective, which is the assertion."""
    import sys

    monkeypatch.setenv("ARK_DRYRUN_FULL", "1")
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    try:
        import __graft_entry__

        __graft_entry__.dryrun_multichip(8)
    finally:
        sys.path.pop(0)


@pytest.mark.parametrize("height,n_devices,ok", [
    (1080, 4, False),   # 270-row bands are not whole 8-row tiles
    (1152, 4, True),
    (1080, 3, False),   # 360 rows: whole tiles, but 8192 / 3 is not
    (1152, 8, True),
])
def test_band_config_needs_whole_tile_rows(height, n_devices, ok):
    import dataclasses

    from arkoserenderer.parallel.sharded import band_config

    cfg = dataclasses.replace(CFG, width=1920, height=height,
                              shadow_map_size=8192)
    if ok:
        band = band_config(cfg, n_devices)
        assert band.height * n_devices == height
        assert band.full_height == height and band.shard_count == n_devices
    else:
        with pytest.raises(ValueError, match="split"):
            band_config(cfg, n_devices)
