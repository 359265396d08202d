"""Golden-image cases: canonical scenes rendered at 256x256 and compared
with the committed PNGs in ``tests/goldens``.

The reference has no automated image tests (SURVEY.md §4). These cases
cover the forward, post, RT, DDGI, showcase and path-traced frames plus one
real glTF asset (DamagedHelmet, the reference's own sample model, vendored
under ``assets/sample``). ``tests/test_golden.py`` renders them on the CPU;
``chip_smoke.py`` renders them on the GPU against the same PNGs and limits.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
GOLDEN_DIR = REPO / "tests" / "goldens"
HELMET_GLTF = REPO / "assets" / "sample" / "DamagedHelmet" / "DamagedHelmet.gltf"
RES = 256
# Limits: small numeric drift passes, a structural change fails.
MAX_MEAN_ABS_DIFF = 1.5        # of 255
MAX_FRAC_PIXELS_OFF = 0.005    # channels that differ by more than PIXEL_OFF
PIXEL_OFF = 24


def golden_config():
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.rendering.pipeline import PipelineConfig

    return PipelineConfig(
        width=RES, height=RES,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
        shadow_map_size=256,
    )


def render_cases() -> dict:
    """name -> zero-argument function returning the (RES, RES, 3) frame."""
    from arkoserenderer.assets.procedural import build_test_scene, gradient_env_map
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.models.standard import Renderer

    cfg = golden_config()

    def forward():
        scene, cam = build_test_scene(viewport=(RES, RES))
        r = Renderer(scene, cam, cfg, taa=False, bloom=False)
        return np.array(r.render_frame())

    def full_post():
        scene, cam = build_test_scene(viewport=(RES, RES))
        r = Renderer(scene, cam, cfg, ssao=True, motion_blur=True)
        return np.array(r.render_frames(3))

    def rt():
        from arkoserenderer.scene.lights import SpotLight

        scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=1)
        # Shadow-casting spot: pins RTLocalShadowPass (exact local masks).
        scene.spots.append(SpotLight(
            position=np.array([0.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.2, -1.0, -0.1], np.float32),
            luminous_intensity_cd=150000.0,
            cast_shadows=True,
        ))
        r = Renderer(scene, cam, cfg, rt_shadows=True, rt_reflections=True,
                     taa=False, bloom=False)
        return np.array(r.render_frames(2))

    def ddgi():
        from arkoserenderer.ops.ddgi import ProbeGridConfig

        scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=1)
        r = Renderer(scene, cam, cfg, ddgi=ProbeGridConfig(),
                     taa=False, bloom=False)
        return np.array(r.render_frames(2))

    def showcase():
        # The BASELINE north-star frame: raster + RT shadows/reflections +
        # DDGI + SSAO + full post in ONE pipeline (bench --config showcase).
        from arkoserenderer.ops.ddgi import ProbeGridConfig

        scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=1)
        r = Renderer(scene, cam, cfg, rt_shadows=True, rt_reflections=True,
                     ddgi=ProbeGridConfig(), ssao=True, fog=True,
                     motion_blur=True)
        return np.array(r.render_frames(2))

    def pathtraced():
        from arkoserenderer.models.pathtracer import PathTracer

        scene, cam = build_test_scene(viewport=(RES, RES), n_spheres=1)
        t = PathTracer(scene, cam, RES, RES, max_bounces=2, seed=7)
        t.render_sample(4)
        return np.array(t.ldr())

    def helmet():
        # Real glTF asset golden: the reference's own DamagedHelmet sample
        # (base color + normal + metallic-roughness + emissive textures).
        from arkoserenderer.assets.gltf import load_gltf
        from arkoserenderer.scene.camera import Camera
        from arkoserenderer.scene.lights import DirectionalLight
        from arkoserenderer.scene.scene import Scene

        scene = Scene(limits=SceneLimits(
            max_vertices=1 << 18, max_indices=3 << 18, max_drawables=64,
            max_materials=32, max_textures=32, texture_pool_texels=1 << 22,
        ))
        load_gltf(scene, HELMET_GLTF, max_texture_size=256)
        scene.sun = DirectionalLight(
            direction=np.array([-0.5, -1.0, -0.6], np.float32),
            illuminance_lux=90000.0,
        )
        scene.set_env_map(gradient_env_map(32), brightness=8000.0)
        scene.ambient_lx = 4000.0
        center, radius = scene.bounding_sphere()
        cam = Camera(viewport=(RES, RES))
        cam.look_at(center + np.array([radius * 0.4, radius * 0.5, radius * 2.0]),
                    center)
        r = Renderer(scene, cam, cfg, taa=False, bloom=False)
        return np.array(r.render_frame())

    return {
        "forward": forward,
        "full_post": full_post,
        "rt": rt,
        "ddgi": ddgi,
        "showcase": showcase,
        "pathtraced": pathtraced,
        "helmet": helmet,
    }


def compare_to_golden(name: str, img) -> tuple[float, float]:
    """(mean abs diff, fraction of channels off by > PIXEL_OFF) of a
    rendered frame against ``tests/goldens/<name>.png``."""
    from arkoserenderer.utils.imageio import load_image_rgba, to_u8

    golden = load_image_rgba(str(GOLDEN_DIR / f"{name}.png"))[..., :3]
    diff = np.abs(to_u8(img).astype(int) - golden.astype(int))
    return float(diff.mean()), float((diff > PIXEL_OFF).mean())


def within_limits(mean_diff: float, frac_off: float) -> bool:
    return mean_diff < MAX_MEAN_ABS_DIFF and frac_off < MAX_FRAC_PIXELS_OFF
