"""Showcase app: the framework's flagship demo + headless frame driver.

Role-equivalent to the reference's application layer
(arkose/application/Arkose.cpp:96-190 boot/main loop + apps/ShowcaseApp.cpp):
builds a scene (procedural showcase, or any glTF), runs the full forward
pipeline for N frames, and writes PNG frames — the off-screen
``submitRenderPipeline`` mode (VulkanBackend.cpp:2130-2284) is the headless
fit; interactive windowing is a later host-integration layer.

Usage:
  python -m arkoserenderer.apps.showcase --frames 8 --out frame.png
  python -m arkoserenderer.apps.showcase --gltf path/to.gltf --width 512
  python -m arkoserenderer.apps.showcase --pathtracer --samples 64
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", type=str, default="arkose_frame.png")
    p.add_argument("--gltf", type=str, default=None, help="render a glTF file")
    p.add_argument("--pathtracer", action="store_true", help="ground-truth mode")
    p.add_argument("--samples", type=int, default=32, help="path tracer spp")
    p.add_argument("--texture-quality", type=str, default="trilinear",
                   help="texture filter: trilinear (8 taps), bilinear "
                        "(nearest-mip, 4 taps), anisoN (N-tap anisotropic, "
                        "e.g. aniso4), stochastic/stochastic1 (TAA-converged "
                        "jittered taps)")
    p.add_argument("--tonemap", type=str, default="agx",
                   choices=["clamp", "reinhard", "aces", "agx", "khronos_pbr_neutral"])
    p.add_argument("--ssao", action="store_true")
    p.add_argument("--rt-shadows", action="store_true")
    p.add_argument("--sun-angular-radius", type=float, default=0.0,
                   help="sun disk angular radius in degrees (> 0 with "
                        "--rt-shadows = cone-sampled soft shadows + sigma "
                        "denoiser; real sun ~0.265)")
    p.add_argument("--rt-reflections", action="store_true")
    p.add_argument("--ddgi", action="store_true")
    p.add_argument("--ddgi-probe-debug", action="store_true",
                   help="overlay irradiance-colored probe splats (needs --ddgi)")
    p.add_argument("--ssss", action="store_true")
    p.add_argument("--fog", action="store_true")
    p.add_argument("--upscale", type=float, default=None,
                   help="display scale factor (DLSS-slot upscaler)")
    p.add_argument("--upscale-mode", type=str, default="temporal",
                   choices=["temporal", "spatial"],
                   help="temporal = TAA-U super-resolution (DLSS-equivalent); "
                        "spatial = FSR1-style resample + RCAS")
    p.add_argument("--motion-blur", action="store_true")
    p.add_argument("--dof", action="store_true")
    p.add_argument("--no-taa", action="store_true")
    p.add_argument("--no-bloom", action="store_true")
    p.add_argument("--debug-draw", action="store_true")
    p.add_argument("--light-icons", action="store_true",
                   help="lightbulb billboards at local light positions")
    p.add_argument("--oit-layers", type=int, default=1,
                   help="translucent depth-peeling layer count (exact OIT)")
    p.add_argument("--timings", action="store_true", help="print per-pass ms")
    p.add_argument("--timings-deadline", type=float, default=None,
                   help="wall-clock budget (s) for the per-pass table; "
                        "emits a partial table when it expires")
    return p


def build_scene(args):
    from arkoserenderer.assets.procedural import build_test_scene, gradient_env_map
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight
    from arkoserenderer.scene.scene import Scene

    if args.gltf is None:
        return build_test_scene(viewport=(args.width, args.height))
    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 19, max_indices=3 << 19, max_drawables=1024,
        max_materials=256, max_textures=256, texture_pool_texels=1 << 23,
    ))
    lvl_cam = None
    env_loaded = False
    sun_loaded = False
    src = str(args.gltf)
    if src.endswith(".arklvl"):
        # The reference's serialized level: objects + lights + camera + env
        # (assets/ark.py).
        from arkoserenderer.assets.ark import load_arklvl

        res = load_arklvl(scene, src, max_texture_size=256)
        lvl_cam = res["cameras"][0] if res["cameras"] else None
        env_loaded = res["env"]
        sun_loaded = scene.sun is not None
    elif src.endswith(".arkmsh"):
        from arkoserenderer.assets.ark import load_arkmsh

        for sid in load_arkmsh(scene, src, max_texture_size=256):
            scene.add_instance(sid, np.eye(4, dtype=np.float32))
    else:
        from arkoserenderer.assets.gltf import load_gltf

        load_gltf(scene, src, max_texture_size=256)
    if not sun_loaded and scene.sun is None:
        scene.sun = DirectionalLight(
            direction=np.array([0.35, -1.0, -0.25], np.float32))
    if not env_loaded:
        scene.set_env_map(gradient_env_map(32), brightness=8000.0)
        scene.ambient_lx = 6000.0
    if lvl_cam is not None:
        lvl_cam.viewport = (args.width, args.height)
        return scene, lvl_cam
    cam = Camera(viewport=(args.width, args.height))
    center, radius = scene.bounding_sphere()
    cam.look_at(center + np.array([radius * 1.2, radius * 0.5, radius * 1.2]), center)
    cam.focus_depth = float(radius * 1.5)
    return scene, cam


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    from arkoserenderer.utils.compile_cache import enable_compile_cache
    from arkoserenderer.utils.imageio import save_png

    enable_compile_cache()

    scene, cam = build_scene(args)
    if args.sun_angular_radius > 0.0 and scene.sun is not None:
        scene.sun.angular_radius_deg = args.sun_angular_radius

    if args.pathtracer:
        from arkoserenderer.models.pathtracer import PathTracer

        tracer = PathTracer(scene, cam, args.width, args.height,
                            tonemap_mode=args.tonemap)
        t0 = time.perf_counter()
        tracer.render_sample(args.samples)
        img = np.asarray(tracer.ldr())
        dt = time.perf_counter() - t0
        save_png(args.out, img)
        print(f"path traced {args.samples} spp in {dt:.2f}s -> {args.out}")
        return

    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig

    cfg = PipelineConfig(
        width=args.width, height=args.height,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
        shadow_map_size=1024,
        tonemap_mode=args.tonemap,
        texture_quality=args.texture_quality,
    )
    upscale_to = None
    if args.upscale:
        upscale_to = (int(args.width * args.upscale), int(args.height * args.upscale))
    r = Renderer(
        scene, cam, cfg,
        taa=not args.no_taa, bloom=not args.no_bloom,
        ssao=args.ssao, motion_blur=args.motion_blur, depth_of_field=args.dof,
        rt_shadows=args.rt_shadows, rt_reflections=args.rt_reflections,
        ddgi=True if args.ddgi else None, ssss=args.ssss, fog=args.fog,
        ddgi_probe_debug=args.ddgi_probe_debug,
        upscale_to=upscale_to,
        upscale_mode=args.upscale_mode,
        debug_draw=args.debug_draw,
        light_icons=args.light_icons,
        oit_layers=args.oit_layers,
    )
    if args.debug_draw:
        r.debug.axes(size=1.0)
        center, radius = scene.bounding_sphere()
        r.debug.box(center - radius * 0.5, center + radius * 0.5)

    import jax

    jax.block_until_ready(r.render_frame())  # compile
    t0 = time.perf_counter()
    for _ in range(args.frames):
        out = r.render_frame()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / max(args.frames, 1)

    if args.timings:
        # Before the PNG readback, so the table times the frame alone.
        from arkoserenderer.utils.timing import format_timings, time_passes

        t = time_passes(
            r.pipeline, r.pipeline.initial_state(), r.scene_arrays,
            cam.state(1), deadline_s=args.timings_deadline,
            emit=lambda s: print(s, flush=True),
        )
        print(format_timings(t))

    save_png(args.out, np.asarray(out))
    print(f"{args.frames} frames @ {dt * 1e3:.2f} ms/frame -> {args.out}")


if __name__ == "__main__":
    main()
