"""Benchmark: steady-state ms/frame of the flagship forward pipeline.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Baseline = the reference's implied 16.667 ms/frame (60 FPS) budget at 1080p
(arkose/rendering/RenderPipeline.cpp:82 per BASELINE.md); ``vs_baseline`` is
budget / measured, so > 1.0 means faster than the reference's implied budget
(the reference publishes no measured numbers — BASELINE.md).

Extra modes (BASELINE.md configs 2-5; each prints its own JSON line):
  --config full_post   TAA + bloom + SSAO + fog + motion blur + DoF @1080p
  --config stress      4,096 animated instances (ShowcaseApp stress scene)
  --config rt          RT sun shadows + RT reflections + denoiser @1080p
  --config ddgi        DDGI probe GI + SSSS @1080p
  --config helmet      real-asset lane: 6x6 DamagedHelmet grid (~556K tris,
                       real texture set) + RT shadows + DDGI @1080p
  --all                run every config
  --timings            also print the per-pass ms table (RenderPipeline's
                       per-node GPU timing display); --timings-deadline S
                       bounds it (partial table on expiry)

Every line names the devices it ran on (``device``: platform, device_kind,
count). Without --small the bench needs a GPU and fails without one; --small
gives CI-sized frames on any platform. The parent process only schedules:
each config runs in a child process, one after another, so one process at a
time holds the card.
"""

from __future__ import annotations

import argparse
import json
import time

BUDGET_MS = 16.667


def _cfg(small: bool, shadow: int = 8192, rt_scale: int = 1):
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.rendering.pipeline import PipelineConfig

    if small:
        return PipelineConfig(
            width=256, height=256,
            raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256,
                                bin_chunk=512),
            shadow_map_size=256,
        )
    # shadow 8192 = the reference's directional shadow map capacity
    # (DirectionalShadowDrawNode.cpp:17) — parity settings, not economy ones.
    return PipelineConfig(
        width=1920, height=1080,
        raster=RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256,
                            bin_chunk=2048),
        shadow_map_size=shadow,
        rt_scale=rt_scale,
    )


CONFIGS = {
    # name -> (scene kind, pipeline kwargs, metric description)
    "forward": ("test", {}, "forward(visbuf raster+shadow+PBR+TAA+bloom+tonemap)"),
    "full_post": (
        "test",
        dict(ssao=True, fog=True, motion_blur=True, depth_of_field=True),
        "full post (TAA+bloom+SSAO+fog+MB+DoF)",
    ),
    "stress": ("stress", {}, "4096 animated instances (culling stress)"),
    # BASELINE.md north-star config 3: meshlet visibility-buffer path with
    # per-meshlet culling, at stress scale.
    "meshlet": ("meshlet", {}, "meshlet visbuf + per-meshlet culling, 4096 instances"),
    # North-star config 4 verbatim: "RT shadows + reflections + denoise,
    # local lights" — a shadow-casting spot joins the sun.
    "rt": (
        "test_spot",
        dict(rt_shadows=True, rt_reflections=True),
        "RT shadows + RT reflections + FFX-style denoise + local light",
    ),
    # North-star config 5 verbatim: "DDGI + SSS + skinning/morph targets".
    "ddgi": (
        "test_anim",
        dict(ddgi=True, ssss=True),
        "DDGI probe GI + SSSS + skinning + morph targets",
    ),
    # The BASELINE.md north-star sentence verbatim: "the full raster+RT+DDGI
    # sample scene" in ONE frame — visbuf raster + RT sun shadows + RT
    # reflections + DDGI GI + SSAO + full post, the whole Showcase node
    # order at once (ShowcaseApp.cpp:129-227).
    "showcase": (
        "test",
        dict(rt_shadows=True, rt_reflections=True, ddgi=True, ssao=True,
             fog=True, motion_blur=True),
        "showcase: raster + RT shadows/reflections + DDGI + SSAO + full post",
    ),
    # Representative scale at PARITY settings: ~786K-tri
    # scene (4,096 instances x 192 tris), 256 materials / 64 textures, sun
    # (8192^2 parity shadow capacity; RT sun + RT local shadows actually
    # trace) + 2 shadow-casting spots + point light, RT reflections, DDGI at
    # 256 rays x 1,024 probes/frame over a 2,048-probe grid
    # (DDGINode.cpp:19-20 slider territory), SSAO + full post @1080p.
    "flagship": (
        "flagship",
        dict(rt_shadows=True, rt_reflections=True, ddgi="flagship",
             ssao=True, fog=True, motion_blur=True),
        "flagship: 786K tris, 256 mats/64 tex, RT shadows+refl, "
        "DDGI 256x1024, SSAO, full post",
    ),
    # Real-asset lane: a 6x6 grid of the reference's
    # own DamagedHelmet sample (ShowcaseApp.cpp:86-118 asset zoo) — ~556K
    # real triangles with the helmet's full texture set — RT sun shadows +
    # DDGI GI at parity budgets @1080p.
    "helmet": (
        "helmet",
        dict(rt_shadows=True, ddgi="helmet"),
        "helmet zoo: 36x DamagedHelmet (~556K tris, real textures), "
        "RT shadows + DDGI",
    ),
    # DLSS-slot workflow: render at 2/3 scale, spatial-upscale to 1080p
    # (the reference ships DLSS for exactly this; upscale quality preset).
    "forward_upscaled": ("test_upscaled", {}, "forward @ 2/3 scale + upscale to 1080p"),
    # Bindless pressure: every sphere has its own material; materials cycle
    # 64 distinct texture chains (vs the reference's 10,000-material /
    # 4,096-texture capacity, GpuScene.h:259-282) — stresses the packed
    # shading record gather + channel-packed texture fetches under real
    # material/texture divergence.
    # North-star config 2 verbatim: "PBR bindless scene, realistic camera,
    # TAA + DoF + motion blur @1080p".
    "bindless": ("bindless", dict(motion_blur=True, depth_of_field=True),
                 "256 materials / 64 textures bindless + TAA + MB + DoF"),
}


def _scene_label(kind: str) -> str:
    return ("real-asset scene" if kind == "helmet" else "procedural scene")


def build_renderer(name: str, small: bool):
    """Bench config ``name`` built: (renderer, description, output
    resolution, scene label)."""
    from arkoserenderer.models.standard import Renderer

    kind, kw, desc = CONFIGS[name]
    # Full-res RT: the bench runs the full-quality path (rt_scale=1).
    cfg = _cfg(small, rt_scale=1)
    if kind == "test_upscaled":
        import dataclasses

        from arkoserenderer.assets.procedural import build_test_scene
        from arkoserenderer.ops.upscale import ideal_render_resolution

        out_w, out_h = (cfg.width, cfg.height)
        rw, rh = ideal_render_resolution(out_w, out_h, "quality")
        cfg = dataclasses.replace(cfg, width=rw, height=rh)
        scene, camera = build_test_scene(viewport=(rw, rh))
        renderer = Renderer(scene, camera, cfg, upscale_to=(out_w, out_h))
        desc = f"{desc} (render {rw}x{rh})"
    elif kind in ("stress", "meshlet"):
        from arkoserenderer.assets.procedural import (
            build_stress_scene,
            make_stress_animator,
        )

        n_inst = 256 if small else 4096
        scene, camera = build_stress_scene(
            n_instances=n_inst, viewport=(cfg.width, cfg.height)
        )
        if kind == "meshlet":
            # Per-meshlet culling path (MeshletVisibilityBufferRenderNode):
            # meshlets built at scene build, culled per frame.
            scene.enable_meshlets = True
        # Device-side animation: the bob+spin grid is a traced prologue of
        # the frame program — no per-frame host math or pool uploads (those
        # cost ~45 ms at 4,096 instances vs <1 ms of device frame time).
        renderer = Renderer(
            scene, camera, cfg, scene_animator=make_stress_animator(scene), **kw
        )
    elif kind == "test_spot":
        import numpy as np

        from arkoserenderer.assets.procedural import build_test_scene
        from arkoserenderer.scene.lights import SpotLight

        scene, camera = build_test_scene(viewport=(cfg.width, cfg.height))
        scene.spots.append(SpotLight(
            position=np.array([1.5, 3.0, 1.0], np.float32),
            direction=np.array([-0.3, -1.0, -0.2], np.float32),
            luminous_intensity_cd=30000.0,
        ))
        renderer = Renderer(scene, camera, cfg, **kw)
    elif kind == "test_anim":
        import numpy as np

        from arkoserenderer.assets.procedural import (
            build_test_scene,
            make_box,
            make_uv_sphere,
        )
        from arkoserenderer.scene.animation import Skeleton
        from arkoserenderer.scene.scene import Material

        scene, camera = build_test_scene(viewport=(cfg.width, cfg.height))
        # Skinned element: one-joint skeleton, rest pose lifts the box.
        skel = scene.add_skeleton(Skeleton(
            parents=np.array([-1], np.int32),
            inverse_bind=np.eye(4, dtype=np.float32)[None],
            rest_translation=np.array([[0.0, 0.6, 0.0]], np.float32),
            rest_rotation=np.array([[0, 0, 0, 1]], np.float32),
            rest_scale=np.ones((1, 3), np.float32),
        ))
        box = make_box((0.7, 0.7, 0.7))
        box.material = scene.add_material(Material(
            base_color_factor=np.array([0.8, 0.6, 0.2, 1.0], np.float32)))
        nv = box.positions.shape[0]
        box.skeleton = skel
        box.skin_joints = np.zeros((nv, 4), np.int32)
        box.skin_weights = np.tile(np.array([1, 0, 0, 0], np.float32), (nv, 1))
        wb = np.eye(4, dtype=np.float32)
        wb[:3, 3] = (2.2, 0.0, 1.2)
        scene.add_instance(scene.add_segment(box), wb)
        # Morph element: sphere with an inflate target at weight 0.5.
        sph = make_uv_sphere(0.5, rings=12, sectors=24)
        sph.material = box.material
        sph.morph_pos = sph.normals[None] * 0.4
        sph.morph_nrm = np.zeros((1, len(sph.normals), 3), np.float32)
        ws = np.eye(4, dtype=np.float32)
        ws[:3, 3] = (-2.6, 0.5, 1.5)
        scene.add_instance(scene.add_segment(sph), ws)
        scene.set_morph_weights(np.array([0.5], np.float32))
        if kw.get("ddgi") is True and not small:
            # Parity DDGI budgets (DDGINode.cpp:19-20 slider territory):
            # 2,048-probe grid, 256 rays/probe, 1,024 probes updated/frame.
            from arkoserenderer.ops.ddgi import ProbeGridConfig

            center, radius = scene.bounding_sphere()
            kw = dict(kw)
            kw["ddgi"] = ProbeGridConfig.fit_bounds(
                center, radius, dims=(16, 8, 16),
                rays_per_probe=256, probes_per_frame=1024,
            )
        renderer = Renderer(scene, camera, cfg, **kw)
    elif kind == "flagship":
        from arkoserenderer.assets.procedural import build_flagship_scene
        from arkoserenderer.ops.ddgi import ProbeGridConfig

        n_inst = 256 if small else 4096
        n_mat = 64 if small else 256
        n_tex = 16 if small else 64
        scene, camera = build_flagship_scene(
            n_instances=n_inst, n_materials=n_mat, n_textures=n_tex,
            viewport=(cfg.width, cfg.height),
        )
        kw = dict(kw)
        if kw.get("ddgi") == "flagship":
            center, radius = scene.bounding_sphere()
            dims = (8, 4, 8) if small else (16, 8, 16)
            kw["ddgi"] = ProbeGridConfig.fit_bounds(
                center, radius, dims=dims,
                rays_per_probe=128 if small else 256,
                probes_per_frame=64 if small else 1024,
            )
        renderer = Renderer(scene, camera, cfg, **kw)
    elif kind == "helmet":
        from arkoserenderer.assets.sample_scenes import build_helmet_scene
        from arkoserenderer.ops.ddgi import ProbeGridConfig

        n_grid = 3 if small else 6
        scene, camera = build_helmet_scene(
            n_grid=n_grid, viewport=(cfg.width, cfg.height),
            max_texture_size=128 if small else 1024,
        )
        kw = dict(kw)
        if kw.get("ddgi") == "helmet":
            center, radius = scene.bounding_sphere()
            dims = (8, 4, 8) if small else (16, 4, 16)
            kw["ddgi"] = ProbeGridConfig.fit_bounds(
                center, radius, dims=dims,
                rays_per_probe=128 if small else 256,
                probes_per_frame=64 if small else 1024,
            )
        renderer = Renderer(scene, camera, cfg, **kw)
    elif kind == "bindless":
        from arkoserenderer.assets.procedural import build_bindless_scene

        n_mat = 64 if small else 256
        n_tex = 16 if small else 64
        scene, camera = build_bindless_scene(
            n_materials=n_mat, n_textures=n_tex,
            viewport=(cfg.width, cfg.height),
        )
        renderer = Renderer(scene, camera, cfg, **kw)
    else:
        from arkoserenderer.assets.procedural import build_test_scene

        scene, camera = build_test_scene(viewport=(cfg.width, cfg.height))
        renderer = Renderer(scene, camera, cfg, **kw)

    res = f"{cfg.width}x{cfg.height}" if kind != "test_upscaled" else "1920x1080"
    return renderer, desc, res, _scene_label(kind)


def device_info() -> dict:
    """platform / device_kind / count of the devices JAX runs on."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def run_config(name: str, small: bool, iters: int, timings: bool,
               timings_deadline: float | None = None) -> dict:
    import jax

    dev = device_info()
    if not small and dev["platform"] != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {dev['platform']}); "
                         "only --small runs elsewhere")
    renderer, desc, res, label = build_renderer(name, small)
    camera = renderer.camera
    # Warm through one full camera-jitter period (16) + slack so the timed
    # frames measure steady state: every frame in the first period misses
    # the device CameraState cache (a fresh jitter slot each), which is
    # cache-building, not steady-state cost. The reference's own metric is
    # a 60-sample rolling average for the same reason (AvgElapsedTimer.h).
    warm = 18
    for _ in range(warm):
        jax.block_until_ready(renderer.render_frame())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = renderer.render_frame()
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / iters * 1e3

    line = {
        "metric": (f"ms/frame {res} {desc}, {label}, single "
                   f"chip, vs 16.667ms budget"),
        "value": round(ms, 3),
        "unit": "ms",
        # budget (the reference's implied 16.667 ms, RenderPipeline.cpp:82)
        # divided by measured ms — NOT a measured reference number (the
        # reference publishes none; BASELINE.md).
        "vs_baseline": round(BUDGET_MS / ms, 4),
        "device": dev,
    }
    print(json.dumps(line), flush=True)
    if timings:
        from arkoserenderer.utils.timing import time_passes

        t = time_passes(
            renderer.pipeline, renderer.state, renderer.scene_arrays,
            camera.state(renderer.frame_index), iters=3,
            deadline_s=timings_deadline,
            emit=lambda s: print(s, flush=True),
        )
        # Machine-readable per-pass table (no "value" key on purpose: the
        # driver's line parser must keep picking the ms/frame lines).
        print(json.dumps({
            "metric": f"per-pass ms table ({name} pipeline), deadline-aware",
            "unit": "ms",
            "passes": {k: round(v, 3) for k, v in t.items()},
            "device": dev,
        }), flush=True)
    return line


def _run_config_subprocess(name: str, iters: int, small: bool, timings: bool,
                           timeout_s: float,
                           timings_deadline: float | None = None):
    """Run config(s) in a fresh subprocess; return (json_line|None, tail).

    ``name`` may be a comma-joined group ("rt,full_post,bindless"): the
    child runs each config sequentially in ONE process, sharing its
    start-up. Returns the LAST value-bearing JSON line; use
    _parse_value_lines on captured stdout for the full per-config set.
    The parent waits for each child, so only one process uses the card.
    """
    import subprocess
    import sys

    cmd = [sys.executable, __file__, "--config", name, "--iters", str(iters)]
    if small:
        cmd.append("--small")
    if timings:
        cmd.append("--timings")
        if timings_deadline is not None:
            cmd += ["--timings-deadline", str(int(timings_deadline))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s)
        stdout = proc.stdout or ""
        stderr = proc.stderr or ""
    except subprocess.TimeoutExpired as e:
        # Keep whatever the child printed before the kill (the incremental
        # per-pass rows especially).
        stdout = e.stdout or ""
        if isinstance(stdout, bytes):
            stdout = stdout.decode(errors="replace")
        if stdout:
            print(stdout, end="", flush=True)
        return None, f"timeout after {timeout_s:.0f}s: {e}", stdout
    if stdout:
        print(stdout, end="", flush=True)
    line = None
    for cand in _parse_value_lines(stdout).values():
        line = cand
    tail = stderr[-2000:]
    return line, tail, stdout


def _parse_value_lines(stdout: str) -> dict[str, dict]:
    """{config description -> its ms/frame JSON line} from child stdout."""
    out: dict[str, dict] = {}
    for ln in stdout.splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                cand = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(cand, dict) and "value" in cand:
                out[cand.get("metric", ln)] = cand
    return out


def _driver_mode(args) -> None:
    """Default (no --config) invocation: what the driver runs every round.

    Resilience contract: the headline forward number is
    captured FIRST with retry-with-backoff across fresh subprocesses, then
    re-measured in extra sessions for a median whenever budget allows; the
    secondary configs run CHEAPEST-FIRST with budget-aware per-config
    timeouts (r4's expensive-first flat-420s ordering let one timeout starve
    everything behind it); the per-pass ms table runs as its own final
    reserved budget item (deadline-aware, partial-table-safe); and the
    flagship JSON line is re-printed LAST so both first-JSON-line and
    last-JSON-line parsers see it. A parseable error line is emitted even on
    terminal failure. The persistent XLA compile cache (see
    _enable_compile_cache) makes repeat sessions compile-free.
    """
    import os

    budget_s = float(os.environ.get("ARK_BENCH_BUDGET_S", "900"))
    per_cfg_timeout = float(os.environ.get("ARK_BENCH_CFG_TIMEOUT_S", "420"))
    # Reserved tail slice for the per-pass timings item so secondary configs
    # cannot starve it (BASELINE config 5's table MUST land).
    # Warm-cache showcase --timings measures ~120 s end-to-end (session init
    # + cached compiles + table); 180 s covers it with margin without
    # starving the secondary configs the way 240 s would.
    reserve_s = float(os.environ.get("ARK_BENCH_TIMINGS_RESERVE_S", "180"))
    t0 = time.time()

    def remaining() -> float:
        return budget_s - (time.time() - t0)

    flagship = "forward"
    flagship_line = None
    last_tail = ""
    for attempt, backoff in enumerate((0, 10, 30)):
        if backoff:
            print(f"# flagship attempt {attempt} failed; retrying in {backoff}s",
                  flush=True)
            time.sleep(backoff)
        flagship_line, last_tail, _ = _run_config_subprocess(
            flagship, args.iters, args.small, False, per_cfg_timeout)
        if flagship_line is not None:
            break
    if flagship_line is None:
        print(json.dumps({
            "metric": f"ms/frame 1920x1080 {CONFIGS[flagship][2]}, single chip",
            "value": -1.0, "unit": "ms", "vs_baseline": 0.0,
            "error": last_tail[-600:] or "no JSON line from flagship subprocess",
        }), flush=True)
        return

    # Secondary configs FIRST, in GROUPS that share one process start-up
    # (cheapest-first, budget-aware slices). Coverage beats precision: all config lines land before
    # any budget goes to flagship median re-runs (a cold-cache round once
    # spent 450 s on medians and starved rt down to a 90 s slice — never
    # again). showcase is NOT here: the reserved timings item below runs it
    # and prints its ms/frame line before the table. A config whose line is
    # missing after its group run (crash/timeout mid-group) is retried
    # individually with whatever budget remains.
    groups = [
        ["rt", "full_post", "bindless", "forward_upscaled"],
        ["ddgi", "meshlet", "stress"],
        ["helmet", "flagship"],
    ]
    missing: list[str] = []
    n_left = sum(len(g) for g in groups)
    for group in groups:
        avail = remaining() - reserve_s
        if avail < 45:
            print(f"# budget exhausted; skipped group {group}", flush=True)
            missing.extend(group)
            n_left -= len(group)
            continue
        slice_s = min(per_cfg_timeout * len(group),
                      max(60.0 * len(group), avail * len(group) / n_left))
        _, _tail, stdout = _run_config_subprocess(
            ",".join(group), args.iters, args.small, False,
            min(slice_s, avail))
        landed = _parse_value_lines(stdout)
        for name in group:
            if not any(CONFIGS[name][2] in k for k in landed):
                missing.append(name)
        n_left -= len(group)
    for name in list(missing):
        avail = remaining() - reserve_s
        if avail < 45:
            print(f"# budget exhausted; {name} not retried", flush=True)
            continue
        line, tail, _ = _run_config_subprocess(
            name, args.iters, args.small, False,
            min(per_cfg_timeout, avail))
        if line is None:
            print(f"# config {name} failed: {tail[-300:]}", flush=True)

    # Multi-session median: extra fresh-process runs whenever the budget
    # has room for one.
    values = [flagship_line["value"]]
    while len(values) < 3 and remaining() - reserve_s > 90:
        extra, _, _ = _run_config_subprocess(
            flagship, args.iters, args.small, False,
            min(per_cfg_timeout, remaining() - reserve_s))
        if extra is None:
            break
        values.append(extra["value"])
    values.sort()
    med = values[len(values) // 2] if len(values) % 2 else round(
        0.5 * (values[len(values) // 2 - 1] + values[len(values) // 2]), 3)
    flagship_line["value"] = med
    flagship_line["vs_baseline"] = round(BUDGET_MS / med, 4)
    flagship_line["sessions"] = len(values)

    # Per-pass ms table as its own final budget item (r4 #1c): the showcase
    # pipeline's per-node timing display (VulkanBackend.cpp:1831-1935 /
    # BASELINE.md config 5), deadline-aware so a partial table still lands.
    table_budget = max(90.0, remaining() - 30.0)
    _run_config_subprocess(
        "showcase", 3, args.small, True, table_budget + 45.0,
        timings_deadline=table_budget - 30.0)

    # Re-print the flagship line last (see docstring).
    print(json.dumps(flagship_line), flush=True)


def main() -> None:
    from arkoserenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--config", default=None,
                    help="config name, or a comma-joined group "
                         "('rt,full_post') run sequentially in this process; "
                         f"one of {list(CONFIGS)}")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--timings", action="store_true")
    ap.add_argument("--timings-deadline", type=float, default=None,
                    help="wall-clock budget (s) for the per-pass table; a "
                         "partial table is emitted when it expires")
    args = ap.parse_args()

    if args.all:
        for name in CONFIGS:
            line, tail, _ = _run_config_subprocess(
                name, args.iters, args.small, args.timings, 600.0,
                timings_deadline=args.timings_deadline)
            if line is None:
                print(f"# config {name} failed: {tail[-300:]}", flush=True)
        return

    if args.config is None:
        _driver_mode(args)
        return

    names = [n.strip() for n in args.config.split(",") if n.strip()]
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown config(s) {unknown}; choose from {list(CONFIGS)}")
    for name in names:
        run_config(name, args.small, args.iters, args.timings,
                   timings_deadline=args.timings_deadline)


if __name__ == "__main__":
    main()
