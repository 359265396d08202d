"""A/B on one card: the Triton stage-4 raster against the plain XLA walk.

Times ``ops/raster_pallas.rasterize_tiles_pallas`` and
``ops/raster.rasterize_tiles_reference`` on the flagship scene's triangles
at 1920x1080 and on its 8192^2 sun shadow map, then whole ``forward`` and
``flagship`` frames with each implementation swapped in, in the order
kernel, reference, reference, kernel. Both arms run in this one process
on the same card. Needs a GPU; prints one JSON line per measurement.

    python tools/profiling/ab_raster.py [--frames 10] [--skip-flagship]
        [--stages-only] [--warps 2,4,8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from arkoserenderer.ops import raster  # noqa: E402
from arkoserenderer.ops.raster_pallas import (  # noqa: E402
    NUM_WARPS,
    rasterize_tiles_pallas,
)


def _timed(fn, *args, iters: int = 5) -> float:
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def stage_ab(width: int, height: int, view_proj, scene_arrays, rcfg,
             depth_only: bool, label: str, warps=(NUM_WARPS,)) -> dict:
    """Setup + binning once, then each stage-4 implementation alone; the
    kernel once for each ``num_warps`` in ``warps``."""
    from arkoserenderer.rendering.passes.geometry import transform_vertices_clip

    @jax.jit
    def prep(sa, vp):
        clip = transform_vertices_clip(sa, vp, sa.positions)
        setup = raster.setup_triangles(clip, sa.indices, sa.tri_valid,
                                       width, height,
                                       cull_backfaces=not depth_only)
        return setup, raster.bin_triangles(setup, width, height, rcfg)

    setup, bins = prep(scene_arrays, view_proj)
    ref = jax.jit(lambda s, b: raster.rasterize_tiles_reference(
        s, b, width, height, rcfg, depth_only=depth_only))
    kers = {w: jax.jit(lambda s, b, w=w: rasterize_tiles_pallas(
        s, b, width, height, rcfg, depth_only=depth_only, num_warps=w))
        for w in warps}
    ker = kers[warps[0]]
    t_k1 = {w: _timed(k, setup, bins) for w, k in kers.items()}
    t_r1 = _timed(ref, setup, bins)
    t_r2 = _timed(ref, setup, bins)
    t_k2 = {w: _timed(k, setup, bins) for w, k in kers.items()}
    vr, dr = (np.asarray(a) for a in ref(setup, bins))
    vk, dk = (np.asarray(a) for a in ker(setup, bins))
    line = {
        "stage": label, "size": f"{width}x{height}",
        "kernel_ms_by_num_warps": {w: [round(t_k1[w], 4), round(t_k2[w], 4)]
                                   for w in warps},
        "reference_ms": [round(t_r1, 4), round(t_r2, 4)],
        "max_tile_count": int(np.asarray(bins.counts).max()),
        "overflow": int(bins.overflow),
        "depth_max_abs_diff": float(np.abs(dr - dk).max()),
        "coverage_mismatch_px": int(((dr > 0) != (dk > 0)).sum()),
        "id_mismatch_frac": float((vr != vk).mean()),
    }
    print(json.dumps(line), flush=True)
    return line


def frame_ab(name: str, frames: int, small: bool = False):
    """Whole frames of a bench config with each stage-4 implementation.
    Returns the result line and the two warm renderers by arm."""
    sys.path.insert(0, os.getcwd())
    import bench

    arms = {}
    dispatcher = raster.rasterize_tiles
    compile_s = {}
    for arm in ("kernel", "reference"):
        raster.rasterize_tiles = (dispatcher if arm == "kernel"
                                  else raster.rasterize_tiles_reference)
        try:
            r = bench.build_renderer(name, small)[0]
            t0 = time.perf_counter()
            jax.block_until_ready(r.render_frame())
            compile_s[arm] = round(time.perf_counter() - t0, 2)
        finally:
            raster.rasterize_tiles = dispatcher
        for _ in range(3):
            jax.block_until_ready(r.render_frame())
        arms[arm] = r
    ms = {"kernel": [], "reference": []}
    for arm in ("kernel", "reference", "reference", "kernel"):
        r = arms[arm]
        t0 = time.perf_counter()
        for _ in range(frames):
            out = r.render_frame()
        jax.block_until_ready(out)
        ms[arm].append(round((time.perf_counter() - t0) / frames * 1e3, 4))
    line = {"frame": name, "frames": frames, "kernel_ms": ms["kernel"],
            "reference_ms": ms["reference"], "first_call_s": compile_s}
    print(json.dumps(line), flush=True)
    return line, arms


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--skip-flagship", action="store_true")
    ap.add_argument("--stages-only", action="store_true",
                    help="time the raster stage alone, no whole frames")
    ap.add_argument("--warps", default=str(NUM_WARPS),
                    help="comma-separated num_warps values for the kernel")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    from arkoserenderer.assets.procedural import build_flagship_scene
    from arkoserenderer.core.types import RasterConfig

    rcfg = RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256,
                        bin_chunk=2048)
    scene, cam = build_flagship_scene(viewport=(1920, 1080))
    sa = scene.build()
    warps = tuple(int(w) for w in args.warps.split(","))
    stage_ab(1920, 1080, cam.state(0).view_proj, sa, rcfg, False,
             "primary view, flagship scene", warps)
    stage_ab(8192, 8192, sa.lights.sun_view_proj, sa, rcfg, True,
             "sun shadow map, flagship scene", warps)
    if args.stages_only:
        return
    frame_ab("forward", args.frames)
    if not args.skip_flagship:
        frame_ab("flagship", args.frames)


if __name__ == "__main__":
    main()
