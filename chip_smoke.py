"""Smoke test of the renderer on one GPU: every phase of the main path at
full size, each kernel against its plain reference, and the golden frames.

    python chip_smoke.py            # one card; ends with the JSON result line
    python chip_smoke.py --four     # only the four-card sharded frame

One process owns the card(s); no child process opens them. Every phase is a
function the CPU tests import and run at tiny sizes with ``expect="cpu"``.
Any failure propagates and the exit code is non-zero; the last line of
standard output is printed only when every phase passed:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Timings printed here are informational, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from arkoserenderer.core.types import VIS_NONE, RasterConfig  # noqa: E402
from arkoserenderer.ops import raster  # noqa: E402

# The bench's full-size raster configuration (bench._cfg).
RCFG = RasterConfig(tile_h=8, tile_w=128, max_tris_per_tile=256, bin_chunk=2048)
# Kernel vs reference: depth within DEPTH_ATOL, identical coverage, ids may
# differ only at exact depth ties (see compare_raster for edge ties).
DEPTH_ATOL = 1e-6
MAX_ID_MISMATCH = 0.001
MAX_TIE_FRAC = 1e-4
# Float32 products (precision HIGHEST) against float64 NumPy: error relative
# to the largest reference magnitude. Float32 rounding is ~1e-7; TF32's
# 10-bit mantissa gives ~1e-3 and fails.
GEOMETRY_RTOL = 1e-5
# Sharded against single-card frames (tests/test_sharding.py's criterion).
SHARD_ATOL = 1e-5
SHARD_MAX_FRAC = 1e-3

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Device


def phase_device(expect: str = "gpu", min_count: int = 1) -> dict:
    """What JAX runs on; the card's name and power limit from nvidia-smi.
    Raises unless the platform is ``expect`` with ``min_count`` devices."""
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"jax {jax.__version__}: platform={info['platform']} "
        f"kind={info['kind']} count={info['count']}")
    _check(info["platform"] == expect,
           f"expected platform {expect!r}, JAX found {info['platform']!r}")
    _check(info["count"] >= min_count,
           f"need {min_count} devices, JAX found {info['count']}")
    if expect == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        print(f"card: {smi}", flush=True)
    return info


# ---------------------------------------------------------------------------
# Kernels at real widths


def _flagship_scene(width: int, height: int, n_instances: int):
    from arkoserenderer.assets.procedural import build_flagship_scene

    scene, cam = build_flagship_scene(
        n_instances=n_instances, n_materials=min(256, n_instances),
        n_textures=min(64, n_instances), viewport=(width, height),
    )
    return scene, cam, scene.build()


def _setup_and_bins(sa, view_proj, width, height, rcfg, cull, w_eps, valid=None):
    from arkoserenderer.rendering.passes.geometry import transform_vertices_clip

    @jax.jit
    def prep(sa, vp, valid):
        clip = transform_vertices_clip(sa, vp, sa.positions)
        setup = raster.setup_triangles(clip, sa.indices, valid, width, height,
                                       cull_backfaces=cull, w_eps=w_eps)
        return clip, setup, raster.bin_triangles(setup, width, height, rcfg)

    return prep(sa, view_proj, sa.tri_valid if valid is None else valid)


def _stage4(setup, bins, width, height, rcfg, depth_only):
    """``raster.rasterize_tiles`` on the device the inputs live on: the
    kernel on the GPU, the XLA reference on the CPU."""
    fn = jax.jit(lambda s, b: raster.rasterize_tiles(
        s, b, width, height, rcfg, depth_only=depth_only))
    t0 = time.perf_counter()
    vis, depth = jax.block_until_ready(fn(setup, bins))
    return np.asarray(vis), np.asarray(depth), time.perf_counter() - t0


def tie_break(setup, bins, rcfg: RasterConfig, width: int, pixels) -> tuple:
    """Stage 4 at the given (y, x) pixels in NumPy float32, where every
    product is rounded on its own (no fused multiply-add): (vis, depth)."""
    sxy = np.asarray(setup.screen_xy, np.float32)
    z = np.asarray(setup.z_ndc, np.float32)
    sorted_tris = np.asarray(bins.sorted_tris)
    starts, counts = np.asarray(bins.starts), np.asarray(bins.counts)
    glob = np.asarray(bins.global_tris)[:int(bins.global_count)]
    ntx = width // rcfg.tile_w
    vis_out, depth_out = [], []
    for y, x in pixels:
        t = (y // rcfg.tile_h) * ntx + x // rcfg.tile_w
        px, py = np.float32(x + 0.5), np.float32(y + 0.5)
        depth, vis = np.float32(0.0), VIS_NONE
        for tri in [*sorted_tris[starts[t]:starts[t] + counts[t]], *glob]:
            (x0, y0), (x1, y1), (x2, y2) = sxy[tri]
            e = [(b1 - a1) * (px - a0) - (b0 - a0) * (py - a1)
                 for (a0, a1), (b0, b1) in (((x1, y1), (x2, y2)),
                                            ((x2, y2), (x0, y0)),
                                            ((x0, y0), (x1, y1)))]
            area2 = (y1 - y0) * (x2 - x0) - (x1 - x0) * (y2 - y0)
            inv = (np.float32(1.0) / area2 if abs(area2) > 1e-12
                   else np.float32(0.0))
            lam = [ei * inv for ei in e]
            d = lam[0] * z[tri, 0] + lam[1] * z[tri, 1] + lam[2] * z[tri, 2]
            if min(lam) >= 0 and d > depth:
                depth, vis = d, int(tri)
        vis_out.append(vis)
        depth_out.append(depth)
    return np.array(vis_out), np.array(depth_out, np.float32)


def compare_raster(vis, depth, vis_ref, depth_ref, what: str,
                   tie=None) -> dict:
    """Depth within DEPTH_ATOL, identical coverage, ids equal but for ties.

    ``tie`` = (setup, bins, rcfg, width): pixels where the two differ (at
    most MAX_TIE_FRAC of them) are decided by ``tie_break``. XLA may fuse
    products into multiply-adds, so a pixel centre that lies on an edge can
    fall on either side, and depth can move by a few units in the last
    place; the kernel rounds every op on its own and must then agree with
    NumPy float32 exactly."""
    if vis_ref is not None:
        cov, cov_ref = vis != VIS_NONE, vis_ref != VIS_NONE
    else:  # depth only
        cov, cov_ref = depth > 0, depth_ref > 0
    differ = (cov != cov_ref) | (np.abs(depth - depth_ref) > DEPTH_ATOL)
    decided = 0
    same = np.ones_like(cov)
    if tie is not None and differ.any():
        pixels = np.argwhere(differ)
        _check(len(pixels) <= MAX_TIE_FRAC * differ.size,
               f"{what}: {len(pixels)} pixels differ")
        vis_t, depth_t = tie_break(*tie, pixels)
        got_vis = vis[differ] if vis_ref is not None else np.where(
            depth[differ] > 0, 0, VIS_NONE)
        want_vis = vis_t if vis_ref is not None else np.where(
            depth_t > 0, 0, VIS_NONE)
        _check(np.array_equal(got_vis != VIS_NONE, want_vis != VIS_NONE)
               and np.array_equal(depth[differ], depth_t),
               f"{what}: kernel disagrees with the NumPy tie-break")
        decided = len(pixels)
        same = ~differ
    stats = {
        "depth_max_abs_diff": float(np.abs(depth - depth_ref)[same].max()),
        "coverage_mismatch_px": int((cov != cov_ref)[same].sum()),
        "id_mismatch_frac": (float((vis != vis_ref)[same].mean())
                             if vis_ref is not None else 0.0),
        "covered_px": int(cov.sum()),
        "decided_by_numpy_px": decided,
    }
    log(f"{what}: {stats}")
    _check(stats["depth_max_abs_diff"] <= DEPTH_ATOL, f"{what}: depth differs")
    _check(stats["coverage_mismatch_px"] == 0, f"{what}: coverage differs")
    _check(stats["id_mismatch_frac"] <= MAX_ID_MISMATCH, f"{what}: ids differ")
    _check(stats["covered_px"] > 0, f"{what}: nothing covered")
    return stats


def phase_raster(width: int = 1920, height: int = 1080, n_instances: int = 4096,
                 rcfg: RasterConfig = RCFG) -> dict:
    """Visibility raster of the flagship scene's triangles on the default
    device against ``rasterize_tiles`` on the CPU, then of the test scene
    against the brute-force NumPy rasterizer."""
    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.ops.raster_reference import rasterize_numpy

    cpu = jax.devices("cpu")[0]
    scene, cam, sa = _flagship_scene(width, height, n_instances)
    cs = cam.state(0)
    _, setup, bins = _setup_and_bins(sa, cs.view_proj, width, height, rcfg,
                                     True, cs.near)
    vis, depth, dt = _stage4(setup, bins, width, height, rcfg, False)
    log(f"raster {width}x{height}, {sa.indices.shape[0]} triangles: first call "
        f"{dt:.2f} s, bin overflow {int(bins.overflow)}")
    vis_c, depth_c, dt_c = _stage4(*jax.device_put((setup, bins), cpu),
                                   width, height, rcfg, False)
    log(f"reference on the CPU: {dt_c:.2f} s")
    out = {"flagship": compare_raster(vis, depth, vis_c, depth_c,
                                      "raster vs CPU reference, flagship",
                                      (setup, bins, rcfg, width))}

    # Brute-force reference: triangles wholly in front of the near plane
    # (the NumPy rasterizer does not clip), no bin overflow.
    scene, cam = build_test_scene(viewport=(width, height))
    sa = scene.build()
    cs = cam.state(0)
    big = RasterConfig(tile_h=rcfg.tile_h, tile_w=rcfg.tile_w,
                       max_tris_per_tile=1024, bin_chunk=rcfg.bin_chunk)
    clip, _, _ = _setup_and_bins(sa, cs.view_proj, width, height, big, True,
                                 cs.near)
    clip_np = np.asarray(clip)
    idx = np.asarray(sa.indices)
    front = np.asarray(sa.tri_valid) & (clip_np[idx][..., 3] > float(cs.near)).all(-1)
    _, setup, bins = _setup_and_bins(sa, cs.view_proj, width, height, big,
                                     True, cs.near, jnp.asarray(front))
    _check(int(bins.overflow) == 0, "test scene overflowed its bins")
    vis, depth, _ = _stage4(setup, bins, width, height, big, False)
    t0 = time.perf_counter()
    vis_n, depth_n = rasterize_numpy(clip_np, idx, front, width, height,
                                     cull_backfaces=True, w_eps=float(cs.near))
    log(f"NumPy reference, {int(front.sum())} triangles: "
        f"{time.perf_counter() - t0:.1f} s")
    out["test_scene"] = compare_raster(vis, depth, vis_n, depth_n,
                                       "raster vs NumPy reference, test scene")
    return out


def phase_shadow_raster(size: int = 8192, n_instances: int = 4096,
                        rcfg: RasterConfig = RCFG) -> dict:
    """Depth-only sun shadow raster of the flagship scene against
    ``rasterize_tiles`` on the CPU."""
    cpu = jax.devices("cpu")[0]
    _, _, sa = _flagship_scene(256, 256, n_instances)
    _, setup, bins = _setup_and_bins(sa, sa.lights.sun_view_proj, size, size,
                                     rcfg, False, 1e-4)
    vis, depth, dt = _stage4(setup, bins, size, size, rcfg, True)
    log(f"shadow raster {size}^2: first call {dt:.2f} s, "
        f"bin overflow {int(bins.overflow)}")
    _, depth_c, dt_c = _stage4(*jax.device_put((setup, bins), cpu), size, size,
                               rcfg, True)
    log(f"reference on the CPU: {dt_c:.2f} s")
    return compare_raster(vis, depth, None, depth_c,
                          f"shadow raster {size}^2 vs CPU reference",
                          (setup, bins, rcfg, size))


# ---------------------------------------------------------------------------
# Float32 geometry against float64


def _rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def phase_precision(width: int = 1920, height: int = 1080,
                    n_instances: int = 4096, n_probes: int = 1024,
                    rays: int = 256) -> dict:
    """Each geometric float32 product at flagship sizes against float64
    NumPy (tolerance GEOMETRY_RTOL, precision HIGHEST), plus the DDGI
    probe-estimate sums at both precisions (informational: the choice of
    ``ddgi.WEIGHT_PRECISION``)."""
    from arkoserenderer.core import mathx as mx
    from arkoserenderer.ops import ddgi
    from arkoserenderer.ops.bvh import Hit, _affine_inverse
    from arkoserenderer.ops.rt import surface_at_hits
    from arkoserenderer.ops.skinning import skin_vertices
    from arkoserenderer.rendering.passes.geometry import transform_vertices_clip

    rng = np.random.default_rng(0)
    scene, cam, sa = _flagship_scene(width, height, n_instances)
    cs = cam.state(0)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    world = f64(sa.world)
    vp64 = f64(cs.proj_from_view) @ f64(cs.view_from_world)
    pos = f64(sa.positions)
    vi = np.asarray(sa.vertex_instance)
    errs = {}

    # Per-drawable MVP and the vertex pool in clip space.
    clip = jax.jit(transform_vertices_clip)(sa, cs.view_proj, sa.positions)
    mvp = vp64[None] @ world
    ref = np.einsum("vij,vj->vi", mvp[vi], np.concatenate(
        [pos, np.ones((len(pos), 1))], -1))
    errs["vertex clip (view_proj @ world @ p)"] = _rel_err(clip, ref)

    # Unprojection (N, 4) @ (4, 4)^T: world from depth, sky and camera rays.
    n = width * height
    ndc = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(1e-3, 1, (n, 1)),
                          np.ones((n, 1))], -1).astype(np.float32)
    inv_vp = np.linalg.inv(vp64).astype(np.float32)
    got = jax.jit(lambda a, b: mx.matmul(a, b.T))(ndc, inv_vp)
    errs["unprojection (ndc @ inv_vp^T)"] = _rel_err(got, f64(ndc) @ f64(inv_vp).T)

    # Linear-blend skinning of the whole vertex pool.
    v = len(pos)
    j = 64
    pal = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
    pal[:, :3, :3] += rng.normal(0, 0.2, (j, 3, 3)).astype(np.float32)
    pal[:, :3, 3] = rng.normal(0, 5, (j, 3)).astype(np.float32)
    joints = rng.integers(0, j, (v, 4)).astype(np.int32)
    wts = rng.random((v, 4)).astype(np.float32)
    wts /= wts.sum(-1, keepdims=True)
    nrm = np.asarray(sa.normals)
    tan = np.asarray(sa.tangents)
    p_new, _, _ = jax.jit(skin_vertices)(sa.positions, nrm, tan, joints, wts, pal)
    blend = np.einsum("vk,vkab->vab", f64(wts), f64(pal)[joints])
    ref = np.einsum("vab,vb->va", blend[:, :3, :3], pos) + blend[:, :3, 3]
    errs["skinned positions"] = _rel_err(p_new, ref)

    # Ray-hit surface reconstruction (RT passes, DDGI).
    r = width * height // 4
    t_count = sa.indices.shape[0]
    tri = rng.integers(0, int(np.asarray(sa.tri_valid).sum()), r).astype(np.int32)
    u = rng.random(r).astype(np.float32) * 0.5
    vv = rng.random(r).astype(np.float32) * 0.5
    hit = Hit(t=jnp.ones(r), tri=jnp.asarray(tri), u=jnp.asarray(u),
              v=jnp.asarray(vv), hit=jnp.ones(r, bool))
    wp, _, _, _ = jax.jit(surface_at_hits)(sa, hit)
    corners = np.asarray(sa.indices)[tri % t_count]
    bary = np.stack([1 - f64(u) - f64(vv), f64(u), f64(vv)], -1)
    obj = np.einsum("rk,rkc->rc", bary, pos[corners])
    w_m = world[np.asarray(sa.tri_instance)[tri]]
    ref = np.einsum("rij,rj->ri", w_m[:, :3, :3], obj) + w_m[:, :3, 3]
    errs["ray-hit world positions"] = _rel_err(wp, ref)

    # Instance world-to-object transforms (BVH refit).
    o2w = np.asarray(sa.world)[:, :3, :4]
    inv = jax.jit(_affine_inverse)(o2w)
    full = np.concatenate([f64(o2w), np.tile([[[0, 0, 0, 1.0]]], (len(o2w), 1, 1))], 1)
    ok = np.abs(np.linalg.det(full[:, :3, :3])) > 1e-6
    errs["instance inverse transforms"] = _rel_err(
        np.asarray(inv)[ok], np.linalg.inv(full[ok])[:, :3, :4])

    for k, e in errs.items():
        log(f"precision HIGHEST, {k}: max rel err {e:.2e} (limit {GEOMETRY_RTOL:g})")
        _check(e <= GEOMETRY_RTOL, f"{k}: float32 error {e:.2e}")

    # DDGI probe estimates: (texels x rays) sums at both precisions.
    dirs = rng.normal(size=(rays, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rad = rng.random((n_probes, rays, 3)) * 10.0
    dist = rng.random((n_probes, rays)) * 8.0
    tex_i = f64(ddgi._texel_dirs(ddgi.IRRADIANCE_RES))
    tex_v = f64(ddgi._texel_dirs(ddgi.VISIBILITY_RES))
    d32 = dirs.astype(np.float32)
    w_i = np.maximum(tex_i @ f64(d32).T, 0.0)
    irr_ref = np.einsum("tr,nrc->ntc", w_i, f64(rad.astype(np.float32))) / \
        np.maximum(w_i.sum(1), 1e-4)[None, :, None]
    w_v = np.maximum(tex_v @ f64(d32).T, 0.0) ** 50.0
    mean_ref = np.einsum("tr,nr->nt", w_v, f64(dist.astype(np.float32))) / \
        np.maximum(w_v.sum(1), 1e-6)[None]
    ddgi_errs = {}
    for name, prec in (("DEFAULT", jax.lax.Precision.DEFAULT),
                       ("HIGHEST", jax.lax.Precision.HIGHEST)):
        irr, vis = jax.jit(lambda a, b, c, p=prec: ddgi.probe_estimates(a, b, c, p))(
            d32, rad.astype(np.float32), dist.astype(np.float32))
        ddgi_errs[name] = {
            "irradiance": _rel_err(np.asarray(irr).reshape(n_probes, -1, 3), irr_ref),
            "visibility_mean": _rel_err(np.asarray(vis)[..., 0].reshape(n_probes, -1),
                                        mean_ref),
        }
        log(f"DDGI probe estimates at {name}: max rel err {ddgi_errs[name]}")
    return {"geometry": errs, "ddgi": ddgi_errs}


# ---------------------------------------------------------------------------
# Main path


def _device_event_counts(trace_dir: str) -> dict:
    """Executions of while loops and conditionals, and device-to-host copies,
    in a profiler trace."""
    import glob

    counts: dict[str, int] = {}
    for path in glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True):
        for plane in jax.profiler.ProfileData.from_file(path).planes:
            for line in plane.lines:
                for ev in line.events:
                    name = ev.name
                    key = None
                    if name in ("While", "Conditional", "Case"):
                        key = f"{name} ({plane.name})"
                    elif name == "MemcpyD2H" and plane.name.startswith("/device"):
                        key = "MemcpyD2H (device)"
                    if key:
                        counts[key] = counts.get(key, 0) + 1
    return counts


def run_frames(renderer, frames: int, label: str, trace_frames: int = 2) -> dict:
    """First frame (compile), the compiled program's memory analysis,
    ``frames`` frames each checked finite with nonzero coverage, peak
    device memory, and a short trace counting loop and branch executions."""
    t0 = time.perf_counter()
    jax.block_until_ready(renderer.render_frame())
    compile_s = time.perf_counter() - t0
    mem = renderer.compiled_frame().memory_analysis()
    log(f"{label}: first frame (compile + run) {compile_s:.1f} s; "
        f"memory_analysis {mem}")
    finite, covered = [], []
    t0 = time.perf_counter()
    for _ in range(frames):
        out = renderer.render_frame()
        finite.append(jnp.isfinite(out).all())
        covered.append(jnp.any(renderer.state["Visibility"] != VIS_NONE))
    jax.block_until_ready((out, finite, covered))
    ms = (time.perf_counter() - t0) / frames * 1e3
    _check(all(bool(f) for f in finite), f"{label}: non-finite frame")
    _check(all(bool(c) for c in covered), f"{label}: frame with no coverage")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_trace") as d:
        jax.profiler.start_trace(d)
        for _ in range(trace_frames):
            out = renderer.render_frame()
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        events = {k: v / trace_frames for k, v in _device_event_counts(d).items()}
    log(f"{label}: {frames} frames finite and covered; {ms:.2f} ms/frame "
        f"(informational, not a benchmark); peak_bytes_in_use {peak}; "
        f"per frame in the trace: {events}")
    return {"compile_s": compile_s, "ms_per_frame": ms, "peak_bytes": peak,
            "per_frame_events": events}


def phase_main_path(small: bool = False, frames: int = 20,
                    configs=("forward", "flagship")) -> dict:
    """``frames`` frames of each bench config through ``Renderer``."""
    import bench

    out = {}
    for name in configs:
        renderer, desc, res, _ = bench.build_renderer(name, small)
        out[name] = run_frames(renderer, frames, f"{name} {res}")
        del renderer
    return out


def phase_apps(width: int = 1920, height: int = 1080, frames: int = 3,
               samples: int = 4) -> dict:
    """The showcase CLI in this process: a raster frame and a path-traced
    frame, each written as PNG and read back."""
    from arkoserenderer.apps import showcase
    from arkoserenderer.utils.imageio import load_image_rgba

    out = {}
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_png") as d:
        for label, extra in (("showcase", ["--frames", str(frames)]),
                             ("pathtracer", ["--pathtracer", "--samples",
                                             str(samples)])):
            path = os.path.join(d, f"{label}.png")
            t0 = time.perf_counter()
            showcase.main(["--width", str(width), "--height", str(height),
                           "--out", path, *extra])
            img = load_image_rgba(path)
            _check(img.shape == (height, width, 4), f"{label}: PNG shape")
            _check(img[..., :3].max() > 0, f"{label}: black frame")
            out[label] = {"seconds": time.perf_counter() - t0,
                          "mean": float(img[..., :3].mean())}
            log(f"showcase CLI {label} {width}x{height}: {out[label]}")
    return out


def phase_goldens(names=None) -> dict:
    """The golden cases on this device against ``tests/goldens``."""
    from arkoserenderer.utils import goldens

    out = {}
    for name, fn in goldens.render_cases().items():
        if names is not None and name not in names:
            continue
        mean_diff, frac_off = goldens.compare_to_golden(name, fn())
        out[name] = (mean_diff, frac_off)
        log(f"golden {name}: mean abs diff {mean_diff:.3f} (limit "
            f"{goldens.MAX_MEAN_ABS_DIFF}), {frac_off:.3%} off "
            f"(limit {goldens.MAX_FRAC_PIXELS_OFF:.1%})")
    bad = [k for k, (m, f) in out.items() if not goldens.within_limits(m, f)]
    _check(not bad, f"goldens outside their limits: {bad}")
    return out


# ---------------------------------------------------------------------------
# Four cards


def phase_four(width: int = 1920, height: int = 1152, n_devices: int = 4,
               shadow: int = 8192) -> dict:
    """``ShardedRenderer`` on ``n_devices`` cards (1-D pixel-band mesh)
    against the single-card ``Renderer`` at the same size, forward+SSAO and
    then RT+DDGI. The four first frames (single and sharded, both
    configurations) compile in parallel threads: compilation is most of
    this phase's time."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import bench
    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.parallel.sharded import ShardedRenderer

    cfg = dataclasses.replace(bench._cfg(False), width=width, height=height,
                              shadow_map_size=shadow)
    configs = (("forward+SSAO", dict(ssao=True)),
               ("RT+DDGI", dict(rt_shadows=True, rt_reflections=True,
                                ddgi=True)))

    def first_frame(make):
        t0 = time.perf_counter()
        r = make(*build_test_scene(viewport=(width, height)))
        img = np.array(jax.block_until_ready(r.render_frame()))
        return r, img, time.perf_counter() - t0

    jobs = []
    for _, kw in configs:
        jobs.append(lambda s, c, kw=kw: Renderer(s, c, cfg, **kw))
        jobs.append(lambda s, c, kw=kw: ShardedRenderer(
            s, c, cfg, n_devices=n_devices, **kw))
    with ThreadPoolExecutor(len(jobs)) as pool:
        firsts = list(pool.map(first_frame, jobs))
    out = {}
    for i, (label, _) in enumerate(configs):
        (_, a, _), (shr, b, first) = firsts[2 * i], firsts[2 * i + 1]
        t0 = time.perf_counter()
        for _ in range(5):
            o = shr.render_frame()
        jax.block_until_ready(o)
        ms = (time.perf_counter() - t0) / 5 * 1e3
        frac = float((np.abs(a - b) > SHARD_ATOL).mean())
        out[label] = {"frac_off": frac, "max_abs_diff": float(np.abs(a - b).max()),
                      "first_frame_s": first, "ms_per_frame": ms}
        log(f"{n_devices} cards {width}x{height} {label}: {out[label]} "
            f"(limit {SHARD_MAX_FRAC:g} of pixels off by > {SHARD_ATOL:g}; "
            "ms informational)")
        _check(np.isfinite(b).all(), f"{label}: non-finite sharded frame")
        _check(frac < SHARD_MAX_FRAC, f"{label}: sharded frame differs")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    from arkoserenderer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.four:
        info = phase_device("gpu", min_count=4)
        phase_four()
    else:
        info = phase_device("gpu")
        for phase in (phase_raster, phase_shadow_raster, phase_precision,
                      phase_main_path, phase_apps, phase_goldens):
            t0 = time.perf_counter()
            phase()
            log(f"{phase.__name__} passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
