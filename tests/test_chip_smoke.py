"""chip_smoke.py's phases at tiny sizes on the CPU (platform check set to
"cpu"), and its refusal to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from arkoserenderer.core.types import RasterConfig  # noqa: E402

SMALL = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256, bin_chunk=512)


def test_device_phase_fails_without_a_gpu():
    with pytest.raises(AssertionError, match="expected platform 'gpu'"):
        chip_smoke.phase_device()


def test_device_phase_reports_the_devices():
    info = chip_smoke.phase_device("cpu")
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    with pytest.raises(AssertionError, match="need 64 devices"):
        chip_smoke.phase_device("cpu", min_count=64)


def test_compare_raster_flags_each_kind_of_difference():
    vis = np.array([[0, 1], [-1, 2]], np.int32)
    depth = np.array([[0.5, 0.4], [0.0, 0.3]], np.float32)
    chip_smoke.compare_raster(vis, depth, vis.copy(), depth.copy(), "same")
    with pytest.raises(AssertionError, match="depth"):
        chip_smoke.compare_raster(vis, depth + 1e-3 * (depth > 0), vis, depth, "d")
    cov = vis.copy()
    cov[1, 0] = 3
    with pytest.raises(AssertionError, match="coverage"):
        chip_smoke.compare_raster(cov, depth, vis, depth, "c")
    ids = vis.copy()
    ids[0, 0] = 2
    with pytest.raises(AssertionError, match="ids"):
        chip_smoke.compare_raster(ids, depth, vis, depth, "i")


def test_tie_break_matches_the_reference_raster(rng):
    """The per-pixel NumPy stage 4 agrees with rasterize_tiles_reference."""
    import jax.numpy as jnp

    from arkoserenderer.core import mathx as mx
    from arkoserenderer.ops import raster

    w = h = 32
    cfg = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64)
    verts = np.concatenate([rng.uniform(-2, 2, (90, 2)),
                            rng.uniform(-8, -3, (90, 1))], -1).astype(np.float32)
    proj = mx.perspective_reverse_z(np.radians(70.0), 1.0, 0.1, 100.0)
    clip = mx.transform_points_h(proj, jnp.asarray(verts))
    idx = jnp.arange(90, dtype=jnp.int32).reshape(30, 3)
    setup = raster.setup_triangles(clip, idx, jnp.ones(30, bool), w, h,
                                   cull_backfaces=False)
    bins = raster.bin_triangles(setup, w, h, cfg)
    vis, depth = raster.rasterize_tiles_reference(setup, bins, w, h, cfg)
    pixels = np.argwhere(np.ones((h, w), bool))
    vis_t, depth_t = chip_smoke.tie_break(setup, bins, cfg, w, pixels)
    np.testing.assert_array_equal(vis_t.reshape(h, w), np.asarray(vis))
    np.testing.assert_allclose(depth_t.reshape(h, w), np.asarray(depth), atol=1e-6)


def test_compare_raster_lets_numpy_decide_edge_ties(monkeypatch):
    """A pixel that only the reference covers is accepted when the NumPy
    tie-break leaves it uncovered too, and refused when it covers it."""
    monkeypatch.setattr(chip_smoke, "MAX_TIE_FRAC", 0.01)
    import jax.numpy as jnp

    from arkoserenderer.core import mathx as mx
    from arkoserenderer.ops import raster

    w = h = 16
    cfg = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=8)
    verts = np.array([[-1, -1, -4], [1, -1, -4], [0, 1, -4]], np.float32)
    proj = mx.perspective_reverse_z(np.radians(70.0), 1.0, 0.1, 100.0)
    clip = mx.transform_points_h(proj, jnp.asarray(verts))
    setup = raster.setup_triangles(clip, jnp.arange(3, dtype=jnp.int32)[None],
                                   jnp.ones(1, bool), w, h)
    bins = raster.bin_triangles(setup, w, h, cfg)
    vis, depth = (np.asarray(a) for a in
                  raster.rasterize_tiles_reference(setup, bins, w, h, cfg))
    empty = np.argwhere(vis == -1)[0]
    vis_ref, depth_ref = vis.copy(), depth.copy()
    vis_ref[tuple(empty)], depth_ref[tuple(empty)] = 0, 0.5
    stats = chip_smoke.compare_raster(vis, depth, vis_ref, depth_ref, "tie",
                                      (setup, bins, cfg, w))
    assert stats["decided_by_numpy_px"] == 1
    full = np.argwhere(vis == 0)[0]
    vis_bad, depth_bad = vis.copy(), depth.copy()
    vis_bad[tuple(full)], depth_bad[tuple(full)] = -1, 0.0
    with pytest.raises(AssertionError, match="tie-break"):
        chip_smoke.compare_raster(vis_bad, depth_bad, vis, depth, "tie",
                                  (setup, bins, cfg, w))


def test_raster_phase_tiny():
    out = chip_smoke.phase_raster(128, 64, 16, SMALL)
    assert out["flagship"]["covered_px"] > 0
    assert out["test_scene"]["coverage_mismatch_px"] == 0


def test_shadow_raster_phase_tiny():
    out = chip_smoke.phase_shadow_raster(256, 16, SMALL)
    assert out["covered_px"] > 0


def test_precision_phase_tiny():
    out = chip_smoke.phase_precision(64, 32, 16, n_probes=8, rays=32)
    assert len(out["geometry"]) == 5
    assert max(out["geometry"].values()) <= chip_smoke.GEOMETRY_RTOL
    assert set(out["ddgi"]) == {"DEFAULT", "HIGHEST"}


def test_main_path_phase_small():
    out = chip_smoke.phase_main_path(small=True, frames=2, configs=("forward",))
    assert out["forward"]["compile_s"] > 0
    assert out["forward"]["ms_per_frame"] > 0


def test_apps_phase_tiny():
    out = chip_smoke.phase_apps(128, 64, frames=1, samples=1)
    assert set(out) == {"showcase", "pathtracer"}
    assert not list(REPO.glob(".chip_smoke_png*"))


def test_goldens_phase_forward():
    out = chip_smoke.phase_goldens(["forward"])
    assert list(out) == ["forward"]


def test_four_card_phase_tiny():
    out = chip_smoke.phase_four(128, 64, n_devices=4, shadow=256)
    assert set(out) == {"forward+SSAO", "RT+DDGI"}


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_script_fails_on_cpu_and_prints_no_result():
    proc = _run(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
    assert "expected platform 'gpu'" in proc.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
