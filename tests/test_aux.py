"""Auxiliary subsystems: task graph, profiling zones, mem stats, external
asset formats (cube LUT, IES, hair), IES-lit spots, LUT grading."""

import numpy as np
import jax.numpy as jnp

from arkoserenderer.assets import external as ext
from arkoserenderer.assets.external import CubeLUT, HairFile, IESProfile, apply_lut3d
from arkoserenderer.core import taskgraph
from arkoserenderer.utils import memstats, profiling


def test_taskgraph_parallel_for():
    out = np.zeros(100)

    def body(i):
        out[i] = i * 2

    taskgraph.parallel_for(100, body)
    np.testing.assert_array_equal(out, np.arange(100) * 2)


def test_taskgraph_batched_and_futures():
    acc = []
    taskgraph.parallel_for_batched(10, lambda s, e: acc.append((s, e)), batch=4)
    assert sorted(acc) == [(0, 4), (4, 8), (8, 10)]
    f = taskgraph.schedule_task(lambda: 42, background=True)
    assert f.result() == 42


def test_pollable_task_progress():
    def work(task):
        task.set_progress(0.5)
        task.set_progress(1.0)
        return "done"

    t = taskgraph.PollableTask.run(work)
    assert t.result() == "done"
    assert t.progress() == 1.0


def test_profiling_zones():
    profiling.reset_zones()
    with profiling.zone("test-zone"):
        sum(range(1000))
    avgs = profiling.zone_averages()
    assert "test-zone" in avgs and avgs["test-zone"] >= 0.0


def test_memstats_snapshot():
    s = memstats.snapshot()
    assert s.bytes_in_use >= 0
    h = memstats.MemHistory()
    h.poll()
    assert "HBM" in h.format()


def test_cube_lut_identity_roundtrip(rng):
    lut = CubeLUT.identity(8)
    c = rng.random((64, 3)).astype(np.float32)
    out = np.asarray(apply_lut3d(jnp.asarray(lut.table), jnp.asarray(c)))
    np.testing.assert_allclose(out, c, atol=1e-5)


def test_cube_lut_parse():
    text = """# comment
TITLE "test"
LUT_3D_SIZE 2
0 0 0
1 0 0
0 1 0
1 1 0
0 0 1
1 0 1
0 1 1
1 1 1
"""
    lut = CubeLUT.parse(text)
    assert lut.size == 2
    np.testing.assert_allclose(lut.table[0, 0, 1], [1, 0, 0])  # r fastest
    np.testing.assert_allclose(lut.table[1, 0, 0], [0, 0, 1])  # b slowest


def test_ies_parse_and_lut():
    # Minimal synthetic IES: 3 vertical angles, 1 horizontal, downlight.
    text = """IESNA:LM-63-1995
[TEST] synthetic
TILT=NONE
1 1000 1 3 1 1 2 0 0 0
1.0 1.0 0
0 45 90
0
1000 500 0
"""
    prof = IESProfile.parse(text)
    assert prof.candela.shape == (1, 3)
    lut = prof.to_lut(64)
    assert lut.shape == (64,)
    assert lut[0] == 1.0          # peak straight down
    assert lut[-1] < 0.01         # nothing sideways/up


def test_hair_file_roundtrip(tmp_path):
    import struct

    n_strands, n_points = 2, 6
    header = b"HAIR" + struct.pack(
        "<IIII", n_strands, n_points, 0, 2
    ) + struct.pack("<ff", 0.1, 0.0) + struct.pack("<fff", 0.5, 0.3, 0.1)
    header = header.ljust(128, b"\0")
    pts = np.arange(18, dtype=np.float32)
    path = tmp_path / "test.hair"
    path.write_bytes(header + pts.tobytes())
    h = HairFile.load(str(path))
    assert h.num_strands == 2
    np.testing.assert_array_equal(h.segments, [2, 2])
    assert h.points.shape == (6, 3)


def test_ies_spot_in_pipeline():
    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.lights import SpotLight

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    narrow = np.zeros(256, np.float32)
    narrow[:32] = 1.0  # only within ~22 deg of axis
    scene.spots.append(SpotLight(
        position=np.array([0.0, 4.0, 0.0], np.float32),
        direction=np.array([0.0, -1.0, 0.0], np.float32),
        luminous_intensity_cd=50000.0,
        ies_lut=narrow,
    ))
    cfg = PipelineConfig(width=96, height=96,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                         shadow_map_size=128)
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()


def test_color_grade_lut_in_output():
    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import RenderPipeline, make_forward_pipeline
    from arkoserenderer.rendering.pipeline import PipelineConfig

    # A LUT that zeroes blue: output must have no blue channel.
    lut = CubeLUT.identity(4)
    lut.table[..., 2] = 0.0
    from arkoserenderer.models.standard import Renderer

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    cfg = PipelineConfig(width=96, height=96,
                         raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
                         shadow_map_size=128)
    import arkoserenderer.models.standard as std
    import arkoserenderer.rendering.passes as passes

    pipe_kw = dict(taa=False, bloom=False)
    r = Renderer(scene, cam, cfg, **pipe_kw)
    # Rebuild the pipeline with the LUT-equipped output pass.
    from arkoserenderer.rendering.passes.output import OutputPass

    for i, p in enumerate(r.pipeline.passes):
        if isinstance(p, OutputPass):
            r.pipeline.passes[i] = OutputPass(color_grade_lut=lut)
    r.pipeline.construct_all()
    img = np.array(r.render_frame())
    assert img[..., 2].max() < 1e-5
    assert img[..., 0].max() > 0.05


# ---------------------------------------------------------------------------
# DDS images


def _dds_header(width, height, n_mips, *, fourcc=None, bitcount=0, masks=None):
    import struct

    pf_flags = 0x4 if fourcc else 0x40 | 0x1
    rm, gm, bm, am = masks or (0, 0, 0, 0)
    pf = struct.pack(
        "<II4sIIIII", 32, pf_flags, fourcc or b"\0\0\0\0", bitcount, rm, gm, bm, am
    )
    hdr = struct.pack("<7I", 124, 0x21007, height, width, 0, 0, n_mips)
    return b"DDS " + hdr + b"\0" * 44 + pf + b"\0" * 20


def test_dds_uncompressed_rgba_with_mips():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 8, 4), np.uint8)
    mip1 = img[::2, ::2]
    # BGRA layout (the common uncompressed DDS)
    def pack(m):
        u = (m[..., 2].astype(np.uint32) | (m[..., 1].astype(np.uint32) << 8)
             | (m[..., 0].astype(np.uint32) << 16) | (m[..., 3].astype(np.uint32) << 24))
        return u.astype("<u4").tobytes()

    data = _dds_header(8, 8, 2, bitcount=32,
                       masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    data += pack(img) + pack(mip1)
    dds = ext.DDSImage.parse(data)
    assert dds.fourcc == "RGBA" and len(dds.mips) == 2
    np.testing.assert_array_equal(dds.mips[0], img)
    np.testing.assert_array_equal(dds.mips[1], mip1)


def test_dds_dxt1_solid_blocks():
    import struct

    # One 4x4 block, c0 = pure red in RGB565, all indices 0.
    c0 = (31 << 11)
    block = struct.pack("<HHI", c0, 0, 0)
    data = _dds_header(4, 4, 1, fourcc=b"DXT1") + block
    dds = ext.DDSImage.parse(data)
    assert dds.mips[0].shape == (4, 4, 4)
    np.testing.assert_array_equal(dds.mips[0][..., 0], 255)
    np.testing.assert_array_equal(dds.mips[0][..., 1], 0)
    np.testing.assert_array_equal(dds.mips[0][..., 3], 255)


def test_dds_bc5_roundtrip():
    from arkoserenderer.assets import meshopt

    rng = np.random.default_rng(4)
    r = rng.integers(0, 256, (8, 8), np.uint8)
    g = rng.integers(0, 256, (8, 8), np.uint8)
    blocks = meshopt.compress_bc5(r, g)
    data = _dds_header(8, 8, 1, fourcc=b"ATI2") + blocks.tobytes()
    dds = ext.DDSImage.parse(data)
    assert dds.fourcc == "ATI2"
    # BC4 is lossy; per-block 8-entry palette keeps error small.
    assert np.abs(dds.mips[0][..., 0].astype(int) - r.astype(int)).max() <= 40
    assert np.abs(dds.mips[0][..., 1].astype(int) - g.astype(int)).max() <= 40


def test_dds_dx10_header():
    import struct

    c0 = (63 << 5)  # pure green
    block = struct.pack("<HHI", c0, 0, 0)
    dx10 = struct.pack("<5I", 71, 3, 0, 1, 0)  # DXGI_FORMAT_BC1_UNORM
    data = _dds_header(4, 4, 1, fourcc=b"DX10") + dx10 + block
    dds = ext.DDSImage.parse(data)
    assert dds.fourcc == "DXT1"
    np.testing.assert_array_equal(dds.mips[0][..., 1], 255)


def test_module_watcher_reloads_changed_module(tmp_path):
    """Hot-reload mechanics (ShaderManager.h:49-51 file watching +
    Arkose.cpp:49-73 reconstruct-on-change): a watched module's source
    changes on disk -> poll() reloads it -> new code is live."""
    import os
    import sys
    import time

    from arkoserenderer.utils.hotreload import ModuleWatcher

    mod_file = tmp_path / "hot_mod_test.py"
    mod_file.write_text("def value():\n    return 1\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import hot_mod_test  # noqa: F401

        assert hot_mod_test.value() == 1
        w = ModuleWatcher(roots=[str(tmp_path)], poll_interval=0.0)
        assert w.poll() == []                      # nothing changed yet

        time.sleep(0.01)
        mod_file.write_text("def value():\n    return 2\n")
        os.utime(mod_file, (time.time() + 2, time.time() + 2))
        reloaded = w.poll()
        assert "hot_mod_test" in reloaded
        assert hot_mod_test.value() == 2           # new code is live
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hot_mod_test", None)


def test_module_watcher_survives_broken_module(tmp_path):
    import os
    import sys
    import time

    from arkoserenderer.utils.hotreload import ModuleWatcher

    mod_file = tmp_path / "hot_mod_broken.py"
    mod_file.write_text("def value():\n    return 1\n")
    sys.path.insert(0, str(tmp_path))
    try:
        import hot_mod_broken

        w = ModuleWatcher(roots=[str(tmp_path)], poll_interval=0.0)
        mod_file.write_text("def value(:\n")       # syntax error
        os.utime(mod_file, (time.time() + 2, time.time() + 2))
        assert w.poll() == []                      # failed reload, no crash
        assert hot_mod_broken.value() == 1         # old code still runs
        # Fix it: reloads on the next poll.
        mod_file.write_text("def value():\n    return 3\n")
        os.utime(mod_file, (time.time() + 4, time.time() + 4))
        assert "hot_mod_broken" in w.poll()
        assert hot_mod_broken.value() == 3
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hot_mod_broken", None)


def test_renderer_reconstruct_preserves_history():
    """reconstruct() (hot reload / recovery) keeps persistent temporal
    state: TAA history survives the rebuild bit-exactly."""
    import numpy as np

    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig

    scene, cam = build_test_scene(viewport=(96, 96))
    cfg = PipelineConfig(
        width=96, height=96,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
        shadow_map_size=128,
    )
    r = Renderer(scene, cam, cfg)
    for _ in range(3):
        r.render_frame()
    hist_before = np.array(np.asarray(r.state["TAAHistory"]))
    r.reconstruct(rebuild_passes=True)
    hist_after = np.array(np.asarray(r.state["TAAHistory"]))
    np.testing.assert_array_equal(hist_before, hist_after)
    img = np.array(r.render_frame())               # keeps rendering
    assert np.isfinite(img).all()


def test_asset_cooker_dependency_tracking(tmp_path):
    """AssetCooker analogue (tools/bin/rules.toml:1-60 semantics): rules
    expand input globs to bake tools; outputs rebuild ONLY when an input's
    content changes (hash-tracked in a cook database)."""
    import sys
    from pathlib import Path

    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    try:
        import cooker as cook_mod
    finally:
        sys.path.pop(0)

    from arkoserenderer.utils.imageio import save_png

    (tmp_path / "src").mkdir()
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        save_png(str(tmp_path / "src" / f"{name}.png"),
                 rng.integers(0, 255, (16, 16, 3), np.uint8))
    (tmp_path / "rules.toml").write_text(
        '[[rule]]\n'
        'name = "mips"\n'
        'tool = "image"\n'
        'input = "src/*.png"\n'
        'output = "baked/{stem}.mips.npz"\n'
        '\n'
        '[[rule]]\n'
        'name = "bc7"\n'
        'tool = "bc7"\n'
        'input = "src/*.png"\n'
        'output = "baked/{stem}.dds"\n'
    )

    c = cook_mod.Cooker(tmp_path / "rules.toml")
    res = c.cook()
    assert len(res["built"]) == 4 and not res["skipped"]
    assert (tmp_path / "baked" / "a.mips.npz").exists()
    assert (tmp_path / "baked" / "a.dds").read_bytes()[:4] == b"DDS "

    # Second run: everything up to date.
    c2 = cook_mod.Cooker(tmp_path / "rules.toml")
    res2 = c2.cook()
    assert not res2["built"] and len(res2["skipped"]) == 4

    # Change ONE input -> exactly its two outputs rebuild.
    save_png(str(tmp_path / "src" / "a.png"),
             rng.integers(0, 255, (16, 16, 3), np.uint8))
    c3 = cook_mod.Cooker(tmp_path / "rules.toml")
    res3 = c3.cook()
    assert sorted(Path(b).name for b in res3["built"]) == ["a.dds", "a.mips.npz"]
    assert len(res3["skipped"]) == 2


def test_validate_frame_clean_and_detects_nans():
    """Per-pass numerical validation harness (the Vulkan validation-layer
    slot, SURVEY §5.2): a healthy frame reports nothing; an injected NaN
    is attributed to the pass + resource that produced it."""
    import jax.numpy as jnp
    import numpy as np

    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig, validate_frame

    scene, cam = build_test_scene(viewport=(64, 64))
    cfg = PipelineConfig(
        width=64, height=64,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
        shadow_map_size=128,
    )
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    r.render_frame()
    persistent = r.pipeline.registry.persistent_names
    inputs = {k: r.state[k] for k in persistent if k in r.state}
    if "scene.version" in persistent:
        inputs["scene.version"] = jnp.asarray(1, jnp.int32)
    assert validate_frame(
        r.pipeline, inputs, r.scene_arrays, cam.state(1), frame_index=1
    ) == []

    # Poison the env map: the sky pass must get the blame.
    bad_scene = r.scene_arrays._replace(
        env_map=r.scene_arrays.env_map.at[0, 0, 0].set(jnp.nan)
    )
    findings = validate_frame(
        r.pipeline, inputs, bad_scene, cam.state(1), frame_index=1
    )
    assert findings, "NaN injection must be detected"
    assert any(f["pass"] in ("SkyView", "LightingCompose") for f in findings)
