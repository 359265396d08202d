"""App layer: headless showcase runs end-to-end; picking; debug draw."""

import os

import numpy as np
import pytest

from arkoserenderer.apps.showcase import main as showcase_main
from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

CFG = PipelineConfig(
    width=128, height=128,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=256,
)


def test_showcase_cli(tmp_path):
    out = str(tmp_path / "frame.png")
    showcase_main([
        "--width", "96", "--height", "96", "--frames", "2", "--out", out,
        "--no-bloom",
    ])
    assert os.path.exists(out)
    from arkoserenderer.utils.imageio import load_image_rgba

    img = load_image_rgba(out)
    assert img.shape == (96, 96, 4)
    assert img[..., :3].std() > 5  # non-trivial image


def test_picking():
    scene, cam = build_test_scene(viewport=(128, 128))
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.render_frame()
    vis = np.asarray(r.state["Visibility"])
    ys, xs = np.nonzero(vis >= 0)
    hit = r.pick(int(xs[0]), int(ys[0]))
    assert hit["instance"] >= 0
    assert hit["distance"] is not None and hit["distance"] > 0
    sky = np.nonzero(vis < 0)
    if len(sky[0]):
        miss = r.pick(int(sky[1][0]), int(sky[0][0]))
        assert miss["instance"] == -1


def test_debug_draw_overlay():
    scene, cam = build_test_scene(viewport=(128, 128))
    r = Renderer(scene, cam, CFG, taa=False, bloom=False, debug_draw=True)
    r.debug.line((-2, 3.0, 0), (2, 3.0, 0), color=(1.0, 0.0, 1.0))
    img = np.array(r.render_frame())
    # Magenta-ish pixels appear somewhere in the upper half.
    magenta = (img[..., 0] > 0.9) & (img[..., 1] < 0.2) & (img[..., 2] > 0.9)
    assert magenta.any()


def test_meshviewer_cli(tmp_path, capsys):
    from pathlib import Path

    import pytest as _pytest

    samples = Path("/root/reference/assets/assets/sample/models")
    if not samples.exists():
        _pytest.skip("no sample assets")
    from arkoserenderer.apps.meshviewer import main as mv_main

    out = str(tmp_path / "turn_{frame}.png")
    mv_main([str(samples / "CornellBox" / "CornellBox.gltf"),
             "--frames", "2", "--size", "64", "--out", out, "--meshlets"])
    captured = capsys.readouterr()
    assert "segments:" in captured.out
    assert "meshlets:" in captured.out
    assert os.path.exists(out.format(frame=0))
    assert os.path.exists(out.format(frame=1))


def test_humandemo_renders(tmp_path):
    """HumanDemo-equivalent (HumanDemo.cpp): procedural bust with skin
    subsurface material + scalp hair, SSSS pipeline on."""
    from arkoserenderer.apps.humandemo import main

    out = str(tmp_path / "human.png")
    assert main(["--width", "96", "--height", "96", "--frames", "2",
                 "--out", out]) == 0
    import numpy as np

    from arkoserenderer.utils.imageio import load_image_rgba

    img = np.asarray(load_image_rgba(out), np.float32)
    assert np.isfinite(img).all()
    assert 10 < img[..., :3].mean() < 245


def test_humandemo_ssss_changes_skin(tmp_path):
    from arkoserenderer.apps.humandemo import main

    import numpy as np

    from arkoserenderer.utils.imageio import load_image_rgba

    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    assert main(["--width", "96", "--height", "96", "--frames", "1",
                 "--no-hair", "--out", a]) == 0
    assert main(["--width", "96", "--height", "96", "--frames", "1",
                 "--no-hair", "--no-ssss", "--out", b]) == 0
    ia = np.asarray(load_image_rgba(a), np.float32)
    ib = np.asarray(load_image_rgba(b), np.float32)
    assert np.abs(ia - ib).max() > 2.0   # the SSSS pass visibly diffuses skin


def test_geodata_terrain_renders(tmp_path):
    """GeodataApp-equivalent (geodata/GeodataApp.cpp): heightmap -> region
    crop -> LOD terrain meshes -> altitude-colored render."""
    from arkoserenderer.apps.geodata import main

    out = str(tmp_path / "terrain.png")
    assert main(["--width", "96", "--height", "96", "--frames", "2",
                 "--grid", "65", "--out", out]) == 0
    import numpy as np

    from arkoserenderer.utils.imageio import load_image_rgba

    img = np.asarray(load_image_rgba(out), np.float32)
    assert np.isfinite(img).all()
    assert 10 < img[..., :3].mean() < 245


def test_geodata_region_crop():
    from arkoserenderer.apps.geodata import crop_region, fbm_heightmap

    h = fbm_heightmap(129)
    import numpy as np

    c = crop_region(h, (0.25, 0.25, 0.75, 0.75))
    assert c.shape == (64, 64)
    np.testing.assert_array_equal(c, h[32:96, 32:96])


def test_live_viewer_http_roundtrip():
    """Live viewer (the interactive System/Input/editor/timing-UI surface,
    VulkanBackend's ImGui + GLFW slot): serve frames over HTTP, accept
    input + pick events, and keep rendering."""
    import json
    import threading
    import urllib.request

    from arkoserenderer.apps import viewer

    result = {}
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    def run2():
        result["rc"] = viewer.main([
            "--width", "96", "--height", "96", "--port", str(port),
            "--frames", "60",
        ])

    th = threading.Thread(target=run2, daemon=True)
    th.start()

    base = f"http://127.0.0.1:{port}"

    def get(path, timeout=60):
        return urllib.request.urlopen(base + path, timeout=timeout).read()

    # Wait for the server + first frame.
    import time as _t

    png = b""
    for _ in range(120):
        try:
            png = get("/frame.png")
            if png:
                break
        except Exception:
            pass
        _t.sleep(0.5)
    assert png[:4] == b"\x89PNG"

    page = get("/")
    assert b"viewer" in page
    # Post a key event + a click; the loop must keep serving.
    req = urllib.request.Request(
        base + "/event", data=json.dumps({"type": "keydown", "key": "w"}).encode(),
        method="POST")
    urllib.request.urlopen(req, timeout=30).read()
    req = urllib.request.Request(
        base + "/event", data=json.dumps({"type": "click", "x": 48, "y": 60}).encode(),
        method="POST")
    urllib.request.urlopen(req, timeout=30).read()

    # Hierarchy panel: rows for every instance; select row 0 through it.
    hier = json.loads(get("/hierarchy"))
    assert len(hier) >= 2 and {"instance", "name", "segment"} <= set(hier[0])

    def post(ev):
        rq = urllib.request.Request(
            base + "/event", data=json.dumps(ev).encode(), method="POST")
        urllib.request.urlopen(rq, timeout=30).read()

    post({"type": "select", "instance": 0})
    # Cycle gizmo translate -> rotate, then manipulate the selection.
    post({"type": "keydown", "key": "g"})
    _t.sleep(0.8)
    post({"type": "keyup", "key": "g"})
    post({"type": "keydown", "key": "ArrowUp"})
    _t.sleep(0.5)
    post({"type": "keyup", "key": "ArrowUp"})
    _t.sleep(1.0)
    stats = json.loads(get("/stats"))
    assert stats["frame"] >= 1
    assert stats["ms"] > 0
    assert stats.get("selected") == 0
    assert stats.get("gizmo") in ("rotate", "scale")
    th.join(timeout=240)
    assert result.get("rc") == 0


def test_meshviewer_inspect_edit_save(tmp_path):
    """MeshViewer inspector/editor half (MeshViewerApp.cpp): per-segment
    drill-down, material edits, save back to the baked format, debug-view
    rendering."""
    import numpy as np

    from arkoserenderer.apps import meshviewer
    from arkoserenderer.assets.baked import load_baked, save_baked
    from arkoserenderer.assets.procedural import build_test_scene

    scene, _ = build_test_scene(viewport=(64, 64))
    src = str(tmp_path / "scene.npz")
    save_baked(scene, src)

    out = str(tmp_path / "edited.npz")
    meshviewer.main([
        src, "--no-render", "--inspect-segment", "0",
        "--set-material", "1", "roughness_factor=0.25", "metallic_factor=1",
        "--save", out,
    ])
    edited = load_baked(out, limits=scene.limits)
    assert abs(edited.materials[1].roughness_factor - 0.25) < 1e-6
    assert abs(edited.materials[1].metallic_factor - 1.0) < 1e-6

    # Debug-channel turntable render.
    png = str(tmp_path / "view_{frame}.png")
    meshviewer.main([src, "--frames", "1", "--size", "64",
                     "--view", "normal", "--out", png])
    from arkoserenderer.utils.imageio import load_image_rgba

    img = load_image_rgba(png.format(frame=0))
    assert np.isfinite(img).all() and img[..., :3].std() > 1.0
