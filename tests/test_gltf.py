"""glTF importer tests against the reference's sample assets (data only —
the reference tree is the natural source of test scenes; no code involved)."""

from pathlib import Path

import numpy as np
import pytest

from arkoserenderer.assets.gltf import load_gltf, parse_gltf, read_accessor
from arkoserenderer.core.types import SceneLimits
from arkoserenderer.scene.scene import Scene

SAMPLES = Path("/root/reference/assets/assets/sample/models")

pytestmark = pytest.mark.skipif(
    not SAMPLES.exists(), reason="reference sample assets not mounted"
)


def small_scene():
    return Scene(
        limits=SceneLimits(
            max_vertices=1 << 18, max_indices=3 << 18, max_drawables=256,
            max_materials=64, max_textures=64, texture_pool_texels=1 << 22,
        )
    )


def test_cornell_box_geometry():
    scene = small_scene()
    res = load_gltf(scene, SAMPLES / "CornellBox" / "CornellBox.gltf")
    assert res.instance_count > 0
    arrays = scene.build()
    tri_valid = np.asarray(arrays.tri_valid)
    assert tri_valid.sum() > 10
    pos = np.asarray(arrays.positions)
    assert np.isfinite(pos).all()
    # Cornell box is roughly unit scale and closed: bounding sphere sane.
    center, radius = scene.bounding_sphere()
    assert 0.5 < radius < 50.0


def test_damaged_helmet_textures():
    scene = small_scene()
    res = load_gltf(
        scene, SAMPLES / "DamagedHelmet" / "DamagedHelmet.gltf", max_texture_size=128
    )
    assert len(res.texture_ids) >= 3  # base/normal/mr at least
    assert res.instance_count >= 1
    mats = scene.materials
    assert any(m.base_color_tex >= 4 for m in mats)  # non-default texture assigned


def test_glb_container():
    glb = SAMPLES.parent.parent / "engine" / "test" / "material" / "clearcoat" / "CompareClearcoat.glb"
    if not glb.exists():
        pytest.skip("no glb sample")
    g = parse_gltf(glb)
    assert "meshes" in g.doc and g.buffers


def test_accessor_decode_head_positions():
    # (Sponza.gltf ships without its .bin in the reference checkout; the
    # Head model is the largest complete sample.)
    g = parse_gltf(SAMPLES / "Head" / "lpshead.gltf")
    prim = g.doc["meshes"][0]["primitives"][0]
    pos = read_accessor(g, prim["attributes"]["POSITION"])
    assert pos.shape[1] == 3 and pos.dtype == np.float32
    acc = g.doc["accessors"][prim["attributes"]["POSITION"]]
    np.testing.assert_allclose(pos.min(0), acc["min"], rtol=1e-5)
    np.testing.assert_allclose(pos.max(0), acc["max"], rtol=1e-5)


def test_cornell_interior_renders():
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight
    from arkoserenderer.assets.procedural import gradient_env_map

    scene = Scene(
        limits=SceneLimits(
            max_vertices=1 << 19, max_indices=3 << 19, max_drawables=512,
            max_materials=64, max_textures=128, texture_pool_texels=1 << 23,
        )
    )
    load_gltf(scene, SAMPLES / "CornellBox" / "CornellBox.gltf", max_texture_size=64)
    scene.sun = DirectionalLight(direction=np.array([0.2, -1.0, 0.1], np.float32))
    scene.set_env_map(gradient_env_map(16), brightness=8000.0)
    scene.ambient_lx = 8000.0
    cam = Camera(viewport=(128, 128))
    center, radius = scene.bounding_sphere()
    cam.look_at(center + np.array([0.0, 0.0, radius * 1.6]), center)
    cfg = PipelineConfig(
        width=128, height=128,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512, bin_chunk=2048),
        shadow_map_size=256,
    )
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()
    vis = np.asarray(r.state["Visibility"])
    assert (vis >= 0).mean() > 0.5  # inside the atrium, mostly geometry
    assert img.std() > 0.03


def _synthetic_gltf(tmp_path, with_transform: bool, with_draco: bool = False):
    """Minimal quad .gltf with an embedded buffer + 1x1 texture; optionally
    a KHR_texture_transform on the baseColor texture."""
    import base64
    import json

    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = pos.tobytes() + uv.tobytes() + idx.tobytes()
    # 1x1 white PNG
    png = base64.b64decode(
        b"iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAYAAAAfFcSJAAAADUlEQVR42mP8"
        b"z8BQDwAEhQGAhKmMIQAAAABJRU5ErkJggg=="
    )
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
        }}],
        "textures": [{"source": 0}],
        "images": [{"uri": "data:image/png;base64,"
                           + base64.b64encode(png).decode()}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 32},
            {"buffer": 0, "byteOffset": 80, "byteLength": 12},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3", "min": [0, 0, 0], "max": [1, 1, 0]},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
    }
    if with_transform:
        doc["extensionsUsed"] = ["KHR_texture_transform"]
        doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"][
            "extensions"] = {"KHR_texture_transform": {
                "offset": [0.25, 0.5], "scale": [2.0, 3.0]}}
    if with_draco:
        doc["extensionsUsed"] = ["KHR_draco_mesh_compression"]
        doc["meshes"][0]["primitives"][0]["extensions"] = {
            "KHR_draco_mesh_compression": {"bufferView": 0}}
    p = tmp_path / "quad.gltf"
    p.write_text(json.dumps(doc))
    return p


def test_khr_texture_transform_baked_into_uvs(tmp_path):
    """KHR_texture_transform (offset + scale) is baked into the segment UVs
    at import: uv' = S * uv + offset (GltfLoader.cpp handles the same
    extension via tiny_gltf in the reference)."""
    scene = small_scene()
    load_gltf(scene, _synthetic_gltf(tmp_path, with_transform=True))
    seg = scene.segments[-1]
    expect = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    expect = expect * np.array([2.0, 3.0], np.float32) + np.array(
        [0.25, 0.5], np.float32)
    np.testing.assert_allclose(seg.uvs, expect, atol=1e-6)

    scene2 = small_scene()
    load_gltf(scene2, _synthetic_gltf(tmp_path, with_transform=False))
    np.testing.assert_allclose(
        scene2.segments[-1].uvs,
        np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), atol=1e-6)


def test_draco_rejected_with_clear_error(tmp_path):
    scene = small_scene()
    with pytest.raises(ValueError, match="Draco"):
        load_gltf(scene, _synthetic_gltf(tmp_path, with_transform=False,
                                         with_draco=True))
