"""Binary-cereal .ark* storage (cereal_binary.py): the bake tools' output
flavor (AssetStorage::Binary, tools/ArkAssetBakeTool.cpp:35-59; header
format Asset.h:15-99). The same loaders must accept either flavor, and a
Binary-baked asset must load bit-identically to its JSON twin."""

from pathlib import Path

import numpy as np
import pytest

from arkoserenderer.assets import cereal_binary as cb
from arkoserenderer.assets.ark import (
    LevelDocument,
    load_arkanim,
    load_arkhair,
    load_arkmat,
    load_arkmsh,
    load_arkset,
    load_arkskel,
    read_ark_document,
    save_arkanim,
    save_arkhair,
    save_arkset,
    save_arkskel,
)
from arkoserenderer.core.types import SceneLimits
from arkoserenderer.scene.scene import Scene

REF_BOX = Path("/root/reference/assets/assets/sample/models/Box/Box.arkmsh")


def small_scene() -> Scene:
    return Scene(limits=SceneLimits(
        max_vertices=1 << 12, max_indices=3 << 12, max_drawables=16,
        max_materials=8, max_textures=8, texture_pool_texels=1 << 16,
    ))


def seg_equal(a, b):
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.normals, b.normals)
    if a.uvs is not None or b.uvs is not None:
        np.testing.assert_array_equal(a.uvs, b.uvs)
    if a.tangents is not None or b.tangents is not None:
        np.testing.assert_array_equal(a.tangents, b.tangents)


# ---------------------------------------------------------------------------


@pytest.mark.skipif(not REF_BOX.exists(), reason="reference assets not mounted")
def test_box_arkmsh_binary_bit_identical(tmp_path):
    """The VERDICT r4 done-criterion verbatim: a Binary-baked Box.arkmsh
    (written by the new writer) loads bit-identically to its JSON twin."""
    doc = read_ark_document(REF_BOX, "mesh")
    bin_path = tmp_path / "Box.arkmsh"
    cb.write_ark_binary(bin_path, doc)

    # Binary flavor sniffs by magic, not extension.
    head = bin_path.read_bytes()[:4]
    assert head == b"amsh"

    s_json, s_bin = small_scene(), small_scene()
    ids_json = load_arkmsh(s_json, REF_BOX)
    ids_bin = load_arkmsh(s_bin, bin_path)
    assert len(ids_json) == len(ids_bin) == 1
    seg_equal(s_json.segments[ids_json[0]], s_bin.segments[ids_bin[0]])

    # And the binary stream is stable: decode -> encode is the identity.
    assert cb.encode(".arkmsh", cb.decode(bin_path.read_bytes())) == \
        bin_path.read_bytes()


def test_mesh_binary_roundtrip_synthetic(tmp_path):
    rng = np.random.default_rng(7)
    n = 23
    doc = {
        "name": "synth",
        "LODs": [{"meshSegments": [{
            "positions": rng.standard_normal((n, 3)).astype(np.float32),
            "texcoord0s": rng.random((n, 2)).astype(np.float32),
            "normals": rng.standard_normal((n, 3)).astype(np.float32),
            "tangents": rng.standard_normal((n, 4)).astype(np.float32),
            "jointIndices": np.zeros((0, 4), np.uint16),
            "jointWeights": np.zeros((0, 4), np.float32),
            "morphTargets": [{
                "name": "puff",
                "positions": rng.standard_normal((n, 3)).astype(np.float32),
                "normals": np.zeros((n, 3), np.float32),
                "tangents": np.zeros((0, 3), np.float32),
            }],
            "indices": rng.integers(0, n, 3 * 11).astype(np.uint32),
            "meshletData": None,
            "opacityMicroMapData": None,
            "material": "assets/whatever.arkmat",
        }]}],
        "minLOD": 0, "maxLOD": 99,
        "boundingBox": {"min": {"x": -1, "y": -1, "z": -1},
                        "max": {"x": 1, "y": 1, "z": 1}},
        "boundingSphere": {"center": {"x": 0, "y": 0, "z": 0}, "radius": 2},
    }
    data = cb.encode(".arkmsh", doc)
    out = cb.decode(data)
    seg0, out0 = doc["LODs"][0]["meshSegments"][0], \
        out["LODs"][0]["meshSegments"][0]
    for key in ("positions", "texcoord0s", "normals", "tangents", "indices"):
        np.testing.assert_array_equal(seg0[key], out0[key])
    assert out0["material"] == seg0["material"]
    assert out0["morphTargets"][0]["name"] == "puff"
    np.testing.assert_array_equal(out0["morphTargets"][0]["positions"],
                                  seg0["morphTargets"][0]["positions"])
    assert out0["meshletData"] == {"nullopt": True}
    assert out["boundingSphere"]["radius"] == 2.0
    # byte-stable
    assert cb.encode(".arkmsh", out) == data


def test_material_binary_roundtrip(tmp_path):
    doc = {
        "brdf": "Default",
        "baseColor": {"image": "assets/tex/albedo.png",
                      "wrapModes": {"u": "Repeat", "v": "Repeat",
                                    "w": "ClampToEdge"},
                      "minFilter": "Linear", "magFilter": "Linear",
                      "useMipmapping": True, "mipFilter": "Linear"},
        "emissiveColor": None, "normalMap": None, "bentNormalMap": None,
        "materialProperties": None, "occlusionMap": None,
        "colorTint": {"x": 0.5, "y": 0.25, "z": 1.0, "w": 1.0},
        "metallicFactor": 0.75, "roughnessFactor": 0.3,
        "emissiveFactor": {"x": 0, "y": 0, "z": 0},
        "clearcoat": 0.0, "clearcoatRoughness": 0.0,
        "indexOfRefraction": 1.5,
        "transmissionFactor": 0.0, "transmissionMap": None,
        "blendMode": "Masked", "maskCutoff": 0.4, "doubleSided": True,
    }
    out = cb.decode(cb.encode(".arkmat", doc))
    assert out["brdf"] == "Default"
    assert out["baseColor"]["data"]["image"] == "assets/tex/albedo.png"
    assert out["baseColor"]["data"]["wrapModes"]["w"] == "ClampToEdge"
    assert out["emissiveColor"] == {"nullopt": True}
    assert out["blendMode"] == "Masked"
    assert abs(out["maskCutoff"] - 0.4) < 1e-6
    assert out["doubleSided"] is True
    assert abs(out["metallicFactor"] - 0.75) < 1e-6

    # And through the Scene loader, binary == json semantics.
    p = tmp_path / "m.arkmat"
    cb.write_ark_binary(p, doc)
    s = small_scene()
    mid = load_arkmat(s, p)
    m = s.materials[mid]
    np.testing.assert_allclose(m.base_color_factor, [0.5, 0.25, 1.0, 1.0])
    assert m.double_sided


def test_material_version_gating():
    """A v1-era binary material (pre bentNormal/occlusion/clearcoat/...)
    must decode with the gated fields absent — the reader honors the
    written cereal_class_version like the reference's migration paths."""
    old = cb.Struct("MaterialAsset", cb.MATERIAL.fields, version=1)
    w = cb._Writer()
    w.parts.append(b"amat")
    w.write(old, {
        "brdf": "Default", "baseColor": None, "emissiveColor": None,
        "normalMap": None, "materialProperties": None,
        "colorTint": {"x": 1, "y": 1, "z": 1, "w": 1},
        "metallicFactor": 0.0, "roughnessFactor": 0.5,
        "emissiveFactor": {"x": 0, "y": 0, "z": 0},
        "blendMode": "Opaque", "maskCutoff": 1.0, "doubleSided": False,
    })
    out = cb.decode(w.getvalue())
    assert out["cereal_class_version"] == 1
    assert "bentNormalMap" not in out
    assert "clearcoat" not in out
    assert abs(out["roughnessFactor"] - 0.5) < 1e-6
    assert out["blendMode"] == "Opaque"


def test_skeleton_binary_roundtrip(tmp_path):
    from arkoserenderer.scene.animation import Skeleton

    skel = Skeleton(
        parents=np.array([-1, 0, 1], np.int32),
        inverse_bind=np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
        rest_translation=np.array([[0, 0, 0], [0, 1, 0], [0, 1, 0]],
                                  np.float32),
        rest_rotation=np.tile(np.array([0, 0, 0, 1], np.float32), (3, 1)),
        rest_scale=np.ones((3, 3), np.float32),
    )
    pj = tmp_path / "j.arkskel"
    save_arkskel(pj, skel, ["root", "mid", "tip"])
    doc = read_ark_document(pj, "skeleton")
    pb = tmp_path / "b.arkskel"
    cb.write_ark_binary(pb, doc)

    sj, nj = load_arkskel(pj)
    sb, nb = load_arkskel(pb)
    assert nj == nb == ["root", "mid", "tip"]
    np.testing.assert_array_equal(sj.parents, sb.parents)
    np.testing.assert_allclose(sj.inverse_bind, sb.inverse_bind)
    np.testing.assert_allclose(sj.rest_translation, sb.rest_translation)


def test_animation_binary_roundtrip(tmp_path):
    from arkoserenderer.scene.animation import AnimationClip, AnimChannel

    clip = AnimationClip(channels=[
        AnimChannel(target_joint=0, path="translation",
                    times=np.array([0.0, 1.0], np.float32),
                    values=np.array([[0, 0, 0], [1, 2, 3]], np.float32),
                    interpolation=1),
        AnimChannel(target_joint=1, path="rotation",
                    times=np.array([0.0, 0.5, 1.0], np.float32),
                    values=np.array([[0, 0, 0, 1]] * 3, np.float32),
                    interpolation=0),
    ], name="walk")
    pj = tmp_path / "w.arkanim"
    save_arkanim(pj, clip, ["hip", "knee"])
    doc = read_ark_document(pj, "animation")
    pb = tmp_path / "w2.arkanim"
    cb.write_ark_binary(pb, doc)

    cj = load_arkanim(pj, ["hip", "knee"])
    cbk = load_arkanim(pb, ["hip", "knee"])
    assert len(cj.channels) == len(cbk.channels)
    for a, b in zip(cj.channels, cbk.channels):
        assert a.target_joint == b.target_joint and a.path == b.path
        np.testing.assert_allclose(a.times, b.times)
        np.testing.assert_allclose(a.values, b.values)
        assert a.interpolation == b.interpolation


def test_set_binary_roundtrip(tmp_path):
    root = {
        "name": "root",
        "transform": {"translation": {"x": 0, "y": 0, "z": 0},
                      "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                      "scale": {"x": 1, "y": 1, "z": 1}},
        "meshIndex": -1,
        "children": [{
            "name": "child",
            "transform": {"translation": {"x": 2, "y": 0, "z": 0},
                          "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                          "scale": {"x": 1, "y": 1, "z": 1}},
            "meshIndex": 0,
            "children": [],
        }],
    }
    pj = tmp_path / "s.arkset"
    save_arkset(pj, root, ["assets/whatever.arkmsh"])
    doc = read_ark_document(pj, "set")
    pb = tmp_path / "s2.arkset"
    cb.write_ark_binary(pb, doc)
    out = cb.decode(pb.read_bytes())
    assert out["name"] == doc.get("name", "")
    kids = out["rootNode"]["children"]
    assert kids[0]["ptr_wrapper"]["valid"] == 1
    assert kids[0]["ptr_wrapper"]["data"]["meshIndex"] == 0
    assert list(out["meshAssets"]) == ["assets/whatever.arkmsh"]


def test_hair_binary_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    n_str, pts = 4, 6
    points = rng.standard_normal((n_str * pts, 3)).astype(np.float32)
    segments = np.full((n_str,), pts - 1, np.int32)
    pj = tmp_path / "h.arkhair"
    save_arkhair(pj, points, segments, thickness=0.02)
    doc = read_ark_document(pj, "hair")
    pb = tmp_path / "h2.arkhair"
    cb.write_ark_binary(pb, doc)

    s1, s2 = small_scene(), small_scene()
    r1 = load_arkhair(s1, pj)
    r2 = load_arkhair(s2, pb)
    assert r1["strands"] == r2["strands"] == n_str
    assert r1["points"] == r2["points"]


def test_level_binary_roundtrip(tmp_path):
    lvl = {
        "name": "lvl",
        "objects": [{
            "name": "obj0",
            "transform": {"translation": {"x": 1, "y": 2, "z": 3},
                          "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                          "scale": {"x": 1, "y": 1, "z": 1}},
            "mesh": {"index": 0, "data": "assets/box.arkmsh"},
            "set": "", "hair": "",
        }],
        "lights": [{
            "type": "DirectionalLight", "name": "sun",
            "color": {"x": 1, "y": 1, "z": 1},
            "transform": {"translation": {"x": 0, "y": 10, "z": 0},
                          "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                          "scale": {"x": 1, "y": 1, "z": 1}},
            "castsShadows": True,
            "customConstantBias": 0.0, "customSlopeBias": 0.0,
            "data": {"index": 0, "data": {"illuminance": 90000.0,
                                          "shadowMapWorldExtent": 50.0}},
        }],
        "cameras": [{
            "position": {"x": 0, "y": 1, "z": 5},
            "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
            "nearClipPlane": 0.25, "farClipPlane": 10000.0,
            "focusMode": "Manual", "focalLength": 30.0, "focusDepth": 5.0,
            "sensorSize": {"x": 36.0, "y": 24.0},
            "exposureMode": "Manual", "fNumber": 16.0, "iso": 400.0,
            "shutterSpeed": 0.0025, "exposureCompensation": 0.0,
            "adaptionRate": 0.0018,
        }],
        "environmentMap": {"assetPath": "assets/sky.dds",
                           "brightnessFactor": 5000.0},
        "probeGrid": {"gridDimensions": {"width": 8, "height": 4, "depth": 8},
                      "probeSpacing": {"x": 1, "y": 1, "z": 1},
                      "offsetToFirst": {"x": -4, "y": 0, "z": -4}},
    }
    pb = tmp_path / "l.arklvl"
    cb.write_ark_binary(pb, lvl)
    out = cb.decode(pb.read_bytes())
    assert out["objects"][0]["mesh"] == {"index": 0, "data": "assets/box.arkmsh"}
    assert out["lights"][0]["data"]["index"] == 0
    assert abs(out["lights"][0]["data"]["data"]["illuminance"] - 90000.0) < 1e-3
    assert out["cameras"][0]["sensorSize"] == {"x": 36.0, "y": 24.0}
    assert out["environmentMap"]["data"]["assetPath"] == "assets/sky.dds"
    assert out["probeGrid"]["data"]["gridDimensions"]["depth"] == 8
    # LevelDocument reads either flavor
    ld = LevelDocument.read(pb)
    assert ld.level["objects"][0]["name"] == "obj0"


def test_arkbake_tool(tmp_path):
    """tools/arkbake.py mirrors ArkAssetBakeTool: JSON in, Binary out."""
    if not REF_BOX.exists():
        pytest.skip("reference assets not mounted")
    import subprocess
    import sys

    out = tmp_path / "Box.arkmsh"
    r = subprocess.run(
        [sys.executable, "tools/arkbake.py", str(REF_BOX), str(out)],
        capture_output=True, text=True, cwd=Path(__file__).resolve().parents[1],
    )
    assert r.returncode == 0, r.stderr
    assert out.read_bytes()[:4] == b"amsh"
    s1, s2 = small_scene(), small_scene()
    seg_equal(s1.segments[load_arkmsh(s1, REF_BOX)[0]],
              s2.segments[load_arkmsh(s2, out)[0]])


def test_loader_rejects_unknown_binary():
    with pytest.raises(ValueError):
        cb.decode(b"zzzz" + b"\0" * 16)
