"""Native .ark* asset loading against the reference's own shipped files
(cereal JSON archives — MeshAsset.h:147 .arkmsh, MaterialAsset .arkmat,
LevelAsset .arklvl). Data only; no reference code involved."""

import json
from pathlib import Path

import numpy as np
import pytest

from arkoserenderer.assets.ark import load_arklvl, load_arkmat, load_arkmsh
from arkoserenderer.core.types import SceneLimits
from arkoserenderer.scene.scene import Scene

ASSETS = Path("/root/reference/assets/assets")

pytestmark = pytest.mark.skipif(
    not ASSETS.exists(), reason="reference sample assets not mounted"
)


def small_scene():
    return Scene(limits=SceneLimits(
        max_vertices=1 << 16, max_indices=3 << 16, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 18,
    ))


def test_arkmsh_box_loads_with_material():
    scene = small_scene()
    sids = load_arkmsh(scene, ASSETS / "sample/models/Box/Box.arkmsh")
    assert len(sids) == 1
    seg = scene.segments[sids[0]]
    assert seg.positions.shape == (24, 3)
    assert seg.num_triangles == 12
    # Red.arkmat: colorTint (0.8, 0, 0, 1), roughness 1.
    mat = scene.materials[seg.material]
    np.testing.assert_allclose(
        mat.base_color_factor, [0.8, 0.0, 0.0, 1.0], atol=1e-6)
    assert mat.roughness_factor == 1.0


def test_arkmat_defaults():
    scene = small_scene()
    mid = load_arkmat(scene, ASSETS / "engine/default/DefaultMaterial.arkmat")
    m = scene.materials[mid]
    assert m.base_color_tex == 0          # no texture refs in the file
    assert 0.0 <= m.metallic_factor <= 1.0


def test_arklvl_cornellbox_camera_and_missing_mesh():
    scene = small_scene()
    res = load_arklvl(scene, ASSETS / "sample/levels/CornellBox.arklvl")
    # The shipped level references an .arkmsh not present in the checkout:
    # reported, not fatal.
    assert res["missing"], "expected the absent CornellBox-Original.arkmsh"
    assert len(res["cameras"]) == 1
    cam = res["cameras"][0]
    np.testing.assert_allclose(cam.position, [0.0, 1.0, 4.0], atol=1e-6)
    assert cam.focal_length_mm == 30.0
    assert cam.f_number == 11.0
    assert cam.iso == 400.0


def test_arklvl_humandemo_parses_directional_light():
    scene = small_scene()
    res = load_arklvl(scene, ASSETS / "sample/levels/HumanDemo/HumanDemo.arklvl")
    assert res["lights"] == 1
    assert scene.sun is not None
    assert scene.sun.illuminance_lux == 90000.0
    d = np.asarray(scene.sun.direction, np.float64)
    np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-5)
    assert d[1] < 0.0   # points downward


def test_ark_box_renders_end_to_end():
    """The loaded Box.arkmsh renders through the full pipeline with its
    .arkmat material: red pixels on screen."""
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight

    scene = small_scene()
    sids = load_arkmsh(scene, ASSETS / "sample/models/Box/Box.arkmsh")
    w = np.eye(4, dtype=np.float32)
    scene.add_instance(sids[0], w)
    scene.sun = DirectionalLight(
        direction=np.array([0.3, -1.0, -0.4], np.float32),
        illuminance_lux=90000.0)
    scene.ambient_lx = 5000.0
    cam = Camera(viewport=(96, 96))
    cam.look_at((1.6, 1.3, 2.2), (0.0, 0.0, 0.0))
    cfg = PipelineConfig(
        width=96, height=96,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
        shadow_map_size=128,
    )
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()
    # The box fills the view center; red dominates there.
    center = img[36:60, 36:60]
    assert center[..., 0].mean() > center[..., 1].mean() * 1.5
    assert center[..., 0].mean() > 0.1


def test_meshviewer_inspects_arkmsh(capsys):
    """The MeshViewer CLI accepts the reference's .arkmsh directly."""
    from arkoserenderer.apps import meshviewer

    meshviewer.main([
        str(ASSETS / "sample/models/Box/Box.arkmsh"), "--no-render",
    ])
    out = capsys.readouterr().out
    assert "segments" in out.lower() or "Mesh" in out


# ---------------------------------------------------------------------------
# Round-4: set / skeleton / animation / hair assets + level save
# (no shipped samples of these formats in the reference checkout, so each
# is pinned by write -> load round-trip through our cereal-JSON dialect)
# ---------------------------------------------------------------------------


def test_arkset_hierarchy_instantiates(tmp_path):
    from arkoserenderer.assets.ark import load_arkset, save_arkset

    # A two-level node tree: root carries a translation, child A instances
    # mesh 0 with a scale, child-of-child B instances mesh 0 again.
    box_ref = "assets/sample/models/Box/Box.arkmsh"
    root_node = {
        "name": "root",
        "transform": {"translation": {"x": 1.0, "y": 0.0, "z": 0.0},
                      "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                      "scale": {"x": 1, "y": 1, "z": 1}},
        "meshIndex": -1,
        "children": [{
            "name": "A",
            "transform": {"translation": {"x": 0.0, "y": 2.0, "z": 0.0},
                          "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                          "scale": {"x": 2, "y": 2, "z": 2}},
            "meshIndex": 0,
            "children": [{
                "name": "B",
                "transform": {"translation": {"x": 0.0, "y": 0.0, "z": 3.0},
                              "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                              "scale": {"x": 1, "y": 1, "z": 1}},
                "meshIndex": 0,
                "children": [],
            }],
        }],
    }
    # Write under a dir that has the reference assets root layout by
    # pointing meshAssets at the mounted reference tree.
    set_path = ASSETS / "sample" / "_tmp_test.arkset"
    set_path = tmp_path / "assets" / "sample" / "sets" / "test.arkset"
    set_path.parent.mkdir(parents=True)
    import shutil

    # Mirror Box.arkmsh + its material into the tmp assets root so path
    # resolution exercises find_assets_root.
    box_dir = tmp_path / "assets" / "sample" / "models" / "Box"
    box_dir.mkdir(parents=True)
    shutil.copy(ASSETS / "sample/models/Box/Box.arkmsh", box_dir)
    for mat in (ASSETS / "sample/models/Box").glob("*.arkmat"):
        shutil.copy(mat, box_dir)
    save_arkset(set_path, root_node, [box_ref], name="test-set")

    scene = small_scene()
    info = load_arkset(scene, set_path)
    assert info["nodes"] == 3
    assert info["instances"] == 2
    assert not info["missing"]
    # Child A world translation = root(1,0,0) + A(0,2,0); B adds (0,0,3)
    # scaled by A's 2x scale.
    wa = scene.instance_transform(info["instance_ids"][0])
    np.testing.assert_allclose(wa[:3, 3], [1.0, 2.0, 0.0], atol=1e-6)
    assert wa[0, 0] == 2.0
    wb = scene.instance_transform(info["instance_ids"][1])
    np.testing.assert_allclose(wb[:3, 3], [1.0, 2.0, 6.0], atol=1e-6)


def test_arkskel_roundtrip_and_pose(tmp_path):
    from arkoserenderer.assets.ark import load_arkskel, save_arkskel
    from arkoserenderer.scene.animation import Skeleton, evaluate_pose

    rng = np.random.default_rng(7)
    n = 4
    parents = np.array([-1, 0, 1, 1], np.int32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    skel = Skeleton(
        parents=parents,
        inverse_bind=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
        rest_translation=rng.normal(size=(n, 3)).astype(np.float32),
        rest_rotation=q,
        rest_scale=np.ones((n, 3), np.float32),
    )
    skel.inverse_bind[2, :3, 3] = (0.5, -1.0, 2.0)
    p = tmp_path / "test.arkskel"
    save_arkskel(p, skel, ["hips", "spine", "armL", "armR"])
    skel2, names = load_arkskel(p)
    assert names == ["hips", "spine", "armL", "armR"]
    np.testing.assert_array_equal(skel2.parents, parents)
    np.testing.assert_allclose(skel2.inverse_bind, skel.inverse_bind, atol=1e-6)
    np.testing.assert_allclose(skel2.rest_translation, skel.rest_translation,
                               atol=1e-6)
    # Sign-insensitive quat compare.
    dots = np.abs(np.sum(skel2.rest_rotation * skel.rest_rotation, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)
    # Identical palettes from both skeletons.
    pal1, _ = evaluate_pose(skel, None, 0.0)
    pal2, _ = evaluate_pose(skel2, None, 0.0)
    np.testing.assert_allclose(pal1, pal2, atol=1e-5)


def test_arkanim_roundtrip_drives_pose(tmp_path):
    from arkoserenderer.assets.ark import (
        load_arkanim, load_arkskel, save_arkanim, save_arkskel,
    )
    from arkoserenderer.scene.animation import (
        AnimationClip, AnimChannel, INTERP_LINEAR, INTERP_STEP, Skeleton,
        evaluate_pose,
    )

    skel = Skeleton(
        parents=np.array([-1, 0], np.int32),
        inverse_bind=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        rest_translation=np.zeros((2, 3), np.float32),
        rest_rotation=np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1)),
        rest_scale=np.ones((2, 3), np.float32),
    )
    names = ["root", "tip"]
    times = np.array([0.0, 1.0, 2.0], np.float32)
    clip = AnimationClip(channels=[
        AnimChannel(target_joint=1, path="translation", times=times,
                    values=np.array([[0, 0, 0], [0, 1, 0], [0, 2, 0]],
                                    np.float32),
                    interpolation=INTERP_LINEAR),
        AnimChannel(target_joint=0, path="rotation", times=times,
                    values=np.array([[0, 0, 0, 1]] * 3, np.float32),
                    interpolation=INTERP_STEP),
        AnimChannel(target_joint=-1, path="weights", times=times,
                    values=np.array([[0.0], [0.5], [1.0]], np.float32),
                    interpolation=INTERP_LINEAR),
    ], name="bob")
    pskel = tmp_path / "a.arkskel"
    panim = tmp_path / "a.arkanim"
    save_arkskel(pskel, skel, names)
    save_arkanim(panim, clip, names)

    skel2, names2 = load_arkskel(pskel)
    clip2 = load_arkanim(panim, joint_names=names2)
    assert clip2.name == "bob"
    assert len(clip2.channels) == 3
    assert clip2.duration == 2.0
    # Shared time track deduplicated in the file.
    import json as _json
    doc = _json.loads(panim.read_text())["animation"]
    assert len(doc["inputTracks"]) == 1
    # Same pose at an interpolated time from both clips.
    pal1, w1 = evaluate_pose(skel, clip, 0.5)
    pal2, w2 = evaluate_pose(skel2, clip2, 0.5)
    np.testing.assert_allclose(pal1, pal2, atol=1e-6)
    np.testing.assert_allclose(w1, w2, atol=1e-6)
    np.testing.assert_allclose(pal2[1, 1, 3], 0.5, atol=1e-6)


def test_arkhair_roundtrip(tmp_path):
    from arkoserenderer.assets.ark import load_arkhair, save_arkhair

    # Two strands: 3 points and 4 points.
    pts = np.array([[0, 0, 0], [0, 1, 0], [0, 2, 0],
                    [1, 0, 0], [1, 1, 0], [1, 2, 0], [1, 3, 0]], np.float32)
    segs = np.array([2, 3], np.int32)
    thick = np.linspace(0.01, 0.02, 7).astype(np.float32)
    p = tmp_path / "test.arkhair"
    save_arkhair(p, pts, segs, thickness=thick)
    scene = small_scene()
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = (0, 0, 5)
    info = load_arkhair(scene, p, transform=xf)
    assert info["strands"] == 2
    assert info["points"] == 7
    assert scene._hair is not None
    hp, ht, hr, hseg = scene._hair
    np.testing.assert_allclose(hp[:, 2], 5.0, atol=1e-6)
    np.testing.assert_allclose(hp[:, :2], pts[:, :2], atol=1e-6)
    np.testing.assert_allclose(hr, thick * 0.5, atol=1e-7)


def test_arklvl_save_roundtrip_with_editor_edit(tmp_path):
    """Level -> scene -> gizmo-style transform edit -> sync -> save -> load:
    the edited transform survives the round trip (LevelAsset.h:135 save)."""
    import shutil

    from arkoserenderer.assets.ark import LevelDocument, load_arklvl

    # Build a tmp assets root with Box.arkmsh and a level referencing it.
    box_dir = tmp_path / "assets" / "sample" / "models" / "Box"
    box_dir.mkdir(parents=True)
    shutil.copy(ASSETS / "sample/models/Box/Box.arkmsh", box_dir)
    for mat in (ASSETS / "sample/models/Box").glob("*.arkmat"):
        shutil.copy(mat, box_dir)
    lvl_dir = tmp_path / "assets" / "sample" / "levels"
    lvl_dir.mkdir(parents=True)
    src = json.loads((ASSETS / "sample/levels/CornellBox.arklvl").read_text())
    src["level"]["objects"][0]["mesh"]["data"] = \
        "assets/sample/models/Box/Box.arkmsh"
    lvl_path = lvl_dir / "test.arklvl"
    lvl_path.write_text(json.dumps(src, indent=4))

    scene = small_scene()
    res = load_arklvl(scene, lvl_path)
    assert res["instances"] == 1 and not res["missing"]
    doc = res["doc"]

    # Editor-style edit: move the object.
    from arkoserenderer.scene.editor import EditorScene

    ed = EditorScene(scene=scene)
    ed.selected = doc.object_instances[0][0]
    ed.translate((3.0, 0.5, -1.0))
    assert doc.sync_from_scene(scene) == 1

    out_path = lvl_dir / "edited.arklvl"
    doc.write(out_path)

    # Reload: the translation reflects the edit; untouched fields (camera,
    # env map block) survive byte-identical JSON round-trip.
    scene2 = small_scene()
    res2 = load_arklvl(scene2, out_path)
    w = scene2.instance_transform(res2["doc"].object_instances[0][0])
    orig_t = np.array([0.0, 0.0, 0.0], np.float32)
    np.testing.assert_allclose(w[:3, 3], orig_t + [3.0, 0.5, -1.0], atol=1e-5)
    reloaded = json.loads(out_path.read_text())
    assert reloaded["level"]["cameras"] == src["level"]["cameras"]
    assert reloaded["level"]["environmentMap"] == src["level"]["environmentMap"]
