"""Skeleton evaluation, skinning kernel, and end-to-end skinned rendering."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops.skinning import apply_morphs, skin_vertices
from arkoserenderer.scene.animation import (
    AnimChannel,
    AnimationClip,
    INTERP_LINEAR,
    INTERP_STEP,
    Skeleton,
    evaluate_pose,
    sample_channel,
)

SAMPLES = Path("/root/reference/assets/assets/sample/models")


def two_bone_skeleton():
    return Skeleton(
        parents=np.array([-1, 0], np.int32),
        inverse_bind=np.stack([np.eye(4), np.eye(4)]).astype(np.float32),
        rest_translation=np.zeros((2, 3), np.float32),
        rest_rotation=np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1)),
        rest_scale=np.ones((2, 3), np.float32),
    )


def test_rest_pose_palette_is_identity():
    palette, _ = evaluate_pose(two_bone_skeleton(), None, 0.0)
    np.testing.assert_allclose(palette, np.stack([np.eye(4)] * 2), atol=1e-6)


def test_channel_sampling_linear_step():
    ch = AnimChannel(
        target_joint=0, path="translation",
        times=np.array([0.0, 1.0, 2.0], np.float32),
        values=np.array([[0, 0, 0], [2, 0, 0], [2, 4, 0]], np.float32),
        interpolation=INTERP_LINEAR,
    )
    np.testing.assert_allclose(sample_channel(ch, 0.5), [1, 0, 0])
    np.testing.assert_allclose(sample_channel(ch, 1.5), [2, 2, 0])
    np.testing.assert_allclose(sample_channel(ch, 5.0), [2, 4, 0])  # clamp
    ch.interpolation = INTERP_STEP
    np.testing.assert_allclose(sample_channel(ch, 0.99), [0, 0, 0])


def test_parent_chain_composition():
    skel = two_bone_skeleton()
    # Root translated +X 1; child local translation +Y 2 => child world (1,2,0).
    clip = AnimationClip(channels=[
        AnimChannel(0, "translation", np.array([0.0], np.float32), np.array([[1, 0, 0]], np.float32)),
        AnimChannel(1, "translation", np.array([0.0], np.float32), np.array([[0, 2, 0]], np.float32)),
    ])
    palette, _ = evaluate_pose(skel, clip, 0.0)
    np.testing.assert_allclose(palette[1][:3, 3], [1, 2, 0], atol=1e-6)


def test_skinning_rigid_rotation():
    # Single joint rotating 90 deg about Z: skinned verts = rotated verts.
    q = np.asarray(mx.quat_from_axis_angle(np.array([0, 0, 1.0]), np.pi / 2, xp=np))
    m = mx.compose_trs(np.zeros(3), q, np.ones(3), xp=np)
    palette = jnp.asarray(m[None])
    pos = np.array([[1, 0, 0], [0, 1, 0], [0.5, 0.5, 2.0]], np.float32)
    nrm = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tan = np.concatenate([nrm, np.ones((3, 1), np.float32)], -1)
    joints = jnp.zeros((3, 4), jnp.int32)
    weights = jnp.asarray(np.array([[1, 0, 0, 0]] * 3, np.float32))
    p2, n2, t2 = skin_vertices(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(tan), joints, weights, palette)
    rot = np.asarray(mx.quat_to_mat3(q, xp=np))
    np.testing.assert_allclose(np.asarray(p2), pos @ rot.T, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n2), nrm @ rot.T, atol=1e-5)


def test_static_vertices_untouched():
    pos = jnp.asarray(np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32))
    nrm = jnp.asarray(np.tile(np.array([[0, 1, 0]], np.float32), (8, 1)))
    tan = jnp.asarray(np.tile(np.array([[1, 0, 0, 1]], np.float32), (8, 1)))
    joints = jnp.zeros((8, 4), jnp.int32)
    weights = jnp.zeros((8, 4))  # zero weights = static
    palette = jnp.asarray(np.tile(np.eye(4, dtype=np.float32) * 5, (1, 1, 1)))
    p2, n2, t2 = skin_vertices(pos, nrm, tan, joints, weights, palette)
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(pos))


def test_blended_weights_interpolate():
    # Two joints: identity and +2X translation; 50/50 weights -> +1X.
    palette = jnp.asarray(np.stack([
        np.eye(4, dtype=np.float32),
        np.asarray(mx.translation(np.array([2, 0, 0], np.float32), xp=np)),
    ]))
    pos = jnp.asarray(np.array([[0, 0, 0]], np.float32))
    nrm = jnp.asarray(np.array([[0, 0, 1]], np.float32))
    tan = jnp.asarray(np.array([[1, 0, 0, 1]], np.float32))
    joints = jnp.asarray(np.array([[0, 1, 0, 0]], np.int32))
    weights = jnp.asarray(np.array([[0.5, 0.5, 0, 0]], np.float32))
    p2, _, _ = skin_vertices(pos, nrm, tan, joints, weights, palette)
    np.testing.assert_allclose(np.asarray(p2), [[1, 0, 0]], atol=1e-6)


def test_morph_targets_blend():
    pos = jnp.asarray(np.zeros((10, 3), np.float32))
    nrm = jnp.asarray(np.tile(np.array([[0, 0, 1]], np.float32), (10, 1)))
    morph_pos = jnp.asarray(np.stack([
        np.tile(np.array([[1, 0, 0]], np.float32), (4, 1)),
        np.tile(np.array([[0, 2, 0]], np.float32), (4, 1)),
    ]))
    morph_nrm = jnp.zeros((2, 4, 3))
    w = jnp.asarray(np.array([0.5, 0.25], np.float32))
    p2, n2 = apply_morphs(pos, nrm, morph_pos, morph_nrm, w, vertex_offset=3)
    out = np.asarray(p2)
    np.testing.assert_allclose(out[3:7], np.tile([[0.5, 0.5, 0]], (4, 1)), atol=1e-6)
    np.testing.assert_allclose(out[:3], 0.0)
    np.testing.assert_allclose(out[7:], 0.0)


@pytest.mark.skipif(not SAMPLES.exists(), reason="no sample assets")
def test_cesium_man_animates():
    from arkoserenderer.assets.gltf import load_gltf
    from arkoserenderer.assets.procedural import gradient_env_map
    from arkoserenderer.core.types import RasterConfig, SceneLimits
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight
    from arkoserenderer.scene.scene import Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 16, max_indices=3 << 16, max_drawables=16,
        max_materials=8, max_textures=16, texture_pool_texels=1 << 21,
    ))
    res = load_gltf(scene, SAMPLES / "CesiumMan" / "CesiumMan.gltf", max_texture_size=64)
    assert scene.skeletons and scene.animations
    info = scene.static_info()
    assert info.has_skin
    scene.sun = DirectionalLight()
    scene.set_env_map(gradient_env_map(16), brightness=8000.0)
    cam = Camera(viewport=(96, 96))
    center, radius = scene.bounding_sphere()
    cam.look_at(center + np.array([0, radius * 0.2, radius * 2.2]), center)
    cfg = PipelineConfig(
        width=96, height=96,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
        shadow_map_size=128,
    )
    r = Renderer(scene, cam, cfg, taa=False, bloom=False)
    img0 = np.array(r.render_frame(delta_time=0.4))
    img1 = np.array(r.render_frame(delta_time=0.4))
    img2 = np.array(r.render_frame(delta_time=0.4))
    vis = np.asarray(r.state["Visibility"])
    assert (vis >= 0).mean() > 0.02  # character visible
    # Animation actually moves geometry between frames.
    assert np.abs(img2 - img1).max() > 0.05
