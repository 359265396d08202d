"""Every product that makes a position asks for full float32 (HIGHEST):
checked in the traced programs, where it holds on every platform, and
against float64 NumPy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from arkoserenderer.core import mathx as mx

HIGHEST = jax.lax.Precision.HIGHEST


def dot_precisions(fn, *args):
    """Precision of every dot_general in the traced program (nested ones
    included)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def assert_all_highest(fn, *args):
    precs = dot_precisions(fn, *args)
    assert precs, "no matrix product traced"
    for p in precs:
        assert p is not None and all(q == HIGHEST for q in p), precs


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def flagship():
    from arkoserenderer.assets.procedural import build_flagship_scene

    scene, cam = build_flagship_scene(n_instances=16, n_materials=4,
                                      n_textures=4, viewport=(64, 32))
    return scene, cam, scene.build(), cam.state(0)


def test_matmul_is_highest_and_matches_float64(rng):
    a = rng.normal(size=(500, 4)).astype(np.float32)
    b = rng.normal(size=(4, 4)).astype(np.float32)
    assert_all_highest(mx.matmul, a, b)
    assert rel_err(mx.matmul(a, b), a.astype(np.float64) @ b) < 1e-6
    assert isinstance(mx.matmul(a, b, xp=np), np.ndarray)


def test_camera_view_proj_is_highest(flagship):
    *_, cs = flagship
    assert_all_highest(lambda c: c.view_proj, cs)
    ref = np.asarray(cs.proj_from_view, np.float64) @ np.asarray(
        cs.view_from_world, np.float64)
    assert rel_err(cs.view_proj, ref) < 1e-6


def test_vertex_clip_is_highest(flagship):
    from arkoserenderer.rendering.passes.geometry import transform_vertices_clip

    _, _, sa, cs = flagship
    assert_all_highest(transform_vertices_clip, sa, cs.view_proj, sa.positions)
    clip = transform_vertices_clip(sa, cs.view_proj, sa.positions)
    w = np.asarray(sa.world, np.float64)[np.asarray(sa.vertex_instance)]
    p = np.concatenate([np.asarray(sa.positions, np.float64),
                        np.ones((sa.positions.shape[0], 1))], -1)
    ref = np.einsum("ij,vjk,vk->vi", np.asarray(cs.view_proj, np.float64), w, p)
    assert rel_err(clip, ref) < 1e-5


def test_skinning_is_highest(rng):
    from arkoserenderer.ops.skinning import skin_vertices

    v, j = 200, 8
    pal = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
    pal[:, :3, 3] = rng.normal(size=(j, 3))
    args = (rng.normal(size=(v, 3)).astype(np.float32),
            rng.normal(size=(v, 3)).astype(np.float32),
            rng.normal(size=(v, 4)).astype(np.float32),
            rng.integers(0, j, (v, 4)).astype(np.int32),
            np.full((v, 4), 0.25, np.float32), pal)
    assert_all_highest(skin_vertices, *args)
    got = skin_vertices(*args)[0]
    ref = args[0] + np.asarray(pal, np.float64)[args[3]][:, :, :3, 3].mean(1)
    assert rel_err(got, ref) < 1e-5


def test_ray_hit_surface_is_highest(flagship):
    from arkoserenderer.ops.bvh import Hit
    from arkoserenderer.ops.rt import surface_at_hits

    _, _, sa, _ = flagship
    r = 64
    hit = Hit(t=jnp.ones(r), tri=jnp.arange(r, dtype=jnp.int32),
              u=jnp.full(r, 0.25), v=jnp.full(r, 0.25), hit=jnp.ones(r, bool))
    assert_all_highest(lambda s, h: surface_at_hits(s, h)[0], sa, hit)


def test_unprojection_sites_are_highest(rng):
    from arkoserenderer.ops.shadow_denoise import camera_velocity
    from arkoserenderer.ops.ssao import reconstruct_world_pos

    m = rng.normal(size=(4, 4)).astype(np.float32)
    px = np.arange(16, dtype=np.float32)
    assert_all_highest(
        lambda d: reconstruct_world_pos(d, px, px, m, 16, 16), px / 16)
    world = rng.normal(size=(4, 4, 3)).astype(np.float32)
    assert_all_highest(lambda w: camera_velocity(w, px, px, m, 4, 4), world)


def test_instance_inverse_is_highest(rng):
    from arkoserenderer.ops.bvh import _affine_inverse

    m = np.tile(np.eye(3, 4, dtype=np.float32), (8, 1, 1))
    m[:, :, 3] = rng.normal(size=(8, 3))
    assert_all_highest(_affine_inverse, m)
    full = np.concatenate([m, np.tile([[[0, 0, 0, 1.0]]], (8, 1, 1))], 1)
    assert rel_err(_affine_inverse(m), np.linalg.inv(full)[:, :3]) < 1e-6


@pytest.mark.parametrize("precision", [jax.lax.Precision.DEFAULT, HIGHEST])
def test_ddgi_probe_estimates_against_float64(rng, precision):
    from arkoserenderer.ops import ddgi

    rays, n = 32, 4
    dirs = rng.normal(size=(rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rad = rng.random((n, rays, 3)).astype(np.float32)
    dist = (rng.random((n, rays)) * 8).astype(np.float32)
    irr, vis = ddgi.probe_estimates(dirs, rad, dist, precision)
    tex = ddgi._texel_dirs(ddgi.IRRADIANCE_RES).astype(np.float64)
    w = np.maximum(tex @ dirs.T.astype(np.float64), 0)
    ref = np.einsum("tr,nrc->ntc", w, rad) / np.maximum(w.sum(1), 1e-4)[None, :, None]
    assert rel_err(np.asarray(irr).reshape(n, -1, 3), ref) < 1e-5
    assert np.isfinite(np.asarray(vis)).all()
