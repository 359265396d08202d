import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx


def test_quat_rotate_matches_mat3(rng):
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    out_q = np.asarray(mx.quat_rotate(jnp.asarray(q), jnp.asarray(v)))
    m = np.asarray(mx.quat_to_mat3(jnp.asarray(q)))
    out_m = np.einsum("nij,nj->ni", m, v)
    np.testing.assert_allclose(out_q, out_m, atol=1e-5)


def test_quat_mul_composes_rotation(rng):
    a = np.asarray(mx.quat_from_axis_angle(np.array([0, 1, 0]), 0.7))
    b = np.asarray(mx.quat_from_axis_angle(np.array([1, 0, 0]), -0.3))
    v = rng.normal(size=(8, 3)).astype(np.float32)
    ab = mx.quat_mul(jnp.asarray(a), jnp.asarray(b))
    out1 = np.asarray(mx.quat_rotate(ab, jnp.asarray(v)))
    out2 = np.asarray(mx.quat_rotate(jnp.asarray(a), mx.quat_rotate(jnp.asarray(b), jnp.asarray(v))))
    np.testing.assert_allclose(out1, out2, atol=1e-5)


def test_look_at_places_target_on_minus_z():
    eye = np.array([1.0, 2.0, 3.0], np.float32)
    target = np.array([4.0, 2.0, -1.0], np.float32)
    view = mx.look_at(eye, target)
    t_view = np.asarray(mx.transform_points(view, jnp.asarray(target)[None]))[0]
    assert t_view[2] < 0.0
    np.testing.assert_allclose(t_view[:2], 0.0, atol=1e-5)
    e_view = np.asarray(mx.transform_points(view, jnp.asarray(eye)[None]))[0]
    np.testing.assert_allclose(e_view, 0.0, atol=1e-5)


def test_perspective_reverse_z_depth_range():
    proj = mx.perspective_reverse_z(np.radians(60.0), 16 / 9, near=0.1, far=100.0)
    for z, expected in [(-0.1, 1.0), (-100.0, 0.0)]:
        p = jnp.array([[0.0, 0.0, z]])
        clip = np.asarray(mx.transform_points_h(proj, p))[0]
        assert abs(clip[2] / clip[3] - expected) < 1e-5
    # Infinite-far variant: depth -> 0 as z -> -inf, near still maps to 1.
    proj_inf = mx.perspective_reverse_z(np.radians(60.0), 16 / 9, near=0.1)
    clip = np.asarray(mx.transform_points_h(proj_inf, jnp.array([[0.0, 0.0, -0.1]])))[0]
    assert abs(clip[2] / clip[3] - 1.0) < 1e-5
    clip = np.asarray(mx.transform_points_h(proj_inf, jnp.array([[0.0, 0.0, -1e6]])))[0]
    assert clip[2] / clip[3] < 1e-4


def test_jitter_shifts_by_exact_pixels():
    w, h = 1920, 1080
    proj = mx.perspective_reverse_z(np.radians(60.0), w / h, near=0.1, far=100.0)
    jproj = mx.apply_jitter(proj, 0.25, -0.25, w, h)
    p = jnp.array([[0.3, -0.2, -5.0]])
    c0 = np.asarray(mx.transform_points_h(proj, p))[0]
    c1 = np.asarray(mx.transform_points_h(jproj, p))[0]
    ndc0 = c0[:2] / c0[3]
    ndc1 = c1[:2] / c1[3]
    # Convention: apply_jitter(jx, jy) moves the projected position of any
    # world point by exactly (+jx, +jy) pixels in screen space (y down).
    dx_px = (ndc1[0] - ndc0[0]) * 0.5 * w
    dy_px = -(ndc1[1] - ndc0[1]) * 0.5 * h
    np.testing.assert_allclose([dx_px, dy_px], [0.25, -0.25], atol=1e-3)


def test_frustum_sphere_culling():
    view = mx.look_at(np.zeros(3, np.float32), np.array([0, 0, -1], np.float32))
    proj = mx.perspective_reverse_z(np.radians(90.0), 1.0, near=0.1, far=50.0)
    planes = mx.frustum_planes_from_matrix(proj @ view)
    centers = jnp.array(
        [
            [0.0, 0.0, -10.0],   # inside
            [0.0, 0.0, 10.0],    # behind camera
            [0.0, 0.0, -100.0],  # beyond far
            [30.0, 0.0, -10.0],  # far right outside
            [11.0, 0.0, -10.0],  # just outside right plane but radius reaches in
        ]
    )
    radii = jnp.array([1.0, 1.0, 1.0, 1.0, 2.0])
    vis = np.asarray(mx.frustum_test_spheres(planes, centers, radii))
    assert vis.tolist() == [True, False, False, False, True]


def test_compose_trs_and_normal_matrix(rng):
    q = np.asarray(mx.quat_from_axis_angle(np.array([0.3, 1.0, -0.2]), 1.1))
    m = mx.compose_trs(np.array([1, 2, 3], np.float32), jnp.asarray(q), np.array([2.0, 2.0, 2.0], np.float32))
    p = rng.normal(size=(4, 3)).astype(np.float32)
    out = np.asarray(mx.transform_points(m, jnp.asarray(p)))
    expect = (np.asarray(mx.quat_to_mat3(jnp.asarray(q))) @ (2.0 * p.T)).T + np.array([1, 2, 3])
    np.testing.assert_allclose(out, expect, atol=1e-4)
    # Normal matrix of uniform scale+rotation is rotation * 1/s (direction preserved)
    nrm = np.asarray(mx.normal_matrix(m))
    n = np.array([[0.0, 1.0, 0.0]], np.float32)
    out_n = n @ nrm.T
    expect_n = n @ np.asarray(mx.quat_to_mat3(jnp.asarray(q))).T
    out_n /= np.linalg.norm(out_n)
    expect_n /= np.linalg.norm(expect_n)
    np.testing.assert_allclose(out_n, expect_n, atol=1e-5)
