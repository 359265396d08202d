import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.ops import interpolate as ip
from arkoserenderer.ops import raster

W, H = 64, 64
CFG = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64, bin_chunk=32)


def test_perspective_correct_interpolation():
    # A floor-like quad receding in depth: screen-space midpoint must NOT be
    # the attribute midpoint (perspective correction), and the interpolated
    # attribute must match the analytic projection-inverse.
    verts = np.array(
        [[-2.0, -1.0, -2.0], [2.0, -1.0, -2.0], [2.0, -1.0, -20.0], [-2.0, -1.0, -20.0]],
        np.float32,
    )
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    view = mx.look_at(np.zeros(3, np.float32), np.array([0.0, -1.0, -10.0], np.float32))
    proj = mx.perspective_reverse_z(np.radians(60.0), W / H, 0.1, 100.0)
    clip = np.asarray(mx.transform_points_h(proj @ view, jnp.asarray(verts)))

    vis, depth, setup, bins = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(2, bool),
        width=W, height=H, cfg=CFG, cull_backfaces=False,
    )
    xs = (np.arange(W) + 0.5).astype(np.float32)
    ys = (np.arange(H) + 0.5).astype(np.float32)
    px, py = np.meshgrid(xs, ys)
    geom = ip.pixel_barycentrics(
        vis.reshape(-1), setup, jnp.asarray(idx), jnp.asarray(px.ravel()), jnp.asarray(py.ravel())
    )
    # Interpolate world positions; then re-project: must land on the pixel.
    world = ip.interpolate(jnp.asarray(verts), geom)
    valid = np.asarray(geom.valid)
    assert valid.sum() > 100
    reclip = np.asarray(mx.transform_points_h(proj @ view, world))
    sx = (reclip[:, 0] / reclip[:, 3] * 0.5 + 0.5) * W
    sy = (0.5 - reclip[:, 1] / reclip[:, 3] * 0.5) * H
    np.testing.assert_allclose(sx[valid], px.ravel()[valid], atol=0.02)
    np.testing.assert_allclose(sy[valid], py.ravel()[valid], atol=0.02)
    # Interpolated world y must be exactly the plane height.
    np.testing.assert_allclose(np.asarray(world)[valid, 1], -1.0, atol=1e-3)


def test_gradients_match_finite_difference():
    verts = np.array(
        [[-3.0, -2.0, -5.0], [3.0, -2.0, -5.0], [0.0, 3.0, -9.0]], np.float32
    )
    uvs = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    proj = mx.perspective_reverse_z(np.radians(70.0), W / H, 0.1, 100.0)
    clip = np.asarray(mx.transform_points_h(proj, jnp.asarray(verts)))
    vis, _, setup, _ = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(1, bool), width=W, height=H, cfg=CFG
    )
    xs = (np.arange(W) + 0.5).astype(np.float32)
    ys = (np.arange(H) + 0.5).astype(np.float32)
    px, py = np.meshgrid(xs, ys)
    geom = ip.pixel_barycentrics(
        vis.reshape(-1), setup, jnp.asarray(idx), jnp.asarray(px.ravel()), jnp.asarray(py.ravel())
    )
    uv, duv_dx, duv_dy = ip.interpolate_with_grad(jnp.asarray(uvs), geom)
    uv = np.asarray(uv).reshape(H, W, 2)
    duv_dx = np.asarray(duv_dx).reshape(H, W, 2)
    duv_dy = np.asarray(duv_dy).reshape(H, W, 2)
    valid = np.asarray(geom.valid).reshape(H, W)
    # Compare against finite differences of the interpolated UV field where
    # both neighbors are interior.
    inner = valid & np.roll(valid, -1, 1) & np.roll(valid, -1, 0)
    fd_x = np.roll(uv, -1, 1) - uv
    fd_y = np.roll(uv, -1, 0) - uv
    np.testing.assert_allclose(duv_dx[inner], fd_x[inner], atol=1e-4)
    np.testing.assert_allclose(duv_dy[inner], fd_y[inner], atol=1e-4)
