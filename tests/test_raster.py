import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.types import VIS_NONE, RasterConfig
from arkoserenderer.ops import raster
from arkoserenderer.ops.raster_reference import rasterize_numpy

CFG = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=64, bin_chunk=32)
W, H = 64, 64


def random_tri_soup(rng, n, z_range=(-10.0, -2.0)):
    """Random world-space triangles in front of a simple camera."""
    centers = np.stack(
        [
            rng.uniform(-3, 3, n),
            rng.uniform(-3, 3, n),
            rng.uniform(*z_range, n),
        ],
        axis=-1,
    )
    offs = rng.normal(size=(n, 3, 3)) * 0.8
    verts = (centers[:, None, :] + offs).astype(np.float32).reshape(-1, 3)
    idx = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    return verts, idx


def project(verts):
    proj = mx.perspective_reverse_z(np.radians(70.0), W / H, 0.1, 100.0)
    return np.asarray(mx.transform_points_h(proj, jnp.asarray(verts)))


def test_single_triangle_center():
    verts = np.array(
        [[-1.0, -1.0, -5.0], [1.0, -1.0, -5.0], [0.0, 1.5, -5.0]], np.float32
    )
    clip = project(verts)
    idx = np.array([[0, 1, 2]], np.int32)
    valid = np.array([True])
    vis, depth, setup, bins = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(valid), width=W, height=H, cfg=CFG
    )
    vis = np.asarray(vis)
    depth = np.asarray(depth)
    # Center pixel covered by triangle 0; corners background.
    assert vis[H // 2, W // 2] == 0
    assert vis[0, 0] == VIS_NONE and vis[-1, -1] == VIS_NONE
    assert depth[H // 2, W // 2] > 0.0
    assert int(bins.overflow) == 0


def test_winding_cull():
    verts = np.array(
        [[-1.0, -1.0, -5.0], [1.0, -1.0, -5.0], [0.0, 1.5, -5.0]], np.float32
    )
    clip = project(verts)
    # Reversed winding -> culled when cull_backfaces=True, drawn when False.
    idx = np.array([[0, 2, 1]], np.int32)
    valid = np.array([True])
    vis, _, _, _ = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(valid), width=W, height=H, cfg=CFG
    )
    assert np.all(np.asarray(vis) == VIS_NONE)
    vis2, _, _, _ = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(valid),
        width=W, height=H, cfg=CFG, cull_backfaces=False,
    )
    assert np.any(np.asarray(vis2) == 0)


def test_matches_numpy_reference(rng):
    verts, idx = random_tri_soup(rng, 40)
    clip = project(verts)
    valid = np.ones(len(idx), bool)
    vis, depth, _, bins = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(valid),
        width=W, height=H, cfg=CFG, cull_backfaces=False,
    )
    ref_vis, ref_depth = rasterize_numpy(clip, idx, valid, W, H, cull_backfaces=False)
    assert int(bins.overflow) == 0
    vis, depth = np.asarray(vis), np.asarray(depth)
    # Coverage must match exactly; ids may differ only where depths tie.
    np.testing.assert_array_equal(vis == VIS_NONE, ref_vis == VIS_NONE)
    mismatched = vis != ref_vis
    assert mismatched.mean() < 0.001
    np.testing.assert_allclose(depth, ref_depth, atol=1e-5)


def test_depth_ordering(rng):
    # Two overlapping quads, the nearer must win everywhere they overlap.
    def quad(z, s=2.0):
        return np.array(
            [[-s, -s, z], [s, -s, z], [s, s, z], [-s, -s, z], [s, s, z], [-s, s, z]],
            np.float32,
        )

    verts = np.concatenate([quad(-8.0), quad(-4.0, s=1.0)])
    idx = np.arange(12, dtype=np.int32).reshape(4, 3)
    clip = project(verts)
    valid = np.ones(4, bool)
    vis, depth, _, _ = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.asarray(valid), width=W, height=H, cfg=CFG
    )
    vis = np.asarray(vis)
    center = vis[H // 2, W // 2]
    assert center in (2, 3)  # near quad triangles win at center


def test_bin_overflow_counted():
    # 100 identical triangles on one tile with tiny capacity.
    verts = np.tile(
        np.array([[-0.2, -0.2, -5.0], [0.2, -0.2, -5.0], [0.0, 0.2, -5.0]], np.float32),
        (100, 1),
    )
    idx = np.arange(300, dtype=np.int32).reshape(100, 3)
    clip = project(verts)
    cfg = RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=8, bin_chunk=16)
    _, _, _, bins = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(100, dtype=bool),
        width=W, height=H, cfg=cfg,
    )
    assert int(bins.overflow) > 0
    assert int(np.asarray(bins.counts).max()) == 8


def test_tiled_roundtrip(rng):
    img = rng.normal(size=(H, W, 3)).astype(np.float32)
    t = raster.image_to_tiled(jnp.asarray(img), CFG)
    back = raster.tiled_to_image(t, W, H, CFG)
    np.testing.assert_array_equal(np.asarray(back), img)


def test_near_plane_clipping_floor():
    # A huge floor quad extending behind the camera: without clipping these
    # triangles would be dropped entirely. With clipping, the floor must
    # cover the bottom of the screen, and interpolated original barycentrics
    # must still reproject onto the pixel exactly.
    import jax.numpy as jnp
    from arkoserenderer.ops import interpolate as ip

    verts = np.array(
        [[-50.0, -1.0, 50.0], [50.0, -1.0, 50.0], [50.0, -1.0, -50.0], [-50.0, -1.0, -50.0]],
        np.float32,
    )
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    view = mx.look_at(np.array([0.0, 1.0, 0.0], np.float32), np.array([0.0, 0.0, -10.0], np.float32))
    proj = mx.perspective_reverse_z(np.radians(70.0), W / H, 0.1, 1000.0)
    vp = np.asarray(proj @ view)
    clip = np.asarray(mx.transform_points_h(jnp.asarray(vp), jnp.asarray(verts)))
    assert np.any(clip[:, 3] < 0)  # some vertices genuinely behind the camera

    vis, depth, setup, bins = raster.rasterize(
        jnp.asarray(clip), jnp.asarray(idx), jnp.ones(2, bool), width=W, height=H,
        cfg=CFG, w_eps=0.1,  # = camera near: the correct clip plane
    )
    vis_np = np.asarray(vis)
    assert int(setup.clip_overflow) == 0
    # Bottom rows fully covered by the floor, top rows are sky.
    assert np.all(vis_np[-1, :] >= 0)
    assert np.all(vis_np[0, :] == -1)
    # Reconstruct world positions through original barycentrics: y == -1.
    xs = (np.arange(W) + 0.5).astype(np.float32)
    ys = (np.arange(H) + 0.5).astype(np.float32)
    px, py = np.meshgrid(xs, ys)
    geom = ip.pixel_barycentrics(
        vis.reshape(-1), setup, jnp.asarray(idx), jnp.asarray(px.ravel()), jnp.asarray(py.ravel())
    )
    world = np.asarray(ip.interpolate(jnp.asarray(verts), geom))
    valid = np.asarray(geom.valid)
    np.testing.assert_allclose(world[valid, 1], -1.0, atol=1e-3)
    # Reprojection check on covered pixels.
    reclip = np.asarray(mx.transform_points_h(jnp.asarray(vp), jnp.asarray(world)))
    sx = (reclip[:, 0] / reclip[:, 3] * 0.5 + 0.5) * W
    sy = (0.5 - reclip[:, 1] / reclip[:, 3] * 0.5) * H
    # f32 edge functions lose ~0.1px of precision when clipped corners land
    # far off-screen (TODO: guard-band clip for tighter bounds).
    np.testing.assert_allclose(sx[valid], px.ravel()[valid], atol=0.5)
    np.testing.assert_allclose(sy[valid], py.ravel()[valid], atol=0.5)


def test_tile_chunked_raster_matches_plain(monkeypatch):
    """The occupancy-sorted tile-chunk dispatch (total work ~ sum of tile
    counts instead of ntiles x max) must be bit-identical to the plain
    vmap path."""
    import jax.numpy as jnp

    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.ops import raster as R

    scene, cam = build_test_scene(viewport=(128, 128))
    arrays = scene.build()
    cfg = RasterConfig(tile_h=8, tile_w=8, max_tris_per_tile=256, bin_chunk=512)
    clipm = cam.state(0).view_proj
    from arkoserenderer.core import mathx as mx

    w = np.asarray(arrays.world)[np.asarray(arrays.vertex_instance)]
    wp = np.einsum("vij,vj->vi", w[:, :3, :3], np.asarray(arrays.positions)) + w[:, :3, 3]
    clip = np.asarray(mx.transform_points_h(np.asarray(clipm), wp))
    args = (jnp.asarray(clip), arrays.indices, arrays.tri_valid)

    def run():
        vis, depth, _, _ = R.rasterize(
            *args, width=128, height=128, cfg=cfg, cull_backfaces=True
        )
        return np.asarray(vis), np.asarray(depth)

    # 128/8 * 128/8 = 256 tiles: force BOTH paths via the chunk constant.
    monkeypatch.setattr(R, "TILE_CHUNK", 64)       # 256 > 2*64 -> chunked
    vis_c, depth_c = run()
    monkeypatch.setattr(R, "TILE_CHUNK", 100000)   # plain vmap
    vis_p, depth_p = run()
    np.testing.assert_array_equal(vis_c, vis_p)
    np.testing.assert_array_equal(depth_c, depth_p)
