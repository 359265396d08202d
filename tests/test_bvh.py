import jax.numpy as jnp
import numpy as np

from arkoserenderer.assets.procedural import make_box, make_uv_sphere
from arkoserenderer.ops import bvh as bvh_ops


def scene_soup(rng, n_tris=300):
    centers = rng.uniform(-4, 4, (n_tris, 3))
    offs = rng.normal(size=(n_tris, 3, 3)) * 0.5
    verts = (centers[:, None] + offs).reshape(-1, 3).astype(np.float32)
    tris = np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)
    return verts, tris


def random_rays(rng, n_rays=256):
    origins = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


def test_bvh_matches_brute_force(rng):
    verts, tris = scene_soup(rng)
    valid = np.ones(len(tris), bool)
    bvh = bvh_ops.build_bvh(verts, tris, valid)
    origins, dirs = random_rays(rng)
    hit = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs))
    ref_t, ref_tri = bvh_ops.trace_rays_brute(verts, tris, valid, origins, dirs)
    got_tri = np.asarray(hit.tri)
    got_t = np.asarray(hit.t)
    # Same hit/miss classification everywhere.
    np.testing.assert_array_equal(got_tri >= 0, ref_tri >= 0)
    hits = ref_tri >= 0
    np.testing.assert_allclose(got_t[hits], ref_t[hits], rtol=1e-4, atol=1e-4)
    # Triangle ids may differ only at coplanar ties; require near-total match.
    assert (got_tri[hits] == ref_tri[hits]).mean() > 0.995


def test_any_hit_terminates_consistently(rng):
    verts, tris = scene_soup(rng)
    valid = np.ones(len(tris), bool)
    bvh = bvh_ops.build_bvh(verts, tris, valid)
    origins, dirs = random_rays(rng, 128)
    closest = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs))
    any_hit = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs), any_hit=True)
    np.testing.assert_array_equal(np.asarray(any_hit.hit), np.asarray(closest.hit))


def test_sphere_hit_distance():
    seg = make_uv_sphere(1.0, rings=24, sectors=48)
    valid = np.ones(seg.num_triangles, bool)
    bvh = bvh_ops.build_bvh(seg.positions, seg.indices.reshape(-1, 3), valid)
    origins = np.array([[0, 0, 5.0], [0, 0, 5.0]], np.float32)
    dirs = np.array([[0, 0, -1.0], [0, 1.0, 0.0]], np.float32)
    hit = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs))
    assert bool(np.asarray(hit.hit)[0]) and not bool(np.asarray(hit.hit)[1])
    assert abs(float(np.asarray(hit.t)[0]) - 4.0) < 0.01  # sphere radius 1 at z=0


def test_occlusion_inside_box():
    seg = make_box((2.0, 2.0, 2.0))
    valid = np.ones(seg.num_triangles, bool)
    bvh = bvh_ops.build_bvh(seg.positions, seg.indices.reshape(-1, 3), valid)
    # Rays from the center: every direction is occluded within distance ~1.74.
    rng = np.random.default_rng(7)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.zeros((64, 3), np.float32)
    hit = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs), any_hit=True)
    assert np.asarray(hit.hit).all()
    assert np.asarray(hit.t).max() < 1.8


def test_tmax_respected(rng):
    verts, tris = scene_soup(rng, 50)
    valid = np.ones(len(tris), bool)
    bvh = bvh_ops.build_bvh(verts, tris, valid)
    origins, dirs = random_rays(rng, 64)
    near = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs), t_max=0.5)
    t = np.asarray(near.t)
    assert np.all(t <= 0.5 + 1e-5)


def test_refit_matches_brute_force_after_deformation(rng):
    """Deform every vertex, refit in-jit, and require traversal through the
    refitted tree to agree with brute force over the NEW geometry."""
    import jax

    verts, tris = scene_soup(rng)
    valid = np.ones(len(tris), bool)
    bvh = bvh_ops.build_bvh(verts, tris, valid)

    moved = verts + rng.normal(size=verts.shape).astype(np.float32) * 1.5
    refit = jax.jit(bvh_ops.refit_bvh)(bvh, jnp.asarray(moved), jnp.asarray(tris))

    origins, dirs = random_rays(rng)
    hit = bvh_ops.trace_rays(refit, jnp.asarray(origins), jnp.asarray(dirs))
    ref_t, ref_tri = bvh_ops.trace_rays_brute(moved, tris, valid, origins, dirs)
    got_tri = np.asarray(hit.tri)
    got_t = np.asarray(hit.t)
    np.testing.assert_array_equal(got_tri >= 0, ref_tri >= 0)
    hits = ref_tri >= 0
    assert hits.sum() > 20  # the deformed soup must still be hittable
    np.testing.assert_allclose(got_t[hits], ref_t[hits], rtol=1e-4, atol=1e-4)
    assert (got_tri[hits] == ref_tri[hits]).mean() > 0.995


def test_refit_node_bounds_contain_children(rng):
    verts, tris = scene_soup(rng, n_tris=64)
    valid = np.ones(len(tris), bool)
    bvh = bvh_ops.build_bvh(verts, tris, valid)
    moved = verts * 0.3 + 2.0
    refit = bvh_ops.refit_bvh(bvh, jnp.asarray(moved), jnp.asarray(tris))
    nmin = np.asarray(refit.node_min)
    nmax = np.asarray(refit.node_max)
    left = np.asarray(refit.left)
    right = np.asarray(refit.right)
    count = np.asarray(refit.count)
    internal = np.nonzero(count == 0)[0]
    for node in internal:
        for ch in (left[node], right[node]):
            assert (nmin[node] <= nmin[ch] + 1e-5).all()
            assert (nmax[node] >= nmax[ch] - 1e-5).all()


# ---- two-level TLAS/BLAS (AccelerationStructure.h:14-102 analogue) ----------


def _rand_xform(rng):
    a = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (
        np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        * rng.uniform(0.5, 2.0)
    )
    m[:3, 3] = rng.uniform(-5, 5, 3)
    return m


def _two_level_fixture(rng, n_inst=6):
    """Two shared geometries instanced with random rigid+scale transforms.

    Returns (bvh, geos, inst_blas, o2w, tris, tri_base) where ``tris`` is
    the global duplicated triangle pool (the renderer's triangle-id space).
    """
    geos = [scene_soup(rng, 40), scene_soup(rng, 25)]
    inst_blas = np.asarray(rng.integers(0, 2, n_inst), np.int32)
    o2w = np.stack([_rand_xform(rng) for _ in range(n_inst)])
    tri_base, all_t = [], []
    cur_v = cur_t = 0
    for i in range(n_inst):
        v, t = geos[inst_blas[i]]
        tri_base.append(cur_t)
        all_t.append(t + cur_v)
        cur_v += len(v)
        cur_t += len(t)
    bvh = bvh_ops.build_two_level(
        geos, inst_blas, o2w, np.asarray(tri_base, np.int32)
    )
    return bvh, geos, inst_blas, o2w, np.concatenate(all_t)


def _world_pool(geos, inst_blas, xforms):
    """Duplicated world-space vertex pool under the given transforms."""
    out = []
    for i in range(len(inst_blas)):
        v, _ = geos[inst_blas[i]]
        m = xforms[i]
        out.append(v @ m[:3, :3].T + m[:3, 3])
    return np.concatenate(out).astype(np.float32)


def test_two_level_matches_brute_force(rng):
    bvh, geos, inst_blas, o2w, tris = _two_level_fixture(rng)
    verts = _world_pool(geos, inst_blas, o2w)
    origins, dirs = random_rays(rng, 512)
    hit = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs))
    ref_t, ref_tri = bvh_ops.trace_rays_brute(
        verts, tris, np.ones(len(tris), bool), origins, dirs
    )
    got_tri = np.asarray(hit.tri)
    np.testing.assert_array_equal(got_tri >= 0, ref_tri >= 0)
    h = ref_tri >= 0
    assert h.sum() > 30
    np.testing.assert_allclose(np.asarray(hit.t)[h], ref_t[h], rtol=1e-3, atol=1e-3)
    assert (got_tri[h] == ref_tri[h]).mean() > 0.99
    any_hit = bvh_ops.trace_rays(bvh, jnp.asarray(origins), jnp.asarray(dirs), any_hit=True)
    np.testing.assert_array_equal(np.asarray(any_hit.hit), ref_tri >= 0)


def test_two_level_tlas_refit_moves_instances(rng):
    """Move every instance, refit in-jit (pure transform update — no
    geometry rebuild), and require agreement with brute force over the
    moved scene (GpuScene.cpp:872-1011 refit semantics)."""
    import jax

    bvh, geos, inst_blas, o2w, tris = _two_level_fixture(rng)
    world = np.array(o2w)
    world[:, :3, 3] += rng.uniform(-3, 3, (len(world), 3)).astype(np.float32)

    moved_pool = _world_pool(geos, inst_blas, world)
    bvh2 = jax.jit(bvh_ops.refit_bvh)(
        bvh, jnp.asarray(moved_pool), jnp.asarray(tris), world=jnp.asarray(world)
    )
    origins, dirs = random_rays(rng, 384)
    hit = bvh_ops.trace_rays(bvh2, jnp.asarray(origins), jnp.asarray(dirs))
    ref_t, ref_tri = bvh_ops.trace_rays_brute(
        moved_pool, tris, np.ones(len(tris), bool), origins, dirs
    )
    got_tri = np.asarray(hit.tri)
    np.testing.assert_array_equal(got_tri >= 0, ref_tri >= 0)
    h = ref_tri >= 0
    assert h.sum() > 20
    np.testing.assert_allclose(np.asarray(hit.t)[h], ref_t[h], rtol=1e-3, atol=1e-3)
    assert (got_tri[h] == ref_tri[h]).mean() > 0.99


def test_two_level_deformable_refit(rng):
    """A per-instance (deformable) BLAS re-reads pool vertices on refit:
    deform the owned instance's pool range and require hits to track it."""
    import jax

    geo = scene_soup(rng, 30)
    o2w = np.stack([np.eye(4, dtype=np.float32), _rand_xform(rng)])
    # instance 0 owns BLAS 0 (deformable, world==object), instance 1 shares BLAS 1
    bvh = bvh_ops.build_two_level(
        [geo, geo], np.array([0, 1], np.int32), o2w,
        np.asarray([0, len(geo[1])], np.int32),
        blas_owner=np.array([0, -1], np.int32),
    )
    tris = np.concatenate([geo[1], geo[1] + len(geo[0])])
    pool = _world_pool([geo, geo], np.array([0, 1]), o2w)
    deformed = np.array(pool)
    deformed[: len(geo[0])] += rng.normal(size=(len(geo[0]), 3)).astype(np.float32) * 1.0

    bvh2 = jax.jit(bvh_ops.refit_bvh)(bvh, jnp.asarray(deformed), jnp.asarray(tris))
    origins, dirs = random_rays(rng, 384)
    hit = bvh_ops.trace_rays(bvh2, jnp.asarray(origins), jnp.asarray(dirs))
    ref_t, ref_tri = bvh_ops.trace_rays_brute(
        deformed, tris, np.ones(len(tris), bool), origins, dirs
    )
    got_tri = np.asarray(hit.tri)
    np.testing.assert_array_equal(got_tri >= 0, ref_tri >= 0)
    h = ref_tri >= 0
    assert h.sum() > 20
    np.testing.assert_allclose(np.asarray(hit.t)[h], ref_t[h], rtol=1e-3, atol=1e-3)


def test_chunked_trace_per_ray_t_max(rng):
    """chunk_size must split a per-ray t_max along with the rays (regression:
    the flagship local-shadow rays pass per-ray t_max into the chunked path,
    which used to close over the full-length array and fail to broadcast)."""
    verts, tris = scene_soup(rng, 60)
    valid = np.ones(len(tris), bool)
    bvh = bvh_ops.build_bvh(verts, tris, valid)
    origins, dirs = random_rays(rng, 100)
    t_max = rng.uniform(0.5, 20.0, (100,)).astype(np.float32)
    whole = bvh_ops.trace_rays(
        bvh, jnp.asarray(origins), jnp.asarray(dirs), t_max=jnp.asarray(t_max))
    chunked = bvh_ops.trace_rays(
        bvh, jnp.asarray(origins), jnp.asarray(dirs), t_max=jnp.asarray(t_max),
        chunk_size=32)
    np.testing.assert_array_equal(np.asarray(chunked.tri), np.asarray(whole.tri))
    np.testing.assert_allclose(np.asarray(chunked.t), np.asarray(whole.t),
                               rtol=1e-5, atol=1e-5)
    # any-hit shadow flavor too (the actual flagship call shape)
    whole_ah = bvh_ops.trace_rays(
        bvh, jnp.asarray(origins), jnp.asarray(dirs), t_max=jnp.asarray(t_max),
        any_hit=True)
    chunked_ah = bvh_ops.trace_rays(
        bvh, jnp.asarray(origins), jnp.asarray(dirs), t_max=jnp.asarray(t_max),
        any_hit=True, chunk_size=32)
    np.testing.assert_array_equal(np.asarray(chunked_ah.tri) >= 0,
                                  np.asarray(whole_ah.tri) >= 0)
    # Broadcastable (1,) t_max must behave like a scalar (ADVICE r4: it
    # previously worked via closure but failed the chunked reshape).
    one = bvh_ops.trace_rays(
        bvh, jnp.asarray(origins), jnp.asarray(dirs),
        t_max=jnp.asarray([7.5], np.float32), chunk_size=32)
    scalar = bvh_ops.trace_rays(
        bvh, jnp.asarray(origins), jnp.asarray(dirs), t_max=7.5)
    np.testing.assert_array_equal(np.asarray(one.tri), np.asarray(scalar.tri))
