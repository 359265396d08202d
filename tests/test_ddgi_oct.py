"""Octahedral atlas addressing: seam-wrapped bilinear filtering."""

import numpy as np
import jax.numpy as jnp

from arkoserenderer.ops import ddgi


def test_oct_wrap_maps_into_range():
    res = 8
    xi = jnp.asarray(np.array([-1, 0, 7, 8, -1, 8], np.int32))
    yi = jnp.asarray(np.array([3, -1, 8, 4, -1, 8], np.int32))
    xw, yw = ddgi._oct_wrap(xi, yi, res)
    xw, yw = np.asarray(xw), np.asarray(yw)
    assert ((0 <= xw) & (xw < res)).all() and ((0 <= yw) & (yw < res)).all()
    # Left edge: (-1, y) -> (0, res-1-y); corners -> opposite corner.
    assert (xw[0], yw[0]) == (0, 4)
    assert (xw[4], yw[4]) == (7, 7)
    assert (xw[5], yw[5]) == (0, 0)


def test_seam_wrap_beats_clamp_on_smooth_function():
    """Fill one probe tile with a smooth direction-dependent signal and
    bilinear-sample at directions that straddle the octahedral seam: the
    wrapped filter must reconstruct the signal with small error everywhere,
    including the lower hemisphere (where clamp addressing kinks)."""
    res = ddgi.IRRADIANCE_RES
    dirs = np.asarray(ddgi._texel_dirs(res)).reshape(res, res, 3)
    truth = lambda d: 0.5 + 0.5 * d  # linear in direction: bilinear-friendly
    atlas = jnp.asarray(truth(dirs)[None].astype(np.float32))  # (1, R, R, 3)

    rng = np.random.default_rng(7)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = ddgi.octahedral_encode(jnp.asarray(d))
    got = np.asarray(ddgi._bilinear_atlas(atlas, jnp.zeros(512, jnp.int32), uv))
    err = np.abs(got - truth(d)).max(axis=-1)
    # Lower-hemisphere samples interpolate across the seam; the wrap keeps
    # them consistent with the smooth signal.
    lower = d[:, 2] < -0.3
    assert lower.sum() > 50
    assert err[lower].mean() < 0.08
    assert err.max() < 0.35


def test_probe_relocation_escapes_geometry():
    """A probe starting inside a closed box sees mostly backfaces; the
    relocation pass must push it toward the surface (nonzero clamped offset)
    and reduce its backface exposure."""
    import jax
    from arkoserenderer.assets.procedural import make_box
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.scene import Material, Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=256, max_indices=256, max_drawables=4, max_materials=4,
        max_textures=8, texture_pool_texels=1 << 12,
    ))
    seg = make_box((2.0, 2.0, 2.0))
    seg.material = scene.add_material(Material())
    w = np.eye(4, dtype="float32")
    scene.add_instance(scene.add_segment(seg), w)
    sa = scene.build(with_bvh=True)

    cfg = ddgi.ProbeGridConfig(
        dims=(1, 1, 1), origin=(0.3, 0.2, 0.1), spacing=(2.0, 2.0, 2.0),
        rays_per_probe=64, probes_per_frame=1,
    )
    st = ddgi.init_state(cfg)
    assert float(jnp.abs(st.offsets).max()) == 0.0
    step = jax.jit(lambda s, i: ddgi.update_probes(sa, s, cfg, i, 1.0))
    for i in range(4):
        st = step(st, jnp.asarray(i, jnp.int32))
    off = np.asarray(st.offsets[0])
    assert np.abs(off).max() > 0.1            # the probe moved
    assert (np.abs(off) <= 0.45 * 2.0 + 1e-5).all()  # clamped to the grid
