import jax.numpy as jnp
import numpy as np

from arkoserenderer.ops import brdf


def _dirs(n):
    return jnp.broadcast_to(jnp.asarray(n, jnp.float32), (1, 3))


def test_lambert_facing_light():
    # Pure diffuse white surface, light and view along the normal:
    # f * n.l = 1/pi.
    n = _dirs([0, 0, 1])
    out = brdf.evaluate(
        n, n, n,
        base_color=jnp.ones((1, 3)),
        roughness=jnp.ones((1, 1)),
        metallic=jnp.zeros((1, 1)),
    )
    # Specular adds a bit on top of 1/pi at rough=1; diffuse dominates.
    assert np.all(np.asarray(out) > 1.0 / np.pi - 1e-4)
    assert np.all(np.asarray(out) < 0.6)


def test_below_horizon_is_black():
    n = _dirs([0, 0, 1])
    l = _dirs([0, 0, -1])
    v = _dirs([0, 0, 1])
    out = brdf.evaluate(
        l, v, n,
        base_color=jnp.ones((1, 3)),
        roughness=jnp.full((1, 1), 0.5),
        metallic=jnp.zeros((1, 1)),
    )
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-7)


def test_metal_has_no_diffuse_and_tinted_specular():
    n = _dirs([0, 0, 1])
    v = _dirs([0, 0, 1])
    l = jnp.asarray([[0.0, np.sin(0.3), np.cos(0.3)]], jnp.float32)
    gold = jnp.asarray([[1.0, 0.7, 0.3]], jnp.float32)
    out = np.asarray(
        brdf.evaluate(l, v, n, gold, jnp.full((1, 1), 0.3), jnp.ones((1, 1)))
    )[0]
    # Specular tint follows base color ordering r > g > b.
    assert out[0] > out[1] > out[2]


def test_smooth_mirror_peak_at_reflection():
    n = _dirs([0, 0, 1])
    v = jnp.asarray([[0.0, -np.sin(0.5), np.cos(0.5)]], jnp.float32)
    l_mirror = jnp.asarray([[0.0, np.sin(0.5), np.cos(0.5)]], jnp.float32)
    l_off = jnp.asarray([[0.0, np.sin(0.9), np.cos(0.9)]], jnp.float32)
    args = dict(base_color=jnp.ones((1, 3)), roughness=jnp.full((1, 1), 0.1), metallic=jnp.ones((1, 1)))
    peak = np.asarray(brdf.evaluate(l_mirror, v, n, **args)).mean()
    off = np.asarray(brdf.evaluate(l_off, v, n, **args)).mean()
    assert peak > 10 * off


def test_energy_white_furnace_bound(rng):
    # Integrate f*cos over the hemisphere with uniform sampling: must not
    # exceed 1 (energy conservation, loose bound with MC noise margin).
    n_samples = 4096
    u = rng.random((n_samples, 2))
    phi = 2 * np.pi * u[:, 0]
    cos_t = u[:, 1]
    sin_t = np.sqrt(1 - cos_t**2)
    l = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1).astype(np.float32)
    n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (n_samples, 3))
    v = jnp.broadcast_to(jnp.array([0.0, np.sin(0.4), np.cos(0.4)]), (n_samples, 3)).astype(jnp.float32)
    for rough, metal in [(1.0, 0.0), (0.5, 0.0), (0.3, 1.0)]:
        out = np.asarray(
            brdf.evaluate(
                jnp.asarray(l), v, n,
                jnp.ones((n_samples, 3)),
                jnp.full((n_samples, 1), rough),
                jnp.full((n_samples, 1), metal),
            )
        )
        integral = 2 * np.pi * out.mean(axis=0)  # uniform hemisphere pdf = 1/2pi
        assert np.all(integral < 1.15), (rough, metal, integral)


def test_vndf_sample_is_unit_and_upper_hemisphere(rng):
    n = 512
    v = np.tile(np.array([[0.0, 0.6, 0.8]], np.float32), (n, 1))
    u = rng.random((n, 2)).astype(np.float32)
    h = np.asarray(brdf.sample_ggx_vndf(jnp.asarray(v), 0.25, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])))
    np.testing.assert_allclose(np.linalg.norm(h, axis=-1), 1.0, atol=1e-5)
    assert np.all(h[:, 2] >= 0.0)
    assert np.all(np.sum(h * v, axis=-1) > 0.0)  # visible normals face the view
