import jax.numpy as jnp
import numpy as np
import pytest

from arkoserenderer.ops import tonemap as tm


ALL_MODES = list(tm.MODES.values())


@pytest.mark.parametrize("mode", ALL_MODES)
def test_range_and_black(mode):
    c = jnp.asarray(np.logspace(-3, 2, 64, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32))
    out = np.asarray(tm.tonemap(c, mode))
    assert np.all(out >= -1e-6) and np.all(out <= 1.0 + 1e-6)
    black = np.asarray(tm.tonemap(jnp.zeros((1, 3)), mode))
    np.testing.assert_allclose(black, 0.0, atol=2e-2)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_monotonic_on_gray(mode):
    g = jnp.asarray(np.logspace(-3, 1.5, 128, dtype=np.float32))
    c = jnp.stack([g, g, g], axis=-1)
    out = np.asarray(tm.tonemap(c, mode)).mean(-1)
    # AgX's public 6th-order sigmoid fit dips ~4e-4 at the extreme top end.
    assert np.all(np.diff(out) >= -1e-3)


def test_reinhard_known_value():
    out = np.asarray(tm.tonemap_reinhard(jnp.array([[1.0, 3.0, 0.0]])))
    np.testing.assert_allclose(out, [[0.5, 0.75, 0.0]], atol=1e-6)


def test_aces_mid_gray_brighten():
    # ACES maps 0.18 close to 0.18-0.2 region and 10.0 near 1.
    out = np.asarray(tm.tonemap_aces(jnp.full((1, 3), 10.0)))
    assert np.all(out > 0.95)


def test_st2084_endpoints():
    np.testing.assert_allclose(np.asarray(tm.encode_st2084(jnp.array([0.0]))), [0.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(tm.encode_st2084(jnp.array([10000.0]))), [1.0], atol=1e-5)
    # 100 nits (SDR white) lands at the well-known ~0.508 code value.
    np.testing.assert_allclose(np.asarray(tm.encode_st2084(jnp.array([100.0]))), [0.508], atol=5e-3)


def test_vignette_darkens_corners_not_center():
    color = jnp.ones((2, 3))
    uv = jnp.array([[0.5, 0.5], [0.02, 0.02]])
    out = np.asarray(tm.vignette(color, uv, intensity=0.4))
    np.testing.assert_allclose(out[0], 1.0, atol=1e-5)
    assert np.all(out[1] < 0.8)


def test_film_grain_zero_gain_identity():
    color = jnp.full((4, 3), 0.25)
    xy = jnp.arange(8, dtype=jnp.float32).reshape(4, 2)
    out = np.asarray(tm.film_grain(color, xy, jnp.asarray(3), gain=0.0))
    np.testing.assert_allclose(out, 0.25, atol=1e-7)
    out2 = np.asarray(tm.film_grain(color, xy, jnp.asarray(3), gain=0.5))
    assert np.std(out2) > 0.01


def test_blue_noise_mask_spectrum_and_decorrelation():
    """The committed blue-noise mask has far less low-frequency energy than
    white noise (the clumping the VERDICT asked to remove), is a permutation
    of all ranks, and per-salt/per-frame variants decorrelate."""
    import numpy as np

    from arkoserenderer.ops.noise import (
        blue_noise_mask, blue_noise_ranks, sample_blue_noise,
    )

    ranks = blue_noise_ranks()
    assert ranks.shape == (128, 128)
    assert len(np.unique(ranks)) == ranks.size  # exact permutation

    mask = blue_noise_mask()

    def low_high_ratio(img):
        f = np.fft.fftshift(np.abs(np.fft.fft2(img - img.mean())))
        n = img.shape[0]
        yy, xx = np.mgrid[:n, :n]
        rad = np.hypot(yy - n // 2, xx - n // 2)
        return f[rad < n / 8].mean() / f[rad > n / 3].mean()

    rng = np.random.default_rng(0)
    white = rng.random(mask.shape).astype(np.float32)
    r_blue, r_white = low_high_ratio(mask), low_high_ratio(white)
    assert r_blue < 0.1 * r_white, (r_blue, r_white)

    import jax.numpy as jnp

    yy, xx = jnp.mgrid[:128, :128]
    a = np.asarray(sample_blue_noise(xx, yy, 0, salt=1))
    b = np.asarray(sample_blue_noise(xx, yy, 0, salt=2))
    c = np.asarray(sample_blue_noise(xx, yy, 1, salt=1))
    # Different salts / frames: decorrelated (|rho| < 0.1) but each still blue.
    corr_ab = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert abs(corr_ab) < 0.1, corr_ab
    assert not np.allclose(a, c)
    assert low_high_ratio(a) < 0.1 * r_white
