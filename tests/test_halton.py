import numpy as np

from arkoserenderer.core import halton


def test_halton_base2_first_values():
    vals = halton.halton(np.array([1, 2, 3, 4]), 2)
    np.testing.assert_allclose(vals, [0.5, 0.25, 0.75, 0.125])


def test_halton_base3_first_values():
    vals = halton.halton(np.array([1, 2, 3]), 3)
    np.testing.assert_allclose(vals, [1 / 3, 2 / 3, 1 / 9])


def test_camera_jitter_range():
    j = halton.camera_jitter_sequence(16)
    assert j.shape == (16, 2)
    assert np.all(j >= -0.5) and np.all(j < 0.5)
    # Low discrepancy: mean near 0
    assert np.all(np.abs(j.mean(axis=0)) < 0.1)


def test_fibonacci_sphere_unit_norm():
    pts = halton.fibonacci_sphere(256)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=-1), 1.0, atol=1e-5)
    assert np.abs(pts.mean(axis=0)).max() < 0.05


def test_fibonacci_disc_in_unit_disc():
    pts = halton.fibonacci_disc(128)
    assert np.all(np.linalg.norm(pts, axis=-1) <= 1.0 + 1e-6)
