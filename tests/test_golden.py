"""Golden-image regression tests.

Deterministic CPU renders of the canonical cases in
``arkoserenderer/utils/goldens.py`` compared against the committed goldens.
Regenerate with:  python tests/test_golden.py --regen [name ...]
"""

import pytest

from arkoserenderer.utils import goldens


# pathtraced is the slowest single test in the suite (~124 s serial: a
# multi-spp converged PT frame); it runs in the nightly heavy lane — PT
# correctness stays gate-covered by test_pathtracer + the truth harness.
@pytest.mark.parametrize(
    "name",
    [pytest.param(n, marks=pytest.mark.heavy) if n == "pathtraced" else n
     for n in sorted(goldens.render_cases().keys())],
)
def test_golden(name):
    img = goldens.render_cases()[name]()
    mean_diff, frac_off = goldens.compare_to_golden(name, img)
    assert mean_diff < goldens.MAX_MEAN_ABS_DIFF, (
        f"{name}: mean abs diff {mean_diff:.2f}")
    assert frac_off < goldens.MAX_FRAC_PIXELS_OFF, (
        f"{name}: {frac_off:.2%} pixels changed")


if __name__ == "__main__":
    import sys

    import jax

    from arkoserenderer.utils.imageio import save_png

    # Goldens are XLA:CPU renders.
    jax.config.update("jax_platforms", "cpu")

    if "--regen" in sys.argv:
        goldens.GOLDEN_DIR.mkdir(exist_ok=True)
        only = [a for a in sys.argv[2:] if not a.startswith("-")]
        for name, fn in goldens.render_cases().items():
            if only and name not in only:
                continue
            save_png(str(goldens.GOLDEN_DIR / f"{name}.png"), fn())
            print("wrote", name)
