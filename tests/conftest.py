"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

This is the CI "fake backend" called for by SURVEY.md §4: kernels run in
XLA:CPU (Pallas in interpret mode), and sharding tests get 8 virtual devices
without GPUs. Must run before jax creates its backends. The platform is set
both in the environment and through jax.config. GPU runs: chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session", autouse=True)
def _check_cpu_devices():
    assert jax.devices()[0].platform == "cpu", "tests must run on XLA:CPU"
    assert len(jax.devices()) == 8, "tests expect an 8-device virtual mesh"


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "heavy: long-running end-to-end tests (deselect with -m 'not heavy' "
        "for a fast iteration loop)",
    )
    config.addinivalue_line(
        "markers",
        "smoke: <2-minute fast lane (kernel unit tests + one golden); run "
        "with -m smoke during perf iteration",
    )


# -- smoke lane ---------------------------------------------------------------
# `pytest -m smoke` = the <2-minute subset for perf-iteration loops (kernel
# unit tests + one end-to-end golden). The full suite stays the CI gate.
SMOKE_MODULES = {
    "test_mathx", "test_halton", "test_tonemap", "test_brdf",
    "test_interpolate", "test_baked", "test_bc7", "test_meshopt",
    "test_raster",
}
SMOKE_IDS = {
    "test_golden.py::test_golden[forward]",
}


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest

    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        short = item.nodeid.split("/")[-1]
        if mod in SMOKE_MODULES or short in SMOKE_IDS:
            item.add_marker(_pytest.mark.smoke)


# -- gate wall-clock ----------------------------------------------------------
# Print the lane's total wall-clock at the end of every run so budget drift
# is visible in CI output (VERDICT r4: "a gate nobody can run is not a
# gate"). The CI gate (`pytest tests/`) promises <10 min on an 8-vCPU box.
_GATE_T0 = None


def pytest_sessionstart(session):
    global _GATE_T0
    import time

    _GATE_T0 = time.time()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    import time

    if _GATE_T0 is None:
        return
    wall = time.time() - _GATE_T0
    budget = 600.0
    note = "" if wall < budget else "  <-- OVER the 10-min CI-gate budget"
    terminalreporter.write_line(
        f"[gate wall-clock] {wall:.1f} s (CI-gate budget 600 s){note}"
    )
