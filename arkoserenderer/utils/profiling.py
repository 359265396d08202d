"""Profiling: scoped zones + whole-program traces.

Role-equivalent to the reference's Tracy integration
(arkcore/utility/Profiling.h:8-66 SCOPED_PROFILE_ZONE macros + TracyVk GPU
zones): host-side scoped zones aggregate wall-clock per label (the CPU
timers), and `trace()` wraps jax.profiler for full XLA device traces
viewable in TensorBoard/Perfetto (the GPU-zone analogue).
"""

from __future__ import annotations

import collections
import contextlib
import time

import jax

_ZONES: dict[str, list[float]] = collections.defaultdict(list)
ZONE_WINDOW = 60  # rolling samples per zone, like AvgElapsedTimer


@contextlib.contextmanager
def zone(name: str):
    """SCOPED_PROFILE_ZONE analogue; also annotates device traces."""
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    samples = _ZONES[name]
    samples.append((time.perf_counter() - t0) * 1e3)
    if len(samples) > ZONE_WINDOW:
        del samples[: len(samples) - ZONE_WINDOW]


def zone_averages() -> dict[str, float]:
    """Rolling average ms per zone (AvgElapsedTimer::averageMs)."""
    return {k: sum(v) / len(v) for k, v in _ZONES.items() if v}


def reset_zones():
    _ZONES.clear()


@contextlib.contextmanager
def trace(log_dir: str = "arkose_trace"):
    """Capture a full device trace (open with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
