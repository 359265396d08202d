"""Per-pass timing: the reference's per-node GPU timers, rebuilt for XLA.

Role-equivalent to the per-node timestamp queries + rolling averages the
reference displays against its 16.667 ms budget (VulkanBackend.cpp:1830-1935,
RenderPipeline.cpp:76-108, AvgElapsedTimer.h). XLA fuses across passes inside
the one jitted frame function, so for *timing* we jit each pass's execute
separately and measure blocking wall-clock per pass — an upper bound that
still localizes cost — plus the fused whole-frame time.

Deadline discipline: separately jitting every pass costs one XLA compile
each, which a fixed bench timeout may not hold. So ``time_passes``
measures the FUSED frame first (the headline number always lands), then
walks passes in pipeline order until
``deadline_s`` expires, emitting each row the moment it is measured via
``emit`` so a killed process still leaves a partial table on stdout.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

from arkoserenderer.rendering.pipeline import FrameContext, RenderPipeline
from arkoserenderer.scene.camera import CameraState
from arkoserenderer.scene.scene import SceneArrays


def time_passes(
    pipe: RenderPipeline,
    state: dict,
    scene: SceneArrays,
    camera: CameraState,
    frame_index: int = 1,
    iters: int = 5,
    deadline_s: float | None = None,
    emit: Callable[[str], None] | None = None,
) -> dict[str, float]:
    """Returns {pass_name: ms} with '<frame>' (the fused full frame) FIRST.

    deadline_s: wall-clock budget for the whole call; per-pass timing stops
    (partial table) once it expires. emit: optional callback invoked with a
    formatted row as each measurement lands (incremental reporting).
    """
    t_start = time.perf_counter()
    results: dict[str, float] = {}

    def note(name: str, ms: float) -> None:
        results[name] = ms
        if emit is not None:
            emit(f"{name:24s} {ms:9.3f} ms")

    def expired() -> bool:
        return (deadline_s is not None
                and time.perf_counter() - t_start > deadline_s)

    # Fused whole-frame time first — the headline row must always land,
    # whatever happens to the per-pass compiles after it. Measure the way
    # frames actually run: the DONATING compiled frame (the same cached
    # executable the Renderer uses — asking compile() for a non-donating
    # variant would force a fresh multi-minute relay compile) fed forward
    # serially, each frame's persistent outputs becoming the next frame's
    # inputs. Rebuilding initial_state() per iteration instead times host
    # allocation + H2D upload (measured 347 ms vs the real ~3 ms showcase
    # frame), and reusing one donated arg tuple is undefined after call 1.
    fused = pipe.compile()
    persistent = set(pipe.registry.persistent_names)

    def feed(st: dict) -> dict:
        return {k: v for k, v in st.items() if k in persistent}

    fi = jnp.asarray(frame_index, jnp.int32)
    dt = jnp.asarray(1 / 60, jnp.float32)
    cur = jax.block_until_ready(
        fused(pipe.initial_state(), scene, camera, fi, dt))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        cur = fused(feed(cur), scene, camera, fi, dt)
    jax.block_until_ready(cur)
    note("<frame>", (time.perf_counter() - t0) / iters * 1e3)

    ctx = FrameContext(
        scene=scene,
        camera=camera,
        frame_index=jnp.asarray(frame_index, jnp.int32),
        delta_time=jnp.asarray(1 / 60, jnp.float32),
        row_offset=jnp.zeros((), jnp.int32),
    )
    st = dict(state)
    for name, execute in pipe._executes:
        if expired():
            if emit is not None:
                emit(f"# deadline {deadline_s:.0f}s reached; partial table "
                     f"({len(results) - 1}/{len(pipe._executes)} passes)")
            break
        fn = jax.jit(execute)
        updates = jax.block_until_ready(fn(st, ctx))  # compile + warm
        t0 = time.perf_counter()
        for _ in range(iters):
            updates = fn(st, ctx)
        jax.block_until_ready(updates)
        note(name, (time.perf_counter() - t0) / iters * 1e3)
        st.update(updates)
    return results


def format_timings(timings: dict[str, float], budget_ms: float = 16.667) -> str:
    lines = [f"{'pass':24s} {'ms':>9s}   vs 16.667 ms budget"]
    for name, ms in timings.items():
        flag = "" if ms < budget_ms else "  <-- over budget"
        lines.append(f"{name:24s} {ms:9.3f}{flag}")
    return "\n".join(lines)
