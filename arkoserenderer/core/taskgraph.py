"""Host-side job system: task graph + parallel-for.

Role-equivalent to the reference's TaskGraph / ParallelFor / PollableTask
(arkcore/core/parallel/TaskGraph.h:17-123, ParallelFor.h:9-48,
PollableTask.h): worker pools with a Default queue (frame-critical work) and
a Background queue (asset streaming), fork-join parallel loops, and pollable
async tasks with progress. The heavy compute lives on the device, so this
drives host-side work: asset decode/import, BVH builds, animation
evaluation, and async upload staging.
"""

from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import os
import threading
from typing import Any, Callable, Iterable

_DEFAULT: _fut.ThreadPoolExecutor | None = None
_BACKGROUND: _fut.ThreadPoolExecutor | None = None
_LOCK = threading.Lock()


def initialize(default_workers: int | None = None, background_workers: int = 2):
    """Explicit init (TaskGraph::initialize); lazy-inits otherwise."""
    global _DEFAULT, _BACKGROUND
    with _LOCK:
        if _DEFAULT is None:
            n = default_workers or max(os.cpu_count() or 1, 1)
            _DEFAULT = _fut.ThreadPoolExecutor(n, thread_name_prefix="arkose-task")
        if _BACKGROUND is None:
            _BACKGROUND = _fut.ThreadPoolExecutor(
                background_workers, thread_name_prefix="arkose-bg"
            )


def shutdown():
    global _DEFAULT, _BACKGROUND
    with _LOCK:
        if _DEFAULT:
            _DEFAULT.shutdown(wait=True)
            _DEFAULT = None
        if _BACKGROUND:
            _BACKGROUND.shutdown(wait=True)
            _BACKGROUND = None


def _pool(background: bool) -> _fut.ThreadPoolExecutor:
    if _DEFAULT is None:
        initialize()
    return _BACKGROUND if background else _DEFAULT  # type: ignore[return-value]


def schedule_task(fn: Callable, *args, background: bool = False) -> _fut.Future:
    """TaskGraph::scheduleTask — returns a Future."""
    return _pool(background).submit(fn, *args)


def wait_for_completion(futures: Iterable[_fut.Future]):
    """TaskGraph::waitForCompletion."""
    for f in list(futures):
        f.result()


def parallel_for(count: int, fn: Callable[[int], Any], min_batch: int = 1):
    """ParallelFor: fn(i) for i in range(count) across the default pool."""
    if count <= 0:
        return
    pool = _pool(False)
    n_workers = pool._max_workers
    if count <= min_batch or n_workers <= 1:
        for i in range(count):
            fn(i)
        return
    futs = [pool.submit(fn, i) for i in range(count)]
    wait_for_completion(futs)


def parallel_for_batched(count: int, fn: Callable[[int, int], Any], batch: int = 64):
    """ParallelForBatched: fn(start, end) over contiguous chunks."""
    if count <= 0:
        return
    pool = _pool(False)
    futs = [
        pool.submit(fn, s, min(s + batch, count)) for s in range(0, count, batch)
    ]
    wait_for_completion(futs)


@dataclasses.dataclass
class PollableTask:
    """Async task with progress polling (PollableTask analogue) — used by
    async asset imports."""

    future: _fut.Future
    _progress: float = 0.0
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @classmethod
    def run(cls, fn: Callable[["PollableTask"], Any], background: bool = True):
        task = cls.__new__(cls)
        task._progress = 0.0
        task._lock = threading.Lock()
        task.future = _pool(background).submit(fn, task)
        return task

    def set_progress(self, p: float):
        with self._lock:
            self._progress = float(p)

    def progress(self) -> float:
        with self._lock:
            return self._progress

    def done(self) -> bool:
        return self.future.done()

    def result(self):
        return self.future.result()
