"""System layer: window/surface abstraction + headless implementation.

Role-equivalent to arkose/system/System.h (+ SystemGlfw.cpp): window
creation, event pump, time source. A compute host has no display server;
``HeadlessSystem`` is the production implementation (frames go to
files / streams — the reference's off-screen submitRenderPipeline mode), and
``ReplaySystem`` feeds recorded input for deterministic interaction tests.
A GUI backend slots in behind the same interface when a display exists.
"""

from __future__ import annotations

import abc
import time

from arkoserenderer.system.input import Input


class System(abc.ABC):
    """Abstract platform services (System.h analogue)."""

    def __init__(self):
        self.input = Input()
        self._t0 = time.perf_counter()

    @abc.abstractmethod
    def create_window(self, width: int, height: int, title: str) -> None: ...

    @abc.abstractmethod
    def framebuffer_size(self) -> tuple[int, int]: ...

    @abc.abstractmethod
    def new_frame(self) -> bool:
        """Pump events; returns False when the app should exit."""

    def time_since_startup(self) -> float:
        return time.perf_counter() - self._t0

    @abc.abstractmethod
    def present(self, ldr_image) -> None:
        """Deliver the final frame (swapchain present analogue)."""


class HeadlessSystem(System):
    """No display: frames are kept (optionally written to disk)."""

    def __init__(self, out_path: str | None = None, max_frames: int | None = None):
        super().__init__()
        self._size = (1280, 720)
        self.out_path = out_path
        self.max_frames = max_frames
        self.frame_count = 0
        self.last_frame = None

    def create_window(self, width: int, height: int, title: str) -> None:
        self._size = (width, height)

    def framebuffer_size(self) -> tuple[int, int]:
        return self._size

    def new_frame(self) -> bool:
        self.input.new_frame()
        return self.max_frames is None or self.frame_count < self.max_frames

    def present(self, ldr_image) -> None:
        self.last_frame = ldr_image
        if self.out_path:
            from arkoserenderer.utils.imageio import save_png

            save_png(self.out_path.format(frame=self.frame_count), ldr_image)
        self.frame_count += 1


class ReplaySystem(HeadlessSystem):
    """Feeds a recorded input script: list of (frame, method, args)."""

    def __init__(self, script, **kw):
        super().__init__(**kw)
        self.script = sorted(script, key=lambda e: e[0])
        self._cursor = 0

    def new_frame(self) -> bool:
        ok = super().new_frame()
        while (
            self._cursor < len(self.script)
            and self.script[self._cursor][0] <= self.frame_count
        ):
            _, method, args = self.script[self._cursor]
            getattr(self.input, method)(*args)
            self._cursor += 1
        return ok
