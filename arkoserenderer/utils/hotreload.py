"""Hot reload: source file watching + module reload + pipeline reconstruct.

Role-equivalent to the reference's shader hot-reload loop
(arkose/rendering/backend/shader/ShaderManager.h:49-51 — a polling thread
scanning shader include trees by timestamp — consumed by
Arkose.cpp:49-73's ``checkOnShaderFileWatching`` which triggers
``reconstructRenderPipelineResources``). Here "shaders" are Python modules
(passes / ops): the watcher polls source mtimes, ``importlib.reload``s
changed modules in dependency-safe (path-depth) order, and the caller
re-runs pipeline ``construct_all`` — re-jitting is the recompile.
"""

from __future__ import annotations

import importlib
import os
import sys
import time


class ModuleWatcher:
    """Polls loaded modules under the given root paths for mtime changes."""

    def __init__(self, roots: list[str] | None = None, poll_interval: float = 0.5):
        if roots is None:
            import arkoserenderer

            roots = [os.path.dirname(arkoserenderer.__file__)]
        self.roots = [os.path.abspath(r) for r in roots]
        self.poll_interval = poll_interval
        self._mtimes: dict[str, float] = {}
        self._last_poll = 0.0
        self._scan(initial=True)

    def _watched(self):
        for name, mod in list(sys.modules.items()):
            f = getattr(mod, "__file__", None)
            if not f or not f.endswith(".py"):
                continue
            f = os.path.abspath(f)
            if any(f.startswith(root + os.sep) or f == root for root in self.roots):
                yield name, mod, f

    def _scan(self, initial: bool = False) -> list[str]:
        changed = []
        for name, mod, f in self._watched():
            try:
                m = os.stat(f).st_mtime
            except OSError:
                continue
            old = self._mtimes.get(f)
            self._mtimes[f] = m
            if not initial and old is not None and m > old:
                changed.append(name)
        return changed

    def poll(self) -> list[str]:
        """Returns the list of RELOADED module names (empty if none changed).

        Reload order: deepest modules first (leaf ops before the passes that
        import them), then shallower — mirrors the reference recompiling
        shader files before relinking pipelines.
        """
        now = time.monotonic()
        if now - self._last_poll < self.poll_interval:
            return []
        self._last_poll = now
        changed = self._scan()
        if not changed:
            return []
        changed.sort(key=lambda n: -n.count("."))
        reloaded = []
        for name in changed:
            mod = sys.modules.get(name)
            if mod is None:
                continue
            try:
                importlib.reload(mod)
                reloaded.append(name)
            except Exception as e:  # compile error: keep running (the
                # reference shows the error and retries, ShaderManager.cpp
                # compileWithRetry) — next successful save reloads again.
                print(f"hot-reload: {name} failed: {e}", file=sys.stderr)
        return reloaded
