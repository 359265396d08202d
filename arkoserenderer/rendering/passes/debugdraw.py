"""Debug draw: immediate-mode 3D lines composited over the final image.

Role-equivalent to DebugDrawNode / DebugDrawer (arkose/rendering/nodes/
DebugDrawNode.cpp, arkose/rendering/debug/DebugDrawer.h:15-34): the host
accumulates a line list each frame (axes, bounding boxes, light gizmos);
this pass projects the endpoints, samples fixed step counts along each
segment, and scatters colored pixels into the LDR target.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry

MAX_LINES = 1024
SAMPLES_PER_LINE = 64


class DebugLineBuffer:
    """Host-side line accumulator (DebugDrawer analogue). Cleared per frame."""

    def __init__(self, capacity: int = MAX_LINES):
        self.capacity = capacity
        self.clear()

    def clear(self):
        self._a = np.zeros((self.capacity, 3), np.float32)
        self._b = np.zeros((self.capacity, 3), np.float32)
        self._color = np.zeros((self.capacity, 3), np.float32)
        self.count = 0

    def line(self, a, b, color=(1.0, 1.0, 0.0)):
        if self.count >= self.capacity:
            return
        i = self.count
        self._a[i] = a
        self._b[i] = b
        self._color[i] = color
        self.count += 1

    def box(self, mins, maxs, color=(0.2, 1.0, 0.2)):
        c = mx.aabb_corners(np.asarray(mins), np.asarray(maxs), xp=np)
        edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
                 (0, 4), (1, 5), (2, 6), (3, 7)]
        for i, j in edges:
            self.line(c[i], c[j], color)

    def grid(self, size: float = 10.0, step: float = 1.0, y: float = 0.0,
             color=(0.35, 0.35, 0.38)):
        """Editor ground grid (EditorGridRenderNode analogue)."""
        n = int(size / step)
        for i in range(-n, n + 1):
            self.line((-size, y, i * step), (size, y, i * step), color)
            self.line((i * step, y, -size), (i * step, y, size), color)

    def axes(self, origin=(0, 0, 0), size=1.0):
        o = np.asarray(origin, np.float32)
        self.line(o, o + [size, 0, 0], (1, 0.2, 0.2))
        self.line(o, o + [0, size, 0], (0.2, 1, 0.2))
        self.line(o, o + [0, 0, size], (0.2, 0.4, 1))

    def arrays(self):
        valid = np.zeros((self.capacity,), np.float32)
        valid[: self.count] = 1.0
        return (
            jnp.asarray(self._a), jnp.asarray(self._b),
            jnp.asarray(self._color), jnp.asarray(valid),
        )


class DebugDrawPass(RenderPass):
    name = "DebugDraw"

    def __init__(self, buffer: DebugLineBuffer):
        self.buffer = buffer

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")
        reg.get("SceneDepth")
        reg.publish("debug.lines")  # provided by the host each frame
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height

        def execute(state: dict, ctx: FrameContext) -> dict:
            a, b, color, valid = state["debug.lines"]
            t = jnp.linspace(0.0, 1.0, SAMPLES_PER_LINE)[None, :, None]  # (1,S,1)
            pts = a[:, None, :] * (1 - t) + b[:, None, :] * t            # (L,S,3)
            flat = pts.reshape(-1, 3)
            clip = mx.transform_points_h(ctx.camera.view_proj, flat)
            wc = clip[:, 3]
            ok = wc > 1e-4
            inv_w = jnp.where(ok, 1.0 / jnp.maximum(wc, 1e-6), 0.0)
            sx = (clip[:, 0] * inv_w * 0.5 + 0.5) * w
            sy = (0.5 - clip[:, 1] * inv_w * 0.5) * full_h - ctx.row_offset
            d = clip[:, 2] * inv_w
            xi = sx.astype(jnp.int32)
            yi = sy.astype(jnp.int32)
            on = ok & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            on = on & (jnp.repeat(valid, SAMPLES_PER_LINE) > 0)
            # Depth test against the scene (lines hidden behind geometry),
            # with slight bias so coplanar lines win.
            scene_d = state["SceneDepth"].reshape(-1)[
                jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
            ]
            on = on & (d * 1.001 >= scene_d)
            idx = jnp.where(on, yi * w + xi, h * w)
            ldr = state["LDR"].reshape(-1, 3)
            ldr = jnp.concatenate([ldr, jnp.zeros((1, 3))], axis=0)
            cols = jnp.repeat(color, SAMPLES_PER_LINE, axis=0)
            ldr = ldr.at[idx].set(cols, mode="drop")
            return {"LDR": ldr[:-1].reshape(h, w, 3)}

        return execute
