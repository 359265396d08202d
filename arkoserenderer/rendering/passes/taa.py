"""Temporal anti-aliasing.

Role-equivalent to TAANode (arkose/rendering/nodes/TAANode.cpp +
shaders/taa/taa.comp): the camera jitters its projection with a Halton
sequence (scene side); this pass reprojects the persistent history buffer
along per-pixel motion vectors, clamps it to the 3x3 neighborhood of the
current frame (AABB clamp in RGB), and exponentially blends. First frame
(or history reset) takes the current frame wholesale.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

import jax

from arkoserenderer.ops.image import (
    bilinear_sample,
    bilinear_sample_small_offset,
    neighborhood_min_max,
    sample_catmull_rom,
)
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class TAAPass(RenderPass):
    name = "TAA"

    def __init__(self, hysteresis: float = 0.9, use_catmull_rom: bool | None = None):
        self.hysteresis = hysteresis
        # None = follow cfg.taa_filter (16-gather Catmull-Rom history
        # resample, or 4-gather bilinear).
        self.use_catmull_rom = use_catmull_rom

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneVelocity")
        reg.create("TAAHistory", (h, w, 3), jnp.float32, persistent=True)
        xs = (np.arange(w, dtype=np.float32) + 0.5)
        ys = (np.arange(h, dtype=np.float32) + 0.5)
        px, py = np.meshgrid(xs, ys)
        # numpy on purpose: closures become program constants (pipeline.pixel_centers)
        px = px.ravel()
        py = py.ravel()
        hysteresis = self.hysteresis
        catmull = (
            self.use_catmull_rom
            if self.use_catmull_rom is not None
            else cfg.taa_filter == "catmull"
        )

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            velocity = state["SceneVelocity"].reshape(-1, 2)
            history = state["TAAHistory"]

            prev_x = px - velocity[:, 0]
            prev_y = py - velocity[:, 1]
            if catmull:
                hist = sample_catmull_rom(history, prev_x, prev_y).reshape(h, w, 3)
            else:
                # Sub-pixel motion (static/slow camera — the common case):
                # the history resample is NINE WEIGHTED STATIC SHIFTS, no
                # gathers at all; fast motion falls back to the gather path.
                # lax.cond executes only the taken branch per frame.
                vel_img = state["SceneVelocity"]
                max_v = jnp.max(jnp.abs(vel_img))

                def _fast(_):
                    return bilinear_sample_small_offset(
                        history, -vel_img[..., 0], -vel_img[..., 1]
                    )

                def _slow(_):
                    return bilinear_sample(history, prev_x, prev_y).reshape(h, w, 3)

                hist = jax.lax.cond(max_v <= 1.0, _fast, _slow, None)

            lo, hi = neighborhood_min_max(color)
            hist = jnp.clip(hist, lo, hi)

            # History is invalid where reprojection left the screen.
            on_screen = (
                (prev_x >= 0.0) & (prev_x < w) & (prev_y >= 0.0) & (prev_y < h)
            ).reshape(h, w, 1)
            first_frame = ctx.frame_index == 0
            alpha = jnp.where(first_frame | ~on_screen, 1.0, 1.0 - hysteresis)
            out = hist + (color - hist) * alpha
            return {"SceneColor": out, "TAAHistory": out}

        return execute
