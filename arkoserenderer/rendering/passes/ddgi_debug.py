"""DDGI probe debug visualization.

Role-equivalent to DDGIProbeDebug (arkose/rendering/nodes/DDGIProbeDebug.cpp
— instanced probe spheres textured by the irradiance atlas): each probe is
splatted as a small screen-space disc colored by its octahedral-average
irradiance, depth-tested against the scene.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import ddgi as ddgi_ops
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class DDGIProbeDebugPass(RenderPass):
    name = "DDGIProbeDebug"

    def __init__(self, grid: ddgi_ops.ProbeGridConfig, radius_px: int = 3,
                 exposure_boost: float = 4.0, xray: bool = False):
        self.grid = grid
        self.radius_px = radius_px
        self.exposure_boost = exposure_boost
        self.xray = xray  # draw probes through geometry

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")
        reg.get("SceneDepth")
        reg.get("DDGI.irradiance")
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        # numpy: closures become program constants (pixel_centers doc)
        positions = np.asarray(ddgi_ops.probe_positions(self.grid))
        r_px = self.radius_px
        boost = self.exposure_boost
        xray = self.xray
        offs = [(dy, dx) for dy in range(-r_px, r_px + 1)
                for dx in range(-r_px, r_px + 1)
                if dy * dy + dx * dx <= r_px * r_px]

        def execute(state: dict, ctx: FrameContext) -> dict:
            irr = state["DDGI.irradiance"].mean(axis=(1, 2))  # (P, 3)
            clip = mx.transform_points_h(ctx.camera.view_proj, positions)
            wc = clip[:, 3]
            ok = wc > 1e-4
            inv_w = jnp.where(ok, 1.0 / jnp.maximum(wc, 1e-6), 0.0)
            sx = (clip[:, 0] * inv_w * 0.5 + 0.5) * w
            sy = (0.5 - clip[:, 1] * inv_w * 0.5) * full_h - ctx.row_offset
            d = clip[:, 2] * inv_w
            xi = sx.astype(jnp.int32)
            yi = sy.astype(jnp.int32)
            color = jnp.clip(irr * boost, 0.0, 1.0)

            ldr = state["LDR"].reshape(-1, 3)
            ldr = jnp.concatenate([ldr, jnp.zeros((1, 3))], axis=0)
            depth_flat = state["SceneDepth"].reshape(-1)
            for dy, dx in offs:
                px_i = xi + dx
                py_i = yi + dy
                on = ok & (px_i >= 0) & (px_i < w) & (py_i >= 0) & (py_i < h)
                scene_d = depth_flat[
                    jnp.clip(py_i, 0, h - 1) * w + jnp.clip(px_i, 0, w - 1)
                ]
                if not xray:
                    on = on & (d >= scene_d)  # probes hidden behind geometry
                idx = jnp.where(on, py_i * w + px_i, h * w)
                ldr = ldr.at[idx].set(color, mode="drop")
            return {"LDR": ldr[:-1].reshape(h, w, 3)}

        return execute
