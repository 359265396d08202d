"""Editor icon billboards for lights.

Role-equivalent to IconManager + DebugDrawer::drawIcon (arkose/rendering/
IconManager.h:9-22, EditorScene.cpp:177-179 — a lightbulb billboard at every
light's world position, tinted by the light color): each local light is
splatted as a small camera-facing procedural bulb (disc + stem) over the LDR
image, depth-tested against the scene so icons hide behind geometry.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


def _bulb_offsets(r: int):
    """Procedural lightbulb: filled disc + 2px stem below (the icon texture
    stand-in; swappable for a real RGBA icon atlas later)."""
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if dy * dy + dx * dx <= r * r]
    offs += [(r + 1, 0), (r + 2, 0), (r + 1, -1), (r + 1, 1)]
    return offs


class IconBillboardPass(RenderPass):
    name = "IconBillboards"

    def __init__(self, radius_px: int = 3, xray: bool = False):
        self.radius_px = radius_px
        self.xray = xray

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")
        reg.get("SceneDepth")
        h, w = cfg.height, cfg.width
        full_h = cfg.frame_height
        n_spots = cfg.scene.n_spots
        n_points = cfg.scene.n_points
        offs = _bulb_offsets(self.radius_px)
        xray = self.xray

        def execute(state: dict, ctx: FrameContext) -> dict:
            if n_spots + n_points == 0:
                return {}
            L = ctx.scene.lights
            pos = jnp.concatenate([L.spot_pos[:n_spots], L.point_pos[:n_points]])
            col = jnp.concatenate([L.spot_color[:n_spots], L.point_color[:n_points]])
            # Tint by the light's chromaticity, full brightness (the reference
            # tints the white bulb texture by light.color()).
            tint = col / jnp.maximum(col.max(axis=-1, keepdims=True), 1e-6)

            clip = mx.transform_points_h(ctx.camera.view_proj, pos)
            wc = clip[:, 3]
            ok = wc > 1e-4
            inv_w = jnp.where(ok, 1.0 / jnp.maximum(wc, 1e-6), 0.0)
            xi = ((clip[:, 0] * inv_w * 0.5 + 0.5) * w).astype(jnp.int32)
            yi = ((0.5 - clip[:, 1] * inv_w * 0.5) * full_h
                  - ctx.row_offset).astype(jnp.int32)
            d = clip[:, 2] * inv_w

            ldr = state["LDR"].reshape(-1, 3)
            ldr = jnp.concatenate([ldr, jnp.zeros((1, 3))], axis=0)
            depth_flat = state["SceneDepth"].reshape(-1)
            for dy, dx in offs:
                px_i = xi + dx
                py_i = yi + dy
                on = ok & (px_i >= 0) & (px_i < w) & (py_i >= 0) & (py_i < h)
                if not xray:
                    scene_d = depth_flat[
                        jnp.clip(py_i, 0, h - 1) * w + jnp.clip(px_i, 0, w - 1)
                    ]
                    on = on & (d >= scene_d)
                idx = jnp.where(on, py_i * w + px_i, h * w)
                ldr = ldr.at[idx].set(tint, mode="drop")
            return {"LDR": ldr[:-1].reshape(h, w, 3)}

        return execute
