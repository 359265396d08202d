"""DDGI pass: amortized probe updates each frame.

Role-equivalent to DDGINode's per-frame work (DDGINode.cpp:138-281): update
``probes_per_frame`` probes round-robin by ray tracing through the scene BVH
and blending the octahedral atlases with hysteresis. The atlases are
persistent frame-state; LightingCompose samples them for diffuse GI.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from arkoserenderer.ops import ddgi as ddgi_ops
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class DDGIPass(RenderPass):
    name = "DDGI"

    def __init__(self, grid: ddgi_ops.ProbeGridConfig):
        self.grid = grid

    def construct(self, cfg: PipelineConfig, reg: Registry):
        grid = self.grid
        p = grid.num_probes
        init = ddgi_ops.init_state(grid)
        reg.create(
            "DDGI.irradiance",
            (p, ddgi_ops.IRRADIANCE_RES, ddgi_ops.IRRADIANCE_RES, 3),
            jnp.float32, persistent=True,
        )
        reg.create(
            "DDGI.visibility",
            (p, ddgi_ops.VISIBILITY_RES, ddgi_ops.VISIBILITY_RES, 2),
            jnp.float32, persistent=True, clear=float(grid.max_distance),
        )
        reg.create("DDGI.offsets", (p, 3), jnp.float32, persistent=True)
        del init  # shapes documented above; visibility clear approximated
        if reg.has("scene.bvh"):
            reg.get("scene.bvh")

        def execute(state: dict, ctx: FrameContext) -> dict:
            st = ddgi_ops.DDGIState(
                irradiance=state["DDGI.irradiance"],
                visibility=state["DDGI.visibility"],
                offsets=state["DDGI.offsets"],
            )
            from arkoserenderer.rendering.passes.rt import scene_with_live_bvh

            new = ddgi_ops.update_probes(
                scene_with_live_bvh(state, ctx), st, grid,
                ctx.frame_index, ctx.camera.exposure,
                n_spots=cfg.scene.n_spots, n_points=cfg.scene.n_points,
                spot_casters=cfg.scene.spot_shadow_casters,
                point_casters=cfg.scene.point_shadow_casters,
            )
            return {
                "DDGI.irradiance": new.irradiance,
                "DDGI.visibility": new.visibility,
                "DDGI.offsets": new.offsets,
            }

        return execute
