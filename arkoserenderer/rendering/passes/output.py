"""Output pass: tonemap + film effects + display encode.

Role-equivalent to OutputNode (arkose/rendering/output/OutputNode.cpp:11-202):
the scene color is already pre-exposed (lights multiplied by camera
exposure during shading), so this pass applies the selected tonemap operator,
vignette, ISO-scaled film grain, and the sRGB transfer function, producing
the final LDR image in [0,1].
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from arkoserenderer.ops import tonemap as tm
from arkoserenderer.ops.texture import linear_to_srgb
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class OutputPass(RenderPass):
    name = "Output"

    def __init__(
        self,
        mode: str | None = None,
        vignette_intensity: float = 0.18,
        film_grain_gain: float = 0.0,
        color_grade_lut=None,  # assets.external.CubeLUT for 3D color grading
    ):
        self.mode = mode
        self.vignette_intensity = vignette_intensity
        self.film_grain_gain = film_grain_gain
        self.color_grade_lut = color_grade_lut

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.create("LDR", (h, w, 3), jnp.float32)
        reg.create("Metering.avgLum", (), jnp.float32)
        mode = tm.MODES[self.mode or cfg.tonemap_mode]
        vign = self.vignette_intensity
        grain = self.film_grain_gain
        full_h = cfg.frame_height
        # Band-local pixel coordinate grids; shifted by row_offset at execute
        # so vignette/grain are computed in full-frame space under sharding.
        xpx, ypx = np.meshgrid(
            np.arange(w, dtype=np.float32) + 0.5, np.arange(h, dtype=np.float32) + 0.5
        )
        # numpy on purpose: closures become program constants (pixel_centers doc)
        lut_table = None
        if self.color_grade_lut is not None:
            lut_table = np.asarray(self.color_grade_lut.table)

        def execute(state: dict, ctx: FrameContext) -> dict:
            c = jnp.maximum(state["SceneColor"], 0.0)
            # Average log-luminance metering for auto exposure (the
            # reference's auto mode meters the scene each frame;
            # Camera::updateAutoExposure consumes this host-side).
            # Elementwise (no per-pixel dot; see mathx.transform_point_lanes).
            luma = 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]
            avg_log_lum = jnp.exp(jnp.mean(jnp.log(luma + 1e-4)))
            c = tm.tonemap(c, mode)
            yg = ypx + ctx.row_offset.astype(jnp.float32)
            if vign > 0.0:
                uv = jnp.stack([xpx / w, yg / full_h], axis=-1)
                c = tm.vignette(c, uv, vign)
            if grain > 0.0:
                pxy = jnp.stack([xpx, yg], axis=-1)
                c = tm.film_grain(c, pxy, ctx.frame_index.astype(jnp.float32), grain)
            out = jnp.clip(linear_to_srgb(c), 0.0, 1.0)
            if lut_table is not None:
                # 3D color-grade LUT on display-encoded values (the
                # reference's .cube grading in output.frag).
                from arkoserenderer.assets.external import apply_lut3d

                out = apply_lut3d(lut_table, out)
            return {"LDR": out, "Metering.avgLum": avg_log_lum}

        return execute
