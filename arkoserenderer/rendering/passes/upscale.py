"""Upscale passes: LDR render-res -> display-res (the DLSS slot).

Role-equivalent to DLSSNode (arkose/rendering/upscaling/DLSSNode.cpp:8-101):
sits at the end of the chain; the pipeline renders at cfg.width/height and
this pass produces the display-resolution image. (The reference also drives
a global texture mip bias from the ratio — our texture LOD already uses
analytic gradients in render-pixel space, plus the cfg.mip_bias drive.)

Two implementations of the slot:

  * ``TemporalUpscalePass`` (default — the honest DLSS equivalent): a
    temporal super-resolution accumulator. Each frame's Halton-jittered
    render-res image is resampled to display res with jitter-compensated
    weights (ops/image.resize_bilinear_rational_jittered — the sub-pixel
    jitter makes successive frames sample BETWEEN render pixels, which is
    where the extra resolution comes from), then blended into a persistent
    DISPLAY-RES history reprojected along motion vectors with
    variance-based rectification (clamp relaxes where the image is static
    so detail beyond the single-frame band can accumulate).
  * ``UpscalePass``: the spatial fallback (FSR1-style resample + RCAS).

Shape: both are gather-free on the static path — phase-decomposed
strided slices with (for TSR) traced jitter weights; the history reproject
reuses TAA's nine-shift sub-pixel fast path under lax.cond.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.ops.image import (
    bilinear_sample,
    bilinear_sample_small_offset,
    resize_bilinear_rational,
    resize_bilinear_rational_jittered,
)
from arkoserenderer.ops.postprocess import cas
from arkoserenderer.ops.upscale import upscale
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class TemporalUpscalePass(RenderPass):
    """Temporal super-resolution (TAA-U) — the DLSS-slot default.

    Accumulates jittered render-res frames directly into display-res
    history (DLSSNode.cpp:48-51 renders below display res and lets the
    temporal feature reconstruct). Rectification: the history is clamped to
    mean +/- gamma * sigma of the current upsample's 3x3 neighborhood;
    gamma widens from 1 to ~4 as per-pixel motion approaches zero, letting
    static regions converge to the supersampled limit while moving regions
    stay ghost-free.
    """

    name = "TemporalUpscale"

    def __init__(self, display_width: int, display_height: int,
                 hysteresis: float = 0.9, sharpness: float = 0.25):
        self.display = (display_width, display_height)
        self.hysteresis = hysteresis
        self.sharpness = sharpness

    def construct(self, cfg: PipelineConfig, reg: Registry):
        rh, rw = cfg.height, cfg.width
        dw, dh = self.display
        reg.get("LDR")
        reg.get("SceneVelocity")
        reg.create("UpscaleHistory", (dh, dw, 3), jnp.float32, persistent=True)
        reg.create("LDRDisplay", (dh, dw, 3), jnp.float32)
        sx, sy = dw / rw, dh / rh
        hysteresis = self.hysteresis
        sharp = self.sharpness
        xs = np.arange(dw, dtype=np.float32) + 0.5
        ys = np.arange(dh, dtype=np.float32) + 0.5
        # numpy on purpose: closures become program constants
        px, py = np.meshgrid(xs, ys)

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["LDR"]
            history = state["UpscaleHistory"]
            jx = ctx.camera.jitter_px[0]
            jy = ctx.camera.jitter_px[1]

            cur = resize_bilinear_rational_jittered(color, dh, dw, jx, jy)

            # Display-space motion vectors (render px -> display px).
            vel = resize_bilinear_rational(state["SceneVelocity"], dh, dw)
            vel = vel * jnp.array([sx, sy], jnp.float32)
            speed = jnp.sqrt(jnp.sum(vel * vel, axis=-1, keepdims=True))
            max_v = jnp.max(speed)

            def _fast(_):
                return bilinear_sample_small_offset(
                    history, -vel[..., 0], -vel[..., 1])

            def _slow(_):
                prev_x = px - vel[..., 0].reshape(dh, dw)
                prev_y = py - vel[..., 1].reshape(dh, dw)
                return bilinear_sample(
                    history, prev_x.ravel(), prev_y.ravel()).reshape(dh, dw, 3)

            hist = jax.lax.cond(max_v <= 1.0, _fast, _slow, None)

            # Variance rectification over the current upsample's 3x3.
            from arkoserenderer.ops.postprocess import shift_img

            m1 = jnp.zeros_like(cur)
            m2 = jnp.zeros_like(cur)
            for oy in (-1, 0, 1):
                for ox in (-1, 0, 1):
                    s = shift_img(cur, oy, ox)
                    m1 = m1 + s
                    m2 = m2 + s * s
            m1 = m1 / 9.0
            sigma = jnp.sqrt(jnp.maximum(m2 / 9.0 - m1 * m1, 0.0))
            static_w = jnp.exp(-8.0 * speed)  # ~1 when still, ~0 in motion
            gamma = 1.0 + 3.0 * static_w
            hist = jnp.clip(hist, m1 - gamma * sigma, m1 + gamma * sigma)

            prev_x = px - vel[..., 0].reshape(dh, dw)
            prev_y = py - vel[..., 1].reshape(dh, dw)
            on_screen = (
                (prev_x >= 0.0) & (prev_x < dw) & (prev_y >= 0.0) & (prev_y < dh)
            )[..., None]
            first_frame = ctx.frame_index == 0
            alpha = jnp.where(first_frame | ~on_screen, 1.0, 1.0 - hysteresis)
            out = hist + (cur - hist) * alpha
            disp = cas(jnp.clip(out, 0.0, 1.0), sharp) if sharp > 0.0 else out
            return {"LDRDisplay": jnp.clip(disp, 0.0, 1.0),
                    "UpscaleHistory": out}

        return execute


class UpscalePass(RenderPass):
    name = "Upscale"

    def __init__(self, display_width: int, display_height: int, sharpness: float = 0.4):
        self.display = (display_width, display_height)
        self.sharpness = sharpness

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")
        dw, dh = self.display
        reg.create("LDRDisplay", (dh, dw, 3), jnp.float32)
        sharp = self.sharpness

        def execute(state: dict, ctx: FrameContext) -> dict:
            out = upscale(state["LDR"], dh, dw, sharp)
            return {"LDRDisplay": out}

        return execute
