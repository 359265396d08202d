"""Screen-space subsurface scattering.

Role-equivalent to SSSSNode (arkose/rendering/postprocess/SSSSNode.cpp +
shaders/subsurface/ssss.comp): Burley diffusion-profile importance taps on a
Fibonacci disc, applied to skin-masked pixels (the reference stencils skin;
we mask by the material's subsurface channel), with depth-aware tap
rejection. The world-space scattering radius maps to pixels through the
projection, so the blur shrinks with distance.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from arkoserenderer.core.halton import fibonacci_disc
from arkoserenderer.ops.image import bilinear_sample
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


def _burley_weight(r):
    """Normalized-ish Burley diffusion profile R(r), r in [0,1] of the
    sampling radius (d = 1/3)."""
    d = 1.0 / 3.0
    return jnp.exp(-r / d) + jnp.exp(-r / (3.0 * d))


class SSSSPass(RenderPass):
    name = "SSSS"

    def __init__(self, radius_world: float = 0.015, num_taps: int = 16,
                 temporal: bool | None = None, stochastic_taps: int = 4):
        self.radius_world = radius_world
        self.num_taps = num_taps
        # None = auto: jittered tap subset under TAA (it converges the
        # Burley profile — 16 serialized full-screen gather taps).
        self.temporal = temporal
        self.stochastic_taps = stochastic_taps

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneMaterial")
        reg.get("SceneDepth")
        temporal = self.temporal
        if temporal is None:
            temporal = cfg.texture_quality in ("stochastic", "stochastic1")
        n_eff = self.num_taps
        # numpy on purpose: closures become program constants (pixel_centers doc)
        taps = fibonacci_disc(
            self.stochastic_taps if temporal else self.num_taps
        ).astype(np.float32)
        radius_world = self.radius_world
        xs = (np.arange(w) + 0.5).astype(np.float32)
        ys = (np.arange(h) + 0.5).astype(np.float32)

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            sss = state["SceneMaterial"][..., 3]
            depth = state["SceneDepth"]
            if True:
                px, py = jnp.meshgrid(xs, ys)
                px = px.reshape(-1)
                py = py.reshape(-1)
            # Pixel radius: world radius projected — with reverse-Z infinite
            # far, depth = near/z so radius_px ∝ depth.
            g = ctx.camera.unjittered_proj[1, 1]
            r_px = radius_world * 0.5 * color.shape[0] * g * depth.reshape(-1) / ctx.camera.near
            r_px = jnp.clip(r_px, 0.0, 32.0)

            acc = color.reshape(-1, 3)
            wsum = jnp.ones((acc.shape[0], 1))
            d_center = depth.reshape(-1)
            cd = jnp.concatenate([color, depth[..., None]], axis=-1)
            if temporal:
                from arkoserenderer.ops.postprocess import (
                    _nearest_sample,
                    _pixel_noise,
                )

                ang = _pixel_noise(px, py, ctx.frame_index, 61) * (2.0 * jnp.pi)
                ca, sa = jnp.cos(ang), jnp.sin(ang)
            for i in range(taps.shape[0]):
                frac = jnp.linalg.norm(taps[i])
                if temporal:
                    # Per-pixel rotated disc tap, one packed gather; weight
                    # scaled so the center-vs-taps ratio matches the dense
                    # profile (expectation = full Burley fan; TAA converges).
                    dx = (taps[i, 0] * ca - taps[i, 1] * sa) * r_px
                    dy = (taps[i, 0] * sa + taps[i, 1] * ca) * r_px
                    both = _nearest_sample(cd, px + dx, py + dy)
                    c, d_tap = both[:, :3], both[:, 3]
                    scale_w = n_eff / taps.shape[0]
                else:
                    dx = taps[i, 0] * r_px
                    dy = taps[i, 1] * r_px
                    c = bilinear_sample(color, px + dx, py + dy)
                    d_tap = bilinear_sample(depth[..., None], px + dx, py + dy)[:, 0]
                    scale_w = 1.0
                wgt = scale_w * _burley_weight(frac) * jnp.clip(
                    1.0 - jnp.abs(d_tap - d_center) / jnp.maximum(d_center * 0.1, 1e-4),
                    0.0, 1.0,
                )
                acc = acc + c * wgt[:, None]
                wsum = wsum + wgt[:, None]
            blurred = (acc / wsum).reshape(color.shape)
            out = color + (blurred - color) * sss[..., None]
            return {"SceneColor": out}

        return execute
