"""Bloom: downsample pyramid + tent upsample + additive blend.

Role-equivalent to BloomNode (arkose/rendering/nodes/BloomNode.cpp +
shaders/bloom/{downsample,upsample,blend}.comp): a mip pyramid built by box
downsampling, collapsed back up with tent-filter upsamples, blended into
SceneColor with a small weight.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.ops.image import band_halo_rows, blur3, downsample2x, upsample2x
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class BloomPass(RenderPass):
    name = "Bloom"

    def __init__(self, levels: int = 5, strength: float = 0.04):
        self.levels = levels
        self.strength = strength

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("SceneColor")
        # Clamp level count to what the FULL frame can halve evenly — the
        # same depth whether rendering whole-frame or a sharded band (bands
        # may shrink to a single row per level; the 1-row halo keeps the
        # 3x3 stencils exact), so sharded output matches bit-for-bit.
        levels = self.levels
        h, w = cfg.frame_height, cfg.width
        band_h = cfg.height
        lv = 0
        while (lv < levels and h % 2 == 0 and w % 2 == 0 and h > 8 and w > 8
               and band_h % 2 == 0):
            h //= 2
            w //= 2
            band_h //= 2
            lv += 1
        levels = lv
        strength = self.strength
        # Pixel-band sharding: exchange one halo row per pyramid level over
        # ICI (ppermute) so the blur/upsample stencils are seam-exact — the
        # round-1 band-local carve-out is gone (tests/test_sharding runs
        # with bloom ON and exact single-device match).
        shard = (cfg.shard_axis, cfg.shard_count) if cfg.shard_axis else None

        def halo(x):
            if shard is None:
                return None
            return band_halo_rows(x, shard[0], shard[1])

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            chain = [color]
            x = color
            for _ in range(levels):
                x = downsample2x(blur3(x, halo_rows=halo(x)))
                chain.append(x)
            up = chain[-1]
            for i in range(levels - 1, 0, -1):
                up = chain[i] + upsample2x(up, halo_rows=halo(up))
            bloom = upsample2x(up, halo_rows=halo(up)) if levels > 0 else color
            return {"SceneColor": color + strength * bloom}

        return execute
