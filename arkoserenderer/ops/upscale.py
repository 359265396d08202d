"""Spatial upscaling: phase-decomposed bilinear resample + RCAS sharpening.

Role-equivalent to the reference's upscaling slot (arkose/rendering/
upscaling/DLSSNode.cpp — an ExternalFeature evaluating DLSS with an
``idealRenderResolution`` below display resolution): the vendor black box is
replaced by an open FSR1-style spatial chain — resample (EASU stand-in) +
robust contrast-adaptive sharpening (RCAS stand-in). Temporal accumulation
already happens in TAA upstream.

Note: the resample is ops/image.resize_bilinear_rational — static strided
slices + lerps per phase, zero gathers (an earlier Catmull-Rom version
issued 16 row gathers at DISPLAY resolution). Render/display ratios are therefore chosen as
small rationals (3/2, 5/3, 2/1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.ops.image import resize_bilinear_rational
from arkoserenderer.ops.postprocess import cas


def upscale(img: jax.Array, out_h: int, out_w: int, sharpness: float = 0.4) -> jax.Array:
    """(h, w, C) -> (out_h, out_w, C) bilinear resample + adaptive sharpen."""
    out = jnp.clip(resize_bilinear_rational(img, out_h, out_w), 0.0, 1.0)
    if sharpness > 0.0:
        out = cas(out, sharpness)
    return out


def ideal_render_resolution(display_w: int, display_h: int, quality: str = "quality"):
    """Render-resolution presets (DLSSNode::optimalRenderResolution
    analogue). Ratios are exact small rationals so the gather-free
    phase-resample applies: quality 2/3, balanced 3/5, performance 1/2."""
    num, den = {"quality": (2, 3), "balanced": (3, 5), "performance": (1, 2)}[quality]

    def snap(v):
        # Round down to a multiple of den*8 so render = v*num/den is a
        # multiple of 8 (raster tiles) and the ratio stays exact.
        return (v // (den * 8)) * (den * 8)

    w8, h8 = snap(display_w), snap(display_h)
    return w8 * num // den, h8 * num // den
