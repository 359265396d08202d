"""Visibility-buffer attribute reconstruction.

Given the raster's per-pixel setup-row ids, rebuild perspective-correct
barycentrics *analytically* at each pixel center — plus their screen-space
derivatives for gradient-correct texture LOD — and interpolate vertex
attributes. This is the array-program equivalent of the reference's
deferred visibility-buffer shading front-end (arkose/shaders/visibility-
buffer/shadeVisibilityBuffer.comp "CalcFullBary" + analytic gradients at
lines ~183-187 per SURVEY.md §2.5): there are no implicit quad derivatives
outside fragment shaders, so analytic gradients are the only (and better)
option.

Near-plane-clipped sub-triangles are transparent here: the per-pixel
barycentrics are computed in the *sub*-triangle and then mapped to the
ORIGINAL triangle through the setup's corner_bary matrices (barycentric
coordinates are themselves linear attributes, so perspective-correct
interpolation composes exactly).

All functions operate on flattened pixel arrays (N = H*W).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from arkoserenderer.core.mathx import HIGHEST
from arkoserenderer.ops.raster import TriSetup, edge_fn


class PixelGeom(NamedTuple):
    """Per-pixel interpolation data (all (N, ...))."""

    tri: jax.Array       # (N,) i32 ORIGINAL triangle id (clamped 0 if invalid)
    valid: jax.Array     # (N,) bool — pixel covered by geometry
    corners: jax.Array   # (N, 3) i32 vertex indices of the original triangle
    bary: jax.Array      # (N, 3) perspective-correct original barycentrics
    bary_dx: jax.Array   # (N, 3) bary at +1px in x (for gradients)
    bary_dy: jax.Array   # (N, 3) bary at +1px in y


def _persp_bary(sxy, inv_w, px, py):
    """Perspective-correct barycentrics of pixel (px,py) w.r.t. triangle
    screen corners sxy (N,3,2) with per-vertex 1/w (N,3)."""
    e0 = edge_fn(sxy[:, 1], sxy[:, 2], px, py)
    e1 = edge_fn(sxy[:, 2], sxy[:, 0], px, py)
    e2 = edge_fn(sxy[:, 0], sxy[:, 1], px, py)
    e = jnp.stack([e0, e1, e2], axis=-1)  # screen-space (unnormalized)
    pw = e * inv_w
    den = jnp.sum(pw, axis=-1, keepdims=True)
    # Guarded: background pixels gather clamped rows whose weights can sum
    # to zero; no inf/NaN may reach the frame.
    return pw * jnp.where(
        jnp.abs(den) > 1e-20, 1.0 / jnp.where(den == 0, 1.0, den), 0.0
    )


def pixel_barycentrics(
    vis_flat: jax.Array,
    setup: TriSetup,
    indices: jax.Array,
    px: jax.Array,
    py: jax.Array,
) -> PixelGeom:
    """vis_flat: (N,) setup-row ids (VIS_NONE = background); px/py: (N,)
    pixel centers; indices: the scene triangle index pool (T, 3)."""
    valid = vis_flat >= 0
    row = jnp.maximum(vis_flat, 0)
    sxy = setup.screen_xy[row]       # (N, 3, 2)
    inv_w = setup.inv_w[row]         # (N, 3)
    orig = setup.orig_tri[row]       # (N,)
    cb = setup.corner_bary[row]      # (N, 3, 3) rows = corner barys
    corners = indices[orig]          # (N, 3)

    def to_orig(sub_bary):
        return jnp.einsum("nk,nkj->nj", sub_bary, cb, precision=HIGHEST)

    bary = to_orig(_persp_bary(sxy, inv_w, px, py))
    bary_dx = to_orig(_persp_bary(sxy, inv_w, px + 1.0, py))
    bary_dy = to_orig(_persp_bary(sxy, inv_w, px, py + 1.0))
    return PixelGeom(
        tri=orig, valid=valid, corners=corners,
        bary=bary, bary_dx=bary_dx, bary_dy=bary_dy,
    )


def interpolate(attr: jax.Array, geom: PixelGeom) -> jax.Array:
    """(V, C) vertex attribute -> (N, C) perspective-correct per-pixel value."""
    vals = attr[geom.corners]  # (N, 3, C)
    return jnp.einsum("nk,nkc->nc", geom.bary, vals, precision=HIGHEST)


def interpolate_with_grad(attr: jax.Array, geom: PixelGeom):
    """Returns (value, d/dx, d/dy), each (N, C)."""
    vals = attr[geom.corners]  # (N, 3, C)
    v = jnp.einsum("nk,nkc->nc", geom.bary, vals, precision=HIGHEST)
    vx = jnp.einsum("nk,nkc->nc", geom.bary_dx, vals, precision=HIGHEST)
    vy = jnp.einsum("nk,nkc->nc", geom.bary_dy, vals, precision=HIGHEST)
    return v, vx - v, vy - v
