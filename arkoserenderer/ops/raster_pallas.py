"""Stage-4 visibility raster as a Pallas kernel for the GPU (Triton route).

Same contract as ``ops/raster.rasterize_tiles_reference`` — the plain XLA
walk it is tested against — and selected for it on the GPU by
``ops/raster.rasterize_tiles``.

One program per screen tile. The program reads its own bin range
(``starts[t]``, ``counts[t]``), walks the tile's triangle list and then the
shared big-triangle list, and keeps the tile's depth and
visibility in registers: the whole walk is one launch, where the XLA version
is a while loop per tile chunk whose trip count is data-dependent. Triangle
data is read straight from the setup arrays (``screen_xy``, ``z_ndc``) with
scalar loads that every thread of the program shares; nothing is
pre-gathered.

Every product and the one division go through PTX ``mul.rn.f32`` and
``div.rn.f32``: IEEE float32 rounding, never fused into a multiply-add or
replaced by an approximate reciprocal. The kernel's arithmetic is then
exactly NumPy's float32 arithmetic on the same expressions, so coverage (the
sign of every edge function) and depth match a plain float32 reference bit
for bit, and a pixel centre that lies on an edge falls on the same side.

The tile (``tile_h * tile_w`` pixels) is the program's block, so it must be
a power of two, as Triton requires.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from arkoserenderer.core.mathx import DEPTH_FAR
from arkoserenderer.core.types import VIS_NONE, RasterConfig
from arkoserenderer.ops.raster import (
    TileBins,
    TriSetup,
    image_to_tiled,
    num_tiles,
    tiled_to_image,
)

# One warp per tile: fastest on the 8192^2 shadow map and within noise of
# 2-8 warps on the 1080p primary view (tools/profiling/ab_raster.py).
NUM_WARPS = 1


def _ieee(op, a, b):
    """``op`` ("mul" or "div") of two float32 tiles, IEEE round-to-nearest:
    never fused into a multiply-add, never approximated."""
    [out] = pltriton.elementwise_inline_asm(
        f"{op}.rn.f32 $0, $1, $2;", args=[a, b], constraints="=f,f,f", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, jnp.float32)],
    )
    return out


def _raster_kernel(starts_ref, counts_ref, sorted_ref, glob_ref, gcount_ref,
                   yoff_ref, sxy_ref, z_ref, *rest,
                   tile_h, tile_w, ntx, has_limit, depth_only, interpret):
    if has_limit:
        lim_ref, *outs = rest
    else:
        lim_ref, outs = None, rest
    depth_ref = outs[0]
    t = pl.program_id(0)
    p = jax.lax.broadcasted_iota(jnp.int32, (tile_h * tile_w,), 0)
    px = ((t % ntx) * tile_w + p % tile_w).astype(jnp.float32) + 0.5
    py = ((t // ntx) * tile_h + p // tile_w + yoff_ref[0]).astype(
        jnp.float32) + 0.5
    lim = lim_ref[...] if has_limit else None
    zero = jnp.zeros_like(px)

    def mul(a, b):
        # Operands as full tiles: the inline assembly is elementwise over
        # equal shapes. The interpreter (CPU) rounds each op already.
        a, b = a + zero, b + zero
        return a * b if interpret else _ieee("mul", a, b)

    def div(a, b):
        a, b = a + zero, b + zero
        return a / b if interpret else _ieee("div", a, b)

    def edge(ax, ay, bx, by):
        # ops/raster.edge_fn, term for term.
        return mul(by - ay, px - ax) - mul(bx - ax, py - ay)

    def shade(tri, depth, vis):
        x0, y0 = sxy_ref[tri, 0, 0], sxy_ref[tri, 0, 1]
        x1, y1 = sxy_ref[tri, 1, 0], sxy_ref[tri, 1, 1]
        x2, y2 = sxy_ref[tri, 2, 0], sxy_ref[tri, 2, 1]
        e0 = edge(x1, y1, x2, y2)
        e1 = edge(x2, y2, x0, y0)
        e2 = edge(x0, y0, x1, y1)
        area2 = mul(y1 - y0, x2 - x0) - mul(x1 - x0, y2 - y0)
        inv_area = jnp.where(
            jnp.abs(area2) > 1e-12, div(1.0, jnp.where(area2 == 0, 1.0, area2)),
            0.0,
        )
        l0, l1, l2 = mul(e0, inv_area), mul(e1, inv_area), mul(e2, inv_area)
        d = (mul(l0, z_ref[tri, 0]) + mul(l1, z_ref[tri, 1])
             + mul(l2, z_ref[tri, 2]))
        covered = (l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (d > depth)
        if has_limit:
            covered = covered & (d < lim)
        return jnp.where(covered, d, depth), jnp.where(covered, tri, vis)

    start = starts_ref[t]

    def step_local(i, carry):
        return shade(sorted_ref[start + i], *carry)

    def step_global(j, carry):
        return shade(glob_ref[j], *carry)

    # Local list first, then the global list: the reference's order, so
    # depth ties resolve to the same triangle.
    carry = (jnp.full((tile_h * tile_w,), DEPTH_FAR, jnp.float32),
             jnp.full((tile_h * tile_w,), VIS_NONE, jnp.int32))
    carry = jax.lax.fori_loop(0, counts_ref[t], step_local, carry)
    depth, vis = jax.lax.fori_loop(0, gcount_ref[0], step_global, carry)
    depth_ref[...] = depth
    if not depth_only:
        outs[1][...] = vis


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "cfg", "depth_only", "interpret",
                     "num_warps"),
)
def rasterize_tiles_pallas(
    setup: TriSetup,
    bins: TileBins,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
    depth_only: bool = False,
    y_offset: int | jax.Array = 0,
    depth_limit: jax.Array | None = None,
    interpret: bool = False,
    num_warps: int = NUM_WARPS,
):
    """Pallas stage-4 raster; same arguments and results as
    ``ops/raster.rasterize_tiles_reference``. ``interpret`` runs the kernel
    in the Pallas interpreter (CPU tests)."""
    nty, ntx = num_tiles(width, height, cfg)
    ntiles = nty * ntx
    npx = cfg.tile_h * cfg.tile_w
    if npx & (npx - 1):
        raise ValueError(f"tile {cfg.tile_h}x{cfg.tile_w} is not a power of two "
                         "pixels, which the Triton kernel needs")
    has_limit = depth_limit is not None

    kernel = functools.partial(
        _raster_kernel, tile_h=cfg.tile_h, tile_w=cfg.tile_w, ntx=ntx,
        has_limit=has_limit, depth_only=depth_only, interpret=interpret,
    )
    tile_spec = pl.BlockSpec((None, npx), lambda t: (t, 0))
    args = [
        bins.starts, bins.counts, bins.sorted_tris, bins.global_tris,
        jnp.reshape(bins.global_count, (1,)).astype(jnp.int32),
        jnp.reshape(jnp.asarray(y_offset, jnp.int32), (1,)),
        setup.screen_xy, setup.z_ndc,
    ]
    in_specs = [pl.no_block_spec] * len(args)
    if has_limit:
        args.append(image_to_tiled(depth_limit, cfg))
        in_specs.append(tile_spec)
    out_shape = [jax.ShapeDtypeStruct((ntiles, npx), jnp.float32)]
    if not depth_only:
        out_shape.append(jax.ShapeDtypeStruct((ntiles, npx), jnp.int32))
    outs = pl.pallas_call(
        kernel,
        grid=(ntiles,),
        in_specs=in_specs,
        out_specs=[tile_spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="raster_tiles",
    )(*args)

    depth = tiled_to_image(outs[0], width, height, cfg)
    if depth_only:
        vis = jnp.full((height, width), VIS_NONE, jnp.int32)
    else:
        vis = tiled_to_image(outs[1], width, height, cfg)
    return vis, depth
