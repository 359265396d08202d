"""Tile-based triangle rasterization as XLA programs.

This is the array-program replacement for the reference's GPU raster pipelines —
both the classic vertex/fragment path (arkose/rendering/forward/
ForwardRenderNode.cpp) and the GPU-driven mesh-shading visibility-buffer path
(arkose/rendering/meshlet/MeshletVisibilityBufferRenderNode.cpp,
arkose/shaders/meshlet/meshletVisibilityBuffer.{task,mesh}). The
fixed-function rasterizer is not reachable from JAX, so the pipeline is
rebuilt as four data-parallel stages over static-shape pools:

  1. ``setup_triangles``   — batched vertex gather + near-plane clipping +
                             screen mapping + backface cull (the "vertex +
                             task shader" stage).
  2. near-plane clipping   — triangles crossing w = eps are clipped
                             geometrically into 1-2 sub-triangles written to
                             a fixed overflow region. Sub-triangles remember
                             their ORIGINAL triangle id and the barycentric
                             coordinates of their corners w.r.t. it, so the
                             visibility buffer and deferred shading stay
                             blissfully unaware of clipping.
  3. ``bin_triangles``     — conservative bbox binning into per-tile
                             fixed-capacity lists via a scan of cumsum +
                             scatter chunks (replaces the subgroup ballot +
                             atomicAdd compaction of meshletTaskSetup.comp).
  4. ``rasterize_tiles``   — per-tile z-buffered edge-function raster
                             producing a *visibility buffer*: setup-row id +
                             depth per pixel.

Depth is reverse-Z (see core/mathx.py). ``VIS_NONE`` (-1) marks background.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core.types import VIS_NONE, RasterConfig
from arkoserenderer.core.mathx import DEPTH_FAR

TILE_CHUNK = 256   # occupancy-sorted raster tile chunk (see rasterize_tiles)


class TriSetup(NamedTuple):
    """Per-raster-triangle screen-space setup data (shapes (T', ...) where
    T' = T + clip budget)."""

    screen_xy: jax.Array    # (T', 3, 2) pixel coords of the 3 corners
    z_ndc: jax.Array        # (T', 3) reverse-Z ndc depth per corner
    inv_w: jax.Array        # (T', 3) 1/w_clip per corner
    valid: jax.Array        # (T',) bool
    bbox: jax.Array         # (T', 4) [x0, y0, x1, y1] pixel AABB (inclusive)
    orig_tri: jax.Array     # (T',) i32 original triangle id (for shading)
    corner_bary: jax.Array  # (T', 3, 3) barycentrics of each corner w.r.t.
                            #            the original triangle (identity when
                            #            unclipped)
    clip_overflow: jax.Array  # () i32 clipped sub-triangles dropped


class TileBins(NamedTuple):
    """Per-tile triangle lists in sorted-pair form.

    ``sorted_tris[starts[t] : starts[t] + counts[t]]`` are the setup-row ids
    binned to tile ``t`` (triangles whose bbox spans <= max_tiles_per_tri
    tiles). Larger triangles live in the ``global_tris`` list which every
    tile walks with a bbox pre-test (few of them: floors, sky quads, clipped
    monsters).
    """

    sorted_tris: jax.Array   # (T' * C,) i32 tri ids grouped by tile
    starts: jax.Array        # (num_tiles + 1,) i32 group starts
    counts: jax.Array        # (num_tiles,) i32 min(group size, K)
    global_tris: jax.Array   # (G,) i32, -1 padded
    global_count: jax.Array  # () i32
    overflow: jax.Array      # () i32 entries dropped by the K cap / G cap


def num_tiles(width: int, height: int, cfg: RasterConfig) -> tuple[int, int]:
    assert width % cfg.tile_w == 0 and height % cfg.tile_h == 0, (
        f"viewport {width}x{height} must be a multiple of tile {cfg.tile_w}x{cfg.tile_h}"
    )
    return height // cfg.tile_h, width // cfg.tile_w


def edge_fn(a, b, px, py):
    """Signed edge function, oriented so that a triangle wound CCW in world
    (y-up) terms — which appears CW in y-down screen space — yields positive
    values inside, and a positive doubled area."""
    return (b[..., 1] - a[..., 1]) * (px - a[..., 0]) - (b[..., 0] - a[..., 0]) * (
        py - a[..., 1]
    )


# ---------------------------------------------------------------------------
# Stage 1+2: gather, clip, setup


def _near_clip(tri_clip, tri_valid, w_eps, extra_budget: int):
    """Clip (T,3,4) triangles against w = w_eps.

    Returns (clip (T+E,3,4), corner_bary (T+E,3,3), orig (T+E,), valid (T+E,),
    overflow ()) where slot t < T holds triangle t's (possibly clipped)
    replacement and the E extra slots hold second halves of quad clips.
    """
    t_total = tri_clip.shape[0]
    w = tri_clip[..., 3]
    inside = w > w_eps                      # (T, 3)
    n_in = jnp.sum(inside, axis=-1)         # (T,)

    # Canonical rotation: index of the distinguished vertex.
    #   n_in == 2 -> rotate so the single OUTSIDE vertex lands at corner 2.
    #   n_in == 1 -> rotate so the single INSIDE vertex lands at corner 0.
    out_idx = jnp.argmin(inside, axis=-1)   # first False (any when none)
    in_idx = jnp.argmax(inside, axis=-1)    # first True
    start = jnp.where(n_in == 2, (out_idx + 1) % 3, in_idx)  # (T,)
    # start only takes 3 values, so the rotation is a 3-way SELECT between
    # static rolls — rolls are slices and the selects fuse, where a
    # data-dependent take_along_axis would be a gather over the pool.
    s3 = start[:, None, None]
    rot = jnp.where(
        s3 == 0, tri_clip,
        jnp.where(s3 == 1, jnp.roll(tri_clip, -1, axis=1),
                  jnp.roll(tri_clip, -2, axis=1)))
    ident = jnp.broadcast_to(jnp.eye(3, dtype=tri_clip.dtype), (t_total, 3, 3))
    eye = jnp.eye(3, dtype=tri_clip.dtype)
    rot_bary = jnp.where(
        s3 == 0, ident,
        jnp.where(s3 == 1,
                  jnp.broadcast_to(jnp.roll(eye, -1, axis=0), (t_total, 3, 3)),
                  jnp.broadcast_to(jnp.roll(eye, -2, axis=0), (t_total, 3, 3))))

    a, b, c = rot[:, 0], rot[:, 1], rot[:, 2]
    ba, bb, bc = rot_bary[:, 0], rot_bary[:, 1], rot_bary[:, 2]
    wa, wb, wc = a[:, 3], b[:, 3], c[:, 3]

    def lerp_to_plane(p, q, bp, bq, wp, wq):
        t = ((w_eps - wp) / jnp.where(jnp.abs(wq - wp) > 1e-20, wq - wp, 1.0))[:, None]
        t = jnp.clip(t, 0.0, 1.0)
        return p + t * (q - p), bp + t * (bq - bp)

    # n_in==2 (A,B in, C out): crossings on B->C and A->C.
    i_bc, by_bc = lerp_to_plane(b, c, bb, bc, wb, wc)
    i_ac, by_ac = lerp_to_plane(a, c, ba, bc, wa, wc)
    # n_in==1 (A in, B,C out): crossings on A->B and A->C.
    i_ab, by_ab = lerp_to_plane(a, b, ba, bb, wa, wb)

    n_in_b = n_in[:, None, None]
    # Primary slot replacement per case.
    prim = jnp.where(
        n_in_b == 3,
        tri_clip,
        jnp.where(
            n_in_b == 2,
            jnp.stack([a, b, i_bc], axis=1),
            jnp.stack([a, i_ab, i_ac], axis=1),
        ),
    )
    prim_bary = jnp.where(
        n_in_b == 3,
        ident,
        jnp.where(
            n_in_b == 2,
            jnp.stack([ba, bb, by_bc], axis=1),
            jnp.stack([ba, by_ab, by_ac], axis=1),
        ),
    )
    prim_valid = tri_valid & (n_in > 0)

    # Secondary (overflow) triangle for the quad case.
    needs_extra = tri_valid & (n_in == 2)
    extra_tri = jnp.stack([a, i_bc, i_ac], axis=1)
    extra_bary = jnp.stack([ba, by_bc, by_ac], axis=1)

    # Compact the (few) quad-case triangle ids with one i32 sort, then GATHER
    # their payloads into the E extra slots, instead of the obvious scatter
    # (.at[dest].set over all T source rows, 4x); the sort+gather form fills
    # the slots in the same stable submission order (keys are distinct
    # indices).
    key = jnp.where(needs_extra, jnp.arange(t_total, dtype=jnp.int32), t_total)
    key_sorted = jax.lax.sort(key)
    if extra_budget > t_total:
        key_sorted = jnp.pad(
            key_sorted, (0, extra_budget - t_total), constant_values=t_total
        )
    sel = key_sorted[:extra_budget]           # tri id per extra slot (T = none)
    ok = sel < t_total
    src = jnp.where(ok, sel, 0)
    okf = ok[:, None, None]
    # Keep unfilled slots at exactly zero (w == 0 padding rows — downstream
    # guards rely on it; see clip_to_screen).
    e_clip = jnp.where(okf, extra_tri[src], 0.0)
    e_bary = jnp.where(okf, extra_bary[src], 0.0)
    e_orig = jnp.where(ok, sel, 0)

    clip_all = jnp.concatenate([prim, e_clip], axis=0)
    bary_all = jnp.concatenate([prim_bary, e_bary], axis=0)
    orig_all = jnp.concatenate(
        [jnp.arange(t_total, dtype=jnp.int32), e_orig], axis=0
    )
    valid_all = jnp.concatenate([prim_valid, ok], axis=0)
    overflow = jnp.maximum(
        jnp.sum(needs_extra) - jnp.asarray(extra_budget, jnp.int32), 0
    )
    return clip_all, bary_all, orig_all, valid_all, overflow


def clip_to_screen(clip: jax.Array, width: int, height: int):
    """(..., 4) clip -> (..., 2) pixel coords, (...,) z_ndc, (...,) inv_w.

    Screen convention: x right, y down, pixel centers at integer+0.5. Clip +Y
    is up, so y is flipped here (the "viewport transform").

    Guarded division: pool-padding rows carry w == 0 and must NOT produce
    inf/NaN in downstream programs.
    """
    w = clip[..., 3]
    inv_w = jnp.where(jnp.abs(w) > 1e-12, 1.0 / jnp.where(w == 0, 1.0, w), 0.0)
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return jnp.stack([sx, sy], axis=-1), ndc[..., 2], inv_w


def default_clip_budget(num_tris: int) -> int:
    return max(num_tris // 8, 64)


def setup_triangles(
    clip: jax.Array,
    indices: jax.Array,
    tri_valid: jax.Array,
    width: int,
    height: int,
    cull_backfaces: bool = True,
    w_eps: float | jax.Array = 1e-4,
    clip_budget: int | None = None,
) -> TriSetup:
    """Stage 1+2: gather vertices, near-clip, map to screen, cull, bbox.

    ``indices``: (T, 3) i32. ``tri_valid``: (T,) bool mask for pool padding.
    Front-facing = counter-clockwise (y-up world terms).

    ``w_eps``: the clip plane in w. Pass the camera NEAR value for
    perspective projections — that both enforces the true near plane
    (geometry closer than near would alias to depth > 1) and keeps clipped
    corners' screen coordinates small enough for exact f32 edge functions.
    May be a traced scalar.
    """
    t_total = indices.shape[0]
    if clip_budget is None:
        clip_budget = default_clip_budget(t_total)
    tri_clip = clip[indices]  # (T, 3, 4)

    tri_clip, corner_bary, orig_tri, valid, clip_overflow = _near_clip(
        tri_clip, tri_valid, w_eps, clip_budget
    )

    screen, z_ndc, inv_w = clip_to_screen(tri_clip, width, height)

    p0, p1, p2 = screen[:, 0], screen[:, 1], screen[:, 2]
    area2 = edge_fn(p0, p1, p2[..., 0], p2[..., 1])  # (T',)
    if cull_backfaces:
        facing = area2 > 1e-12
    else:
        facing = jnp.abs(area2) > 1e-12

    xy_min = jnp.min(screen, axis=1)
    xy_max = jnp.max(screen, axis=1)
    bbox = jnp.concatenate([xy_min, xy_max], axis=-1)
    on_screen = (
        (bbox[:, 2] >= 0.0)
        & (bbox[:, 3] >= 0.0)
        & (bbox[:, 0] < width)
        & (bbox[:, 1] < height)
    )

    valid = valid & facing & on_screen
    return TriSetup(
        screen_xy=screen,
        z_ndc=z_ndc,
        inv_w=inv_w,
        valid=valid,
        bbox=bbox,
        orig_tri=orig_tri,
        corner_bary=corner_bary,
        clip_overflow=clip_overflow,
    )


# ---------------------------------------------------------------------------
# Stage 3: binning


def bin_triangles(
    setup: TriSetup,
    width: int,
    height: int,
    cfg: RasterConfig,
    y_offset: int | jax.Array = 0,
) -> TileBins:
    """Stage 3: build per-tile triangle lists, sort-based.

    Emit (tile, tri) pairs per triangle from its tile-space bbox, sort all
    pairs by (tile, tri), and recover per-tile ranges with a searchsorted
    over the sorted keys. This is the XLA-native equivalent of the
    reference's ballot/atomic compaction (meshletTaskSetup.comp): one
    O(P log P) vectorized sort instead of millions of serialized scatter
    updates. Triangles spanning more than
    ``C = max_tiles_per_tri`` tiles (clipped floors, close-ups) go to a
    small global list that every tile walks with a bbox pre-test.

    Pair emission is TIERED to keep the sort small: in real scenes the
    overwhelming majority of triangles cover 1-2 tiles (95K of 111K camera
    tris, 771K of 774K sun-shadow tris on the 4096-instance stress scene),
    so every triangle gets 2 pair slots and the few spanning 3..C tiles are
    sort-compacted into a ``max_mid_tris`` side list that gets C slots each.
    That is ~4x fewer sort keys than C slots for everyone, and the
    (tile, tri) two-key sort keeps per-tile lists in ascending-triangle
    order, so results are identical. Mid-list overflow is counted in
    ``overflow`` (same budget-with-counter contract as the bin caps).

    ``height`` is the BAND height when rendering a horizontal window of a
    taller viewport; ``y_offset`` (pixels, may be traced — used by the
    pixel-band SPMD sharding) positions the band in screen space.
    """
    nty, ntx = num_tiles(width, height, cfg)
    ntiles = nty * ntx
    k_cap = cfg.max_tris_per_tile
    c = cfg.max_tiles_per_tri
    g_cap = cfg.max_global_tris
    t_total = setup.valid.shape[0]

    tx0 = jnp.clip(jnp.floor(setup.bbox[:, 0] / cfg.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(
        jnp.floor((setup.bbox[:, 1] - y_offset) / cfg.tile_h), 0, nty - 1
    ).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(setup.bbox[:, 2] / cfg.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty1 = jnp.clip(
        jnp.floor((setup.bbox[:, 3] - y_offset) / cfg.tile_h), 0, nty - 1
    ).astype(jnp.int32)
    in_band = (setup.bbox[:, 3] >= y_offset) & (setup.bbox[:, 1] < y_offset + height)
    valid = setup.valid & in_band

    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    span = span_x * span_y
    big = valid & (span > c)
    overflow_mid = jnp.zeros((), jnp.int32)

    def emit(ids, n_slots, ok_mask, _tx0, _ty0, _sx, _span):
        """(N,) tri ids -> (N*n_slots,) tile keys + tri values."""
        ks = jnp.arange(n_slots, dtype=jnp.int32)[None, :]
        kx = ks % _sx[:, None]
        ky = ks // _sx[:, None]
        tile = (_ty0[:, None] + ky) * ntx + (_tx0[:, None] + kx)
        pair_ok = ok_mask[:, None] & (ks < _span[:, None])
        k = jnp.where(pair_ok, tile, ntiles).reshape(-1)    # invalid -> end
        v = jnp.broadcast_to(ids[:, None], (ids.shape[0], n_slots)).reshape(-1)
        return k, v

    c_a = min(2, c)
    all_ids = jnp.arange(t_total, dtype=jnp.int32)
    keys_a, tris_a = emit(
        all_ids, c_a, valid & (span <= c_a), tx0, ty0, span_x, span
    )
    if c > c_a:
        # Mid tier: sort-compact the few span-in-(2, C] triangle ids, then
        # give each C pair slots. Budget default: 1/8 of the pool (the
        # measured mid share is ~1.5%), floor 2048.
        m_cap = cfg.max_mid_tris or max(t_total // 8, 2048)
        mid = valid & (span > c_a) & (span <= c)
        mid_key = jnp.where(mid, all_ids, t_total)
        mid_sorted = jax.lax.sort(mid_key)
        if m_cap > t_total:
            mid_sorted = jnp.pad(
                mid_sorted, (0, m_cap - t_total), constant_values=t_total
            )
        sel = mid_sorted[:m_cap]
        ok = sel < t_total
        src = jnp.where(ok, sel, 0)
        keys_b, tris_b = emit(
            sel, c, ok, tx0[src], ty0[src], span_x[src], span[src]
        )
        keys = jnp.concatenate([keys_a, keys_b])
        tris = jnp.concatenate([tris_a, tris_b])
        overflow_mid = jnp.maximum(
            jnp.sum(mid) - jnp.asarray(m_cap, jnp.int32), 0
        )
    else:
        keys, tris = keys_a, tris_a
    # Two keys (tile, tri): per-tile lists come out in ascending-triangle
    # order — the same order tri-major emission gave the untiered sort.
    sorted_keys, sorted_tris = jax.lax.sort((keys, tris), num_keys=2)

    starts = jnp.searchsorted(sorted_keys, jnp.arange(ntiles + 1, dtype=jnp.int32))
    raw_counts = (starts[1:] - starts[:-1]).astype(jnp.int32)
    counts = jnp.minimum(raw_counts, k_cap)
    overflow = jnp.sum(raw_counts - counts)

    # Global list: compact the (few) big-triangle ids via a small sort.
    big_key = jnp.where(big, jnp.arange(t_total, dtype=jnp.int32), t_total)
    big_sorted = jax.lax.sort(big_key)
    if t_total < g_cap:
        big_sorted = jnp.pad(big_sorted, (0, g_cap - t_total), constant_values=t_total)
    n_big = jnp.sum(big).astype(jnp.int32)
    g_count = jnp.minimum(n_big, g_cap)
    global_tris = jnp.where(
        jnp.arange(g_cap) < g_count, big_sorted[:g_cap], VIS_NONE
    ).astype(jnp.int32)
    overflow = overflow + (n_big - g_count) + overflow_mid

    return TileBins(
        sorted_tris=sorted_tris,
        starts=starts[:-1],
        counts=counts,
        global_tris=global_tris,
        global_count=g_count,
        overflow=overflow,
    )


# ---------------------------------------------------------------------------
# Stage 4: per-tile raster


def _tile_pixel_centers(width: int, height: int, cfg: RasterConfig):
    """Pixel-center coords for every tile: two (ntiles, P) arrays (P = tile px)."""
    nty, ntx = num_tiles(width, height, cfg)
    ty = jnp.repeat(jnp.arange(nty, dtype=jnp.float32), ntx)  # (ntiles,)
    tx = jnp.tile(jnp.arange(ntx, dtype=jnp.float32), nty)
    iy = jnp.repeat(jnp.arange(cfg.tile_h, dtype=jnp.float32), cfg.tile_w)  # (P,)
    ix = jnp.tile(jnp.arange(cfg.tile_w, dtype=jnp.float32), cfg.tile_h)
    px = tx[:, None] * cfg.tile_w + ix[None, :] + 0.5  # (ntiles, P)
    py = ty[:, None] * cfg.tile_h + iy[None, :] + 0.5
    return px, py


def tiled_to_image(tiled: jax.Array, width: int, height: int, cfg: RasterConfig):
    """(ntiles, tile_h*tile_w, ...) -> (H, W, ...)."""
    nty, ntx = num_tiles(width, height, cfg)
    x = tiled.reshape((nty, ntx, cfg.tile_h, cfg.tile_w) + tiled.shape[2:])
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape((height, width) + tiled.shape[2:])


def image_to_tiled(img: jax.Array, cfg: RasterConfig):
    """(H, W, ...) -> (ntiles, tile_h*tile_w, ...)."""
    h, w = img.shape[0], img.shape[1]
    nty, ntx = h // cfg.tile_h, w // cfg.tile_w
    x = img.reshape((nty, cfg.tile_h, ntx, cfg.tile_w) + img.shape[2:])
    x = jnp.swapaxes(x, 1, 2)
    return x.reshape((nty * ntx, cfg.tile_h * cfg.tile_w) + img.shape[2:])


def rasterize_tiles(
    setup: TriSetup,
    bins: TileBins,
    width: int,
    height: int,
    cfg: RasterConfig,
    depth_only: bool = False,
    y_offset: int | jax.Array = 0,
    depth_limit: jax.Array | None = None,
):
    """Stage 4, by the platform the program is lowered for: the Triton
    kernel (ops/raster_pallas) on CUDA, the XLA walk
    ``rasterize_tiles_reference`` on the CPU, and a lowering error on any
    other platform. Arguments and results as for the reference."""
    from arkoserenderer.ops.raster_pallas import rasterize_tiles_pallas

    def reference(setup, bins, y_offset, depth_limit):
        return rasterize_tiles_reference(
            setup, bins, width, height, cfg, depth_only=depth_only,
            y_offset=y_offset, depth_limit=depth_limit,
        )

    def kernel(setup, bins, y_offset, depth_limit):
        return rasterize_tiles_pallas(
            setup, bins, width, height, cfg, depth_only=depth_only,
            y_offset=y_offset, depth_limit=depth_limit,
        )

    return jax.lax.platform_dependent(
        setup, bins, jnp.asarray(y_offset, jnp.int32), depth_limit,
        cpu=reference, cuda=kernel,
    )


def rasterize_tiles_reference(
    setup: TriSetup,
    bins: TileBins,
    width: int,
    height: int,
    cfg: RasterConfig,
    depth_only: bool = False,
    y_offset: int | jax.Array = 0,
    depth_limit: jax.Array | None = None,
):
    """Stage 4 in plain XLA: z-buffered visibility raster.

    For every tile, walk its binned triangle list (dynamic trip count — XLA
    lowers the vmapped fori_loop to a predicated while over the max count) and
    keep the closest coverage per pixel.

    ``depth_limit`` (optional, (H, W) reverse-Z) rejects fragments at or in
    front of it — the depth-peeling hook (each OIT layer passes the previous
    layer's depth to get the next surface behind it).

    Returns (vis (H,W) i32 setup-row ids, depth (H,W) f32); vis is all
    VIS_NONE when ``depth_only`` (the shadow-map path).
    """
    px, py = _tile_pixel_centers(width, height, cfg)  # (ntiles, P)
    py = py + y_offset  # screen-space position of this band's rows
    p = cfg.tile_h * cfg.tile_w
    if depth_limit is not None:
        limit_t = image_to_tiled(depth_limit, cfg)  # (ntiles, P)
    else:
        limit_t = jnp.full((px.shape[0], p), 2.0, jnp.float32)  # no limit

    def tile_body(start, count, px_t, py_t, lim_t):
        depth0 = jnp.full((p,), DEPTH_FAR, dtype=jnp.float32)
        vis0 = jnp.full((p,), VIS_NONE, dtype=jnp.int32)

        def shade_tri(t, state):
            depth, vis = state
            sxy = setup.screen_xy[t]  # (3, 2)
            e0 = edge_fn(sxy[1], sxy[2], px_t, py_t)
            e1 = edge_fn(sxy[2], sxy[0], px_t, py_t)
            e2 = edge_fn(sxy[0], sxy[1], px_t, py_t)
            area2 = edge_fn(sxy[0], sxy[1], sxy[2, 0], sxy[2, 1])
            inv_area = jnp.where(
                jnp.abs(area2) > 1e-12, 1.0 / jnp.where(area2 == 0, 1.0, area2), 0.0
            )
            l0, l1, l2 = e0 * inv_area, e1 * inv_area, e2 * inv_area
            # Reverse-Z ndc depth is affine in screen space -> plain lerp.
            z = setup.z_ndc[t]
            d = l0 * z[0] + l1 * z[1] + l2 * z[2]
            # Inside test in normalized barycentric terms handles both
            # windings (back faces survive setup when culling is off).
            covered = (l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (d > depth) & (d < lim_t)
            depth = jnp.where(covered, d, depth)
            vis = jnp.where(covered, t, vis)
            return depth, vis

        def step_local(i, state):
            return shade_tri(bins.sorted_tris[start + i], state)

        def step_global(j, state):
            return shade_tri(bins.global_tris[j], state)

        state = jax.lax.fori_loop(0, count, step_local, (depth0, vis0))
        return jax.lax.fori_loop(0, bins.global_count, step_global, state)

    # Occupancy-sorted tile chunking: a plain vmap(fori) lowers to running
    # EVERY tile to the GLOBAL max triangle count — dense tiles (a stress
    # scene's center) make empty edge tiles pay the same. Sorting tiles by
    # count and processing them in lax.map chunks bounds each chunk's loop
    # at ITS own max: total work ~ sum(counts) instead of ntiles*max(count).
    ntiles = px.shape[0]
    chunk = TILE_CHUNK
    if ntiles > 2 * chunk:
        pad = (-ntiles) % chunk
        order = jnp.argsort(bins.counts)
        inv = jnp.argsort(order)

        def padded(a, fill=0):
            return jnp.concatenate(
                [a[order], jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
            ) if pad else a[order]

        k = (ntiles + pad) // chunk
        st_c = padded(bins.starts).reshape(k, chunk)
        ct_c = padded(bins.counts).reshape(k, chunk)
        px_c = padded(px).reshape(k, chunk, -1)
        py_c = padded(py).reshape(k, chunk, -1)
        lt_c = padded(limit_t, fill=2.0).reshape(k, chunk, -1)

        def chunk_fn(args):
            return jax.vmap(tile_body)(*args)

        depth_c, vis_c = jax.lax.map(chunk_fn, (st_c, ct_c, px_c, py_c, lt_c))
        depth_t = depth_c.reshape(-1, p)[:ntiles][inv]
        vis_t = vis_c.reshape(-1, p)[:ntiles][inv]
    else:
        depth_t, vis_t = jax.vmap(tile_body)(
            bins.starts, bins.counts, px, py, limit_t
        )
    depth = tiled_to_image(depth_t, width, height, cfg)
    if depth_only:
        vis = jnp.full((height, width), VIS_NONE, dtype=jnp.int32)
    else:
        vis = tiled_to_image(vis_t, width, height, cfg)
    return vis, depth


@functools.partial(
    jax.jit, static_argnames=("width", "height", "cfg", "cull_backfaces", "depth_only")
)
def rasterize(
    clip: jax.Array,
    indices: jax.Array,
    tri_valid: jax.Array,
    *,
    width: int,
    height: int,
    cfg: RasterConfig = RasterConfig(),
    cull_backfaces: bool = True,
    depth_only: bool = False,
    w_eps: float | jax.Array = 1e-4,
):
    """Full pipeline: setup -> bin -> raster. Returns (vis, depth, setup, bins)."""
    setup = setup_triangles(
        clip, indices, tri_valid, width, height,
        cull_backfaces=cull_backfaces, w_eps=w_eps,
    )
    bins = bin_triangles(setup, width, height, cfg)
    vis, depth = rasterize_tiles(setup, bins, width, height, cfg, depth_only=depth_only)
    return vis, depth, setup, bins
