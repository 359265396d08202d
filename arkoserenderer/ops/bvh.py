"""BVH build + batched ray traversal.

Array-program replacement for the reference's acceleration-structure stack
(arkose/rendering/backend/base/AccelerationStructure.h — BLAS/TLAS built by
the driver in VulkanAccelerationStructureKHR.cpp): the RT hardware is not
reachable from JAX, so we build the BVH ourselves and traverse it as a
data-parallel program over ray batches.

Round-1 scope: ONE flat world-space BVH over all static triangles (built
host-side in NumPy, median-split over centroid axes, leaves <= 4 tris).
The two-level TLAS/BLAS split with per-frame refit (GpuScene.cpp:872-1011's
rebuild policy) layers on top later; the traversal kernel is shared.

Traversal: SIMD-over-rays — every ray carries its own small traversal stack
(fixed depth) in registers/VMEM; one while-loop step pops a node per ray,
tests both children's AABBs (internal) or up to 4 Moller-Trumbore triangle
tests (leaf). Divergence costs lanes, not correctness; ray sorting /
compaction between bounces is the later optimization (SURVEY.md §7 hard
part #2).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx

LEAF_SIZE = 4
STACK_DEPTH = 48


class FlatBVH(NamedTuple):
    """Array-of-structs flattened BVH (a pytree of device arrays)."""

    node_min: jax.Array    # (M, 3) f32
    node_max: jax.Array    # (M, 3) f32
    left: jax.Array        # (M,) i32 — child index (internal) or first tri slot (leaf)
    right: jax.Array       # (M,) i32 — child index (internal), unused for leaf
    count: jax.Array       # (M,) i32 — 0 internal, >0 = leaf triangle count
    node_start: jax.Array  # (M,) i32 — first slot of the node's contiguous
    node_end: jax.Array    # (M,) i32   range in tri_order (median-split keeps
                           #            every node's triangles contiguous)
    tri_order: jax.Array   # (T,) i32 — triangle ids grouped by leaf
    tri_v0: jax.Array      # (T, 3) f32 — pretransformed world-space vertices,
    tri_e1: jax.Array      # (T, 3)      in tri_order layout for coalesced
    tri_e2: jax.Array      # (T, 3)      leaf fetches (v0, edge1, edge2)


class Hit(NamedTuple):
    t: jax.Array         # (R,) hit distance (t_max if miss)
    tri: jax.Array       # (R,) i32 ORIGINAL triangle id (-1 = miss)
    u: jax.Array         # (R,) barycentric u (of v1)
    v: jax.Array         # (R,) barycentric v (of v2)
    hit: jax.Array       # (R,) bool


def _median_build(lo: np.ndarray, hi: np.ndarray, leaf_size: int,
                  method: str = "sah", sah_bins: int = 16):
    """Host-side top-down tree build over primitive AABBs (lo/hi: (n, 3)).

    ``method="sah"`` (default): binned surface-area-heuristic splits (the
    quality the reference gets from the Vulkan driver's BLAS builders) —
    traversal visits FAR fewer nodes than centroid-median splits on scenes
    mixing huge and small triangles (the median tree's children overlap
    heavily there, and every visited node is a serialized gather step on
    this machine). Falls back to the median split when SAH can't separate.

    Returns numpy arrays (node_min, node_max, left, right, count,
    node_start, node_end) truncated to the node count, plus ``order`` — the
    primitive permutation such that every node's primitives are the
    contiguous range [node_start, node_end) of ``order``. For leaves,
    ``left`` is the first slot (== node_start) and ``count`` the length.
    """
    centroid = 0.5 * (lo + hi)
    n = lo.shape[0]
    max_nodes = 2 * n
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros((max_nodes,), np.int32)
    right = np.zeros((max_nodes,), np.int32)
    count = np.zeros((max_nodes,), np.int32)
    node_start = np.zeros((max_nodes,), np.int32)
    node_end = np.zeros((max_nodes,), np.int32)

    def half_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    order = np.arange(n)
    n_nodes = 1
    # (node index, slice into `order`)
    stack: list[tuple[int, int, int]] = [(0, 0, n)]
    while stack:
        node, s, e = stack.pop()
        node_start[node] = s
        node_end[node] = e
        sel = order[s:e]
        node_min[node] = lo[sel].min(axis=0)
        node_max[node] = hi[sel].max(axis=0)
        if e - s <= leaf_size:
            left[node] = s
            count[node] = e - s
            continue

        c = centroid[sel]
        mid = None
        if method == "sah" and e - s > 2 * leaf_size:
            c_lo = c.min(axis=0)
            c_ext = c.max(axis=0) - c_lo
            axis = int(np.argmax(c_ext))
            if c_ext[axis] > 1e-12:
                # Binned SAH along the widest centroid axis.
                t = (c[:, axis] - c_lo[axis]) / c_ext[axis]
                b = np.minimum((t * sah_bins).astype(np.int64), sah_bins - 1)
                cnt = np.bincount(b, minlength=sah_bins)
                bin_lo = np.full((sah_bins, 3), np.inf, np.float32)
                bin_hi = np.full((sah_bins, 3), -np.inf, np.float32)
                np.minimum.at(bin_lo, b, lo[sel])
                np.maximum.at(bin_hi, b, hi[sel])
                # Prefix/suffix bound sweeps.
                lft_lo = np.minimum.accumulate(bin_lo, axis=0)
                lft_hi = np.maximum.accumulate(bin_hi, axis=0)
                rgt_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
                rgt_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
                n_l = np.cumsum(cnt)[:-1]
                n_r = (e - s) - n_l
                cost = (
                    half_area(lft_lo[:-1], lft_hi[:-1]) * n_l
                    + half_area(rgt_lo[1:], rgt_hi[1:]) * n_r
                )
                valid_split = (n_l > 0) & (n_r > 0)
                if valid_split.any():
                    cost = np.where(valid_split, cost, np.inf)
                    k = int(np.argmin(cost))
                    go_left = b <= k
                    part = np.argsort(~go_left, kind="stable")
                    order[s:e] = sel[part]
                    mid = int(go_left.sum())
        if mid is None:
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            mid = (e - s) // 2
            part = np.argpartition(c[:, axis], mid)
            order[s:e] = sel[part]

        l_idx, r_idx = n_nodes, n_nodes + 1
        n_nodes += 2
        left[node] = l_idx
        right[node] = r_idx
        count[node] = 0
        stack.append((l_idx, s, s + mid))
        stack.append((r_idx, s + mid, e))

    return (
        node_min[:n_nodes], node_max[:n_nodes], left[:n_nodes],
        right[:n_nodes], count[:n_nodes], node_start[:n_nodes],
        node_end[:n_nodes], order,
    )


def build_bvh(world_verts: np.ndarray, tris: np.ndarray, tri_valid: np.ndarray) -> FlatBVH:
    """Host-side median-split BVH over world-space triangles.

    ``world_verts``: (V, 3); ``tris``: (T, 3) indices; ``tri_valid``: (T,).
    Invalid (pool-padding) triangles are excluded.
    """
    ids = np.nonzero(tri_valid)[0].astype(np.int32)
    if len(ids) == 0:
        ids = np.zeros((1,), np.int32)  # degenerate: one dummy leaf
    v = world_verts[tris[ids]]                     # (n, 3, 3)
    lo = v.min(axis=1)
    hi = v.max(axis=1)

    (node_min, node_max, left, right, count, node_start, node_end,
     order) = _median_build(lo, hi, LEAF_SIZE)
    n_nodes = node_min.shape[0]

    tri_order = ids[order]
    tv = world_verts[tris[tri_order]]
    return FlatBVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        left=jnp.asarray(left),
        right=jnp.asarray(right),
        count=jnp.asarray(count),
        node_start=jnp.asarray(node_start),
        node_end=jnp.asarray(node_end),
        tri_order=jnp.asarray(tri_order),
        tri_v0=jnp.asarray(tv[:, 0].astype(np.float32)),
        tri_e1=jnp.asarray((tv[:, 1] - tv[:, 0]).astype(np.float32)),
        tri_e2=jnp.asarray((tv[:, 2] - tv[:, 0]).astype(np.float32)),
    )


@dataclasses.dataclass(frozen=True)
class TwoLevelBVH:
    """Two-level acceleration structure: a TLAS over instances whose leaves
    redirect into per-segment BLASes (object space), packed into ONE unified
    node pool so traversal issues a single bounds gather per step.

    Array-program replacement for the reference's BLAS/TLAS stack
    (arkose/rendering/backend/base/AccelerationStructure.h:14-102; per-frame
    refit-vs-rebuild policy GpuScene.cpp:872-1011): instanced geometry is
    stored ONCE per segment — instances carry affine object<->world
    transforms, so a 4096-instance scene costs one BLAS + 4096 TLAS leaves,
    not 4096 geometry copies.

    Node pool layout: rows [0, n_tlas) are TLAS nodes (world space); rows
    [n_tlas, M) are BLAS nodes (object space of their segment).
    ``count`` encodes the node kind: 0 = internal (children in left/right),
    > 0 = triangle leaf (``left`` = first slot, ``count`` triangles),
    -1 = instance leaf (``left`` = instance slot; traversal redirects to
    ``blas_root[left]`` with the instance's world->object transform).

    Deformable geometry (skinned / morphed) gets a per-instance BLAS with an
    identity transform ("object" space == world space); ``slot_inst`` marks
    its triangle slots so ``refit`` can re-read deformed vertices (the
    BLAS-update analogue of VulkanAccelerationStructureKHR's update mode).
    """

    node_min: jax.Array     # (M, 3) f32
    node_max: jax.Array     # (M, 3) f32
    left: jax.Array         # (M,) i32
    right: jax.Array        # (M,) i32
    count: jax.Array        # (M,) i32 (see class docstring)
    node_start: jax.Array   # (M,) i32 — BLAS rows: range into tri slots;
    node_end: jax.Array     # (M,) i32   TLAS rows: range into inst_order
    tri_order: jax.Array    # (T,) i32 — slot -> SEGMENT-LOCAL triangle id
    tri_v0: jax.Array       # (T, 3) f32 object-space v0
    tri_e1: jax.Array       # (T, 3) f32 v1 - v0
    tri_e2: jax.Array       # (T, 3) f32 v2 - v0
    slot_inst: jax.Array    # (T,) i32 owning instance for per-instance
                            #   (deformable) BLAS slots; -1 = shared/static
    inst_order: jax.Array   # (I,) i32 TLAS leaf permutation of instances
    inst_w2o: jax.Array     # (I + 1, 3, 4) f32; row 0 = identity (TLAS)
    inst_o2w: jax.Array     # (I, 3, 4) f32
    blas_root: jax.Array    # (I,) i32 unified-pool node index of the root
    inst_tri_base: jax.Array  # (I,) i32 — global tri id = base + local id
    inst_id: jax.Array      # (I,) i32 SCENE instance id (the bvh may hold a
                            #   filtered subset, e.g. LOD0 drawables only)
    # -- packed traversal records (derived; rebuilt by refit) -----------------
    # Children bounds live in the PARENT record and leaf triangles are
    # 4-aligned quad rows, so a traversal step costs ~4 gathers (transform,
    # int rec, child bounds, tri quad) instead of ~9-12 narrow ones.
    node_cbounds: jax.Array = None  # (M, 12) f32 [Llo3, Lhi3, Rlo3, Rhi3]
    node_int: jax.Array = None      # (M, 4) i32 [left, right, count, redirect]
    tri_quad: jax.Array = None      # (S/4, 36) f32 4 x [v0, e1, e2] per row
    # -- WIDE (8-ary) traversal records (see _collapse_wide) ------------------
    # The binary tree collapsed to branching factor 8: a traversal step costs
    # the SAME ~4 gathers but covers 8 children, so the serialized while-loop
    # runs ~3x fewer steps — the traversal's cost is (worst-ray steps) x
    # (gather latency per step).
    wide_meta: jax.Array = None     # (W, 8) i32 child descriptors (_wide_desc)
    wide_src: jax.Array = None      # (W, 8) i32 binary node id per slot (-1
                                    #   empty) — bounds re-derived on refit
    wide_cbounds: jax.Array = None  # (W, 48) f32 8 x [lo3, hi3]
    wide_root_blas: jax.Array = None  # (I,) i32 wide root node per instance
    # -- single-row-per-gather packed records (see _derive_wide_recs): the
    # traversal step is serialized gather LATENCY, so each fetch category is
    # one bitcast-packed i32 row --------------------------------------------
    wide_rec: jax.Array = None      # (W, 56) i32 [bounds f32x48 | meta x8]
    quad_rec: jax.Array = None      # (Q, 40) i32 [tri_quad f32x36 | ids x4]
    inst_rec: jax.Array = None      # (I+1, 14) i32 [w2o f32x12 | tri_base |
                                    #   wide BLAS root]; row 0 = identity
    # Streaming capacity (build_two_level inst_cap): instance slots past the
    # build-time population are PARKED (tiny AABB at -1e9, inactive) until a
    # streamed instance claims one — topology never changes, so appending an
    # instance is a handful of row uploads + an in-jit refit, no retrace.
    # The TLAS-update half of VertexManager.h:187-226's CreatingBLAS stage.
    inst_active: jax.Array = None   # (I,) bool; None = all active
    n_tlas: int = dataclasses.field(metadata={"static": True}, default=1)


jax.tree_util.register_dataclass(
    TwoLevelBVH,
    data_fields=[
        "node_min", "node_max", "left", "right", "count", "node_start",
        "node_end", "tri_order", "tri_v0", "tri_e1", "tri_e2", "slot_inst",
        "inst_order", "inst_w2o", "inst_o2w", "blas_root", "inst_tri_base",
        "inst_id", "node_cbounds", "node_int", "tri_quad",
        "wide_meta", "wide_src", "wide_cbounds", "wide_root_blas",
        "wide_rec", "quad_rec", "inst_rec", "inst_active",
    ],
    meta_fields=["n_tlas"],
)


def _derive_packed(node_min, node_max, left, right, count, blas_root,
                   tri_v0, tri_e1, tri_e2):
    """Derived traversal records (see TwoLevelBVH packed fields)."""
    m = node_min.shape[0]
    cap = m - 1
    li = jnp.clip(left, 0, cap)
    ri = jnp.clip(right, 0, cap)
    cbounds = jnp.concatenate(
        [node_min[li], node_max[li], node_min[ri], node_max[ri]], axis=-1
    )
    redirect = jnp.where(
        count == -1,
        blas_root[jnp.clip(left, 0, blas_root.shape[0] - 1)],
        0,
    )
    node_int = jnp.stack(
        [left, right, count, redirect], axis=-1
    ).astype(jnp.int32)
    tri_quad = jnp.concatenate([tri_v0, tri_e1, tri_e2], axis=-1).reshape(-1, 36)
    return cbounds, node_int, tri_quad


# ---------------------------------------------------------------------------
# Wide (8-ary) collapse
#
# Child descriptor encoding (i32):
#   desc >= 0                    -> internal wide node id
#   desc < 0, e = -desc - 1:
#     kind = e >> 28             -> 0 = quad triangle leaf, 1 = instance leaf
#     kind 0: payload = e & 0x0FFFFFFF = (quad_row << 3) | tri_count (1..4)
#     kind 1: payload = instance slot (TLAS leaf; traversal pushes the
#             instance's wide BLAS root and switches to object space)

WIDE_WIDTH = 8
WIDE_STACK_DEPTH = 64


def _wide_desc_leaf(left: int, cnt: int) -> int:
    return -(1 + (((left >> 2) << 3) | cnt))


def _wide_desc_inst(inst: int) -> int:
    return -(1 + ((1 << 28) | inst))


def _collapse_wide(node_min, node_max, left, right, count, roots):
    """Collapse binary trees (shared arrays, one root per tree) to 8-wide.

    Greedy expansion: starting from [root], repeatedly replace the internal
    child with the largest surface area by its two children until WIDE_WIDTH
    slots are used — the standard BVH8 collapse heuristic. Leaf children
    become inline descriptors; internal children become new wide nodes.

    Returns (wide_meta (W, 8) i32, wide_src (W, 8) i32, wide_root_of (dict
    binary root -> wide id)).
    """
    ext = np.maximum(node_max - node_min, 0.0)
    area = (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
            + ext[:, 2] * ext[:, 0])
    metas: list[list[int]] = []
    srcs: list[list[int]] = []
    wide_root_of: dict[int, int] = {}
    # (wide id, binary subtree root); wide ids assigned on enqueue so
    # children can reference parents' forward slots deterministically.
    queue: list[tuple[int, int]] = []

    def enqueue(b: int) -> int:
        # Wide ids are queue positions: metas are appended in queue order.
        wid = len(queue)
        queue.append((wid, b))
        return wid

    for root in roots:
        wide_root_of[int(root)] = enqueue(int(root))

    qi = 0
    while qi < len(queue):
        _wid, b = queue[qi]
        qi += 1
        ch = [b] if count[b] != 0 else [int(left[b]), int(right[b])]
        while len(ch) < WIDE_WIDTH:
            best, best_a = -1, -1.0
            for k, c in enumerate(ch):
                if count[c] == 0 and area[c] > best_a:
                    best, best_a = k, float(area[c])
            if best < 0:
                break
            c = ch.pop(best)
            ch.extend((int(left[c]), int(right[c])))
        meta_row = []
        src_row = []
        for c in ch:
            if count[c] == 0:
                meta_row.append(enqueue(c))
            elif count[c] > 0:
                meta_row.append(_wide_desc_leaf(int(left[c]), int(count[c])))
            else:  # instance leaf
                meta_row.append(_wide_desc_inst(int(left[c])))
            src_row.append(c)
        while len(meta_row) < WIDE_WIDTH:
            meta_row.append(0)
            src_row.append(-1)
        metas.append(meta_row)
        srcs.append(src_row)

    return (np.asarray(metas, np.int32).reshape(-1, WIDE_WIDTH),
            np.asarray(srcs, np.int32).reshape(-1, WIDE_WIDTH),
            wide_root_of)


def _derive_wide_bounds(node_min, node_max, wide_src):
    """(W, 48) packed per-child [lo3, hi3] from the binary node bounds —
    jit-traceable so refit just re-gathers (empty slots get inverted bounds
    that no slab test can hit)."""
    src = jnp.maximum(wide_src, 0)
    lo = node_min[src]                       # (W, 8, 3)
    hi = node_max[src]
    empty = (wide_src < 0)[..., None]
    lo = jnp.where(empty, 3e30, lo)
    hi = jnp.where(empty, -3e30, hi)
    return jnp.concatenate([lo, hi], axis=-1).reshape(-1, 6 * WIDE_WIDTH)


def _derive_wide_recs(wide_cbounds, wide_meta, tri_quad, tri_order,
                      inst_w2o, inst_tri_base, wide_root_blas):
    """Pack each traversal-step fetch category into ONE i32 row (f32 lanes
    bitcast): node record (bounds+meta), quad record (verts+global-order
    ids), instance record (w2o + tri base + wide BLAS root). Jit-traceable
    so refit just re-derives. The step loop is serialized gather latency;
    one 56-lane row costs the same as an 8-lane one."""
    bc = jax.lax.bitcast_convert_type
    wide_rec = jnp.concatenate([bc(wide_cbounds, jnp.int32), wide_meta], -1)
    q = tri_quad.shape[0]
    ids = tri_order[: q * 4].reshape(q, 4).astype(jnp.int32)
    quad_rec = jnp.concatenate([bc(tri_quad, jnp.int32), ids], -1)
    n_i = inst_w2o.shape[0]                       # I+1 (row 0 = identity)
    w2o_flat = bc(inst_w2o.reshape(n_i, 12), jnp.int32)
    base = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), inst_tri_base.astype(jnp.int32)]
    )
    root = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), wide_root_blas.astype(jnp.int32)]
    )
    inst_rec = jnp.concatenate([w2o_flat, base[:, None], root[:, None]], -1)
    return wide_rec, quad_rec, inst_rec


def _affine_inverse_np(m: np.ndarray) -> np.ndarray:
    """(4, 4) -> (3, 4) inverse of an affine transform."""
    inv = np.linalg.inv(m.astype(np.float64))
    return inv[:3, :4].astype(np.float32)


def _align_leaves_quad(nodes, order):
    """Re-lay a built tree's triangle slots so every leaf occupies exactly
    4 slots (leaf k -> [4k, 4k+4)), padding short leaves by DUPLICATING
    their first primitive (harmless extra hit of the same triangle; keeps
    range-min/max refit exact). Enables one quad-row gather per leaf step.

    ``nodes`` = (node_min, node_max, left, right, count, node_start,
    node_end) from _median_build; ``order``: (n,) primitive permutation.
    Returns (updated node tuple, new_order (4L,), pad source map).
    """
    node_min, node_max, left, right, count, node_start, node_end = nodes
    is_leaf = count > 0
    leaf_ids = np.nonzero(is_leaf)[0]
    # Rank leaves by their slot range start (ranges are disjoint, ordered).
    rank = np.argsort(node_start[leaf_ids], kind="stable")
    leaf_ids = leaf_ids[rank]
    n_leaves = len(leaf_ids)
    starts = node_start[leaf_ids]
    counts = count[leaf_ids]

    new_order = np.zeros((4 * n_leaves,), order.dtype)
    for k in range(n_leaves):
        s0 = starts[k]
        c = counts[k]
        seg = order[s0 : s0 + c]
        new_order[4 * k : 4 * k + c] = seg
        new_order[4 * k + c : 4 * k + 4] = seg[0]     # dup pad

    # Leaf nodes: left = 4k, ranges cover their padded quad.
    left = left.copy(); node_start = node_start.copy(); node_end = node_end.copy()
    left[leaf_ids] = 4 * np.arange(n_leaves)
    node_start[leaf_ids] = 4 * np.arange(n_leaves)
    node_end[leaf_ids] = 4 * np.arange(n_leaves) + 4
    # Internal nodes: old slot ranges -> leaf-rank ranges -> new slots.
    internal = np.nonzero(~is_leaf)[0]
    if len(internal):
        first_rank = np.searchsorted(starts, node_start[internal], side="right") - 1
        # node_start of an internal node coincides with its first leaf start
        first_rank = np.maximum(first_rank, 0)
        last_rank = np.searchsorted(starts, node_end[internal] - 1, side="right") - 1
        node_start[internal] = 4 * first_rank
        node_end[internal] = 4 * (last_rank + 1)
    return (node_min, node_max, left, right, count, node_start, node_end), new_order


def build_two_level(
    blas_geo: list[tuple[np.ndarray, np.ndarray]],
    inst_blas: np.ndarray,      # (I,) i32 BLAS id per instance
    inst_o2w: np.ndarray,       # (I, 4, 4) f32 object->world
    inst_tri_base: np.ndarray,  # (I,) i32 global tri-id base per instance
    blas_owner: np.ndarray | None = None,  # (B,) i32 owning instance for
                                           # deformable BLASes (BVH slot),
                                           # else -1
    inst_id: np.ndarray | None = None,     # (I,) i32 scene instance ids
    inst_cap: int | None = None,           # reserve parked instance slots
                                           # for streaming (see inst_active)
    host_meta_out: dict | None = None,     # filled with numpy build metadata
                                           # (per-BLAS roots, slot counts) so
                                           # streaming code never reads back
                                           # device arrays
) -> TwoLevelBVH:
    """Host-side build: one BLAS per unique geometry + a TLAS over instances.

    ``blas_geo[b]`` = (verts (V, 3) object space, tris (t, 3) local indices).
    """
    n_inst = len(inst_blas)
    if n_inst == 0 or len(blas_geo) == 0:
        blas_geo = [(np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32))]
        inst_blas = np.zeros((1,), np.int32)
        inst_o2w = np.eye(4, dtype=np.float32)[None]
        inst_tri_base = np.zeros((1,), np.int32)
        n_inst = 1
        blas_owner = None
        inst_id = None
    if blas_owner is None:
        blas_owner = np.full((len(blas_geo),), -1, np.int32)
    if inst_id is None or len(inst_id) != n_inst:
        inst_id = np.arange(n_inst, dtype=np.int32)

    # ---- streaming capacity: parked instance slots --------------------------
    n_real = n_inst
    if inst_cap is not None and inst_cap > n_inst:
        pad = inst_cap - n_inst
        inst_blas = np.concatenate([np.asarray(inst_blas, np.int32),
                                    np.zeros(pad, np.int32)])
        park = np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
        # Distinct parked centroids far below the scene: tiny AABBs no real
        # ray reaches, and the median build keeps them in one dead subtree.
        park[:, 0, 3] = -1e9 + np.arange(pad, dtype=np.float32)
        park[:, 1, 3] = -1e9
        park[:, 2, 3] = -1e9
        inst_o2w = np.concatenate([np.asarray(inst_o2w, np.float32), park])
        inst_tri_base = np.concatenate([np.asarray(inst_tri_base, np.int32),
                                        np.zeros(pad, np.int32)])
        inst_id = np.concatenate([np.asarray(inst_id, np.int32),
                                  np.zeros(pad, np.int32)])
        n_inst = inst_cap
    inst_active_np = np.arange(n_inst) < n_real

    # ---- per-BLAS median-split builds (object space) ------------------------
    # blas_geo entries: (verts, tris) or (verts, tris, tri_ids) where
    # tri_ids maps each row of ``tris`` back to the segment's ORIGINAL
    # triangle index (used when build-time filtering — e.g. the opacity-
    # micromap transparent-triangle cull — removed rows).
    blas_nodes = []      # list of per-BLAS node tuples
    blas_slots = []      # (local tri order, v0, e1, e2, owner)
    for b, geo in enumerate(blas_geo):
        verts, tris = geo[0], geo[1]
        tri_ids = geo[2] if len(geo) > 2 else None
        v = verts[tris]                              # (t, 3, 3)
        lo = v.min(axis=1)
        hi = v.max(axis=1)
        nodes = _median_build(lo, hi, LEAF_SIZE)
        packed, order = _align_leaves_quad(nodes[:-1], nodes[-1].astype(np.int32))
        tv = v[order]
        local_ids = order if tri_ids is None else np.asarray(tri_ids, np.int32)[order]
        blas_nodes.append(packed)
        blas_slots.append((local_ids, tv[:, 0], tv[:, 1] - tv[:, 0],
                           tv[:, 2] - tv[:, 0],
                           np.full((len(order),), blas_owner[b], np.int32)))

    # ---- TLAS over instance world AABBs (leaf size 1) -----------------------
    root_lo = np.stack([n[0][0] for n in blas_nodes])   # (B, 3) object aabb
    root_hi = np.stack([n[1][0] for n in blas_nodes])
    c_obj = 0.5 * (root_lo + root_hi)[inst_blas]
    e_obj = 0.5 * (root_hi - root_lo)[inst_blas]
    rot = inst_o2w[:, :3, :3]
    wc = np.einsum("iab,ib->ia", rot, c_obj) + inst_o2w[:, :3, 3]
    we = np.einsum("iab,ib->ia", np.abs(rot), e_obj)
    (t_min, t_max_, t_left, t_right, t_count, t_start, t_end,
     t_order) = _median_build(wc - we, wc + we, 1)
    n_tlas = t_min.shape[0]

    # TLAS leaves become instance leaves: count -1, left = instance slot.
    leaf = t_count > 0
    t_left = np.where(leaf, t_order.astype(np.int32)[np.clip(t_start, 0, n_inst - 1)], t_left)
    t_count = np.where(leaf, -1, t_count)

    # ---- pack BLAS node/slot pools after the TLAS ---------------------------
    node_off = n_tlas
    slot_off = 0
    roots_by_blas = np.zeros((len(blas_geo),), np.int32)
    packed_nodes = [(t_min, t_max_, t_left, t_right, t_count, t_start, t_end)]
    for b, (nm, nx, lf, rt, ct, ns, ne) in enumerate(blas_nodes):
        roots_by_blas[b] = node_off
        internal = ct == 0
        lf = np.where(internal, lf + node_off, lf + slot_off)
        rt = np.where(internal, rt + node_off, rt)
        packed_nodes.append((nm, nx, lf, rt, ct, ns + slot_off, ne + slot_off))
        node_off += nm.shape[0]
        slot_off += blas_slots[b][0].shape[0]

    cat = [np.concatenate([p[i] for p in packed_nodes]) for i in range(7)]
    node_min, node_max, left, right, count, node_start, node_end = cat

    w2o = np.stack(
        [np.eye(3, 4, dtype=np.float32)]
        + [_affine_inverse_np(inst_o2w[i]) for i in range(n_inst)]
    )
    nm = jnp.asarray(node_min.astype(np.float32))
    nx = jnp.asarray(node_max.astype(np.float32))
    lf = jnp.asarray(left.astype(np.int32))
    rt = jnp.asarray(right.astype(np.int32))
    ct = jnp.asarray(count.astype(np.int32))
    v0 = jnp.asarray(np.concatenate([s[1] for s in blas_slots]).astype(np.float32))
    e1 = jnp.asarray(np.concatenate([s[2] for s in blas_slots]).astype(np.float32))
    e2 = jnp.asarray(np.concatenate([s[3] for s in blas_slots]).astype(np.float32))
    br = jnp.asarray(roots_by_blas[inst_blas].astype(np.int32))
    cbounds, node_int, tri_quad = _derive_packed(nm, nx, lf, rt, ct, br, v0, e1, e2)
    # ---- 8-wide collapse (TLAS tree root 0 + every BLAS root) --------------
    w_meta, w_src, w_root_of = _collapse_wide(
        node_min, node_max, left, right, count,
        [0] + [int(r) for r in roots_by_blas],
    )
    w_meta_j = jnp.asarray(w_meta)
    w_src_j = jnp.asarray(w_src)
    w_cb = _derive_wide_bounds(nm, nx, w_src_j)
    w_root_blas = jnp.asarray(
        np.asarray([w_root_of[int(r)] for r in roots_by_blas], np.int32)[inst_blas]
    )
    tri_order_j = jnp.asarray(np.concatenate([s[0] for s in blas_slots]))
    w2o_j = jnp.asarray(w2o)
    itb_j = jnp.asarray(inst_tri_base.astype(np.int32))
    w_rec, q_rec, i_rec = _derive_wide_recs(
        w_cb, w_meta_j, tri_quad, tri_order_j, w2o_j, itb_j, w_root_blas
    )
    out = TwoLevelBVH(
        node_min=nm,
        node_max=nx,
        left=lf,
        right=rt,
        count=ct,
        node_start=jnp.asarray(node_start.astype(np.int32)),
        node_end=jnp.asarray(node_end.astype(np.int32)),
        tri_order=tri_order_j,
        tri_v0=v0,
        tri_e1=e1,
        tri_e2=e2,
        slot_inst=jnp.asarray(np.concatenate([s[4] for s in blas_slots])),
        inst_order=jnp.asarray(t_order.astype(np.int32)),
        inst_w2o=w2o_j,
        inst_o2w=jnp.asarray(inst_o2w[:, :3, :4].astype(np.float32)),
        blas_root=br,
        inst_tri_base=itb_j,
        inst_id=jnp.asarray(np.asarray(inst_id, np.int32)),
        node_cbounds=cbounds,
        node_int=node_int,
        tri_quad=tri_quad,
        wide_meta=w_meta_j,
        wide_src=w_src_j,
        wide_cbounds=w_cb,
        wide_root_blas=w_root_blas,
        wide_rec=w_rec,
        quad_rec=q_rec,
        inst_rec=i_rec,
        inst_active=jnp.asarray(inst_active_np),
        n_tlas=n_tlas,
    )
    if host_meta_out is not None:
        host_meta_out.update(
            n_real=n_real,
            n_inst=n_inst,
            roots_by_blas=roots_by_blas.copy(),
            wide_root_of_blas=np.asarray(
                [w_root_of[int(r)] for r in roots_by_blas], np.int32
            ),
        )
    return out


def _rmq_bounds(lo: jax.Array, hi: jax.Array, starts: jax.Array, ends: jax.Array):
    """Sparse-table range-min/max: per-query AABB union over [start, end).

    ``lo``/``hi``: (n, 3) leaf bounds in slot order; ``starts``/``ends``:
    (q,) i32 with 1 <= end - start <= n. O(n log n) fully parallel work —
    no bottom-up sequential tree walk.
    """
    n = lo.shape[0]
    levels = max(int(np.ceil(np.log2(max(n, 1)))) + 1, 1)
    pw_lo, pw_hi = [lo], [hi]
    for k in range(1, levels):
        half = 1 << (k - 1)
        pad_lo = jnp.full((half, 3), jnp.inf, lo.dtype)
        pad_hi = jnp.full((half, 3), -jnp.inf, hi.dtype)
        # pw[k][i] = reduce over [i, i + 2^k); tail pads never get gathered
        # (every queried range lies inside [0, n)).
        pw_lo.append(jnp.minimum(pw_lo[-1],
                                 jnp.concatenate([pw_lo[-1][half:], pad_lo])[:n]))
        pw_hi.append(jnp.maximum(pw_hi[-1],
                                 jnp.concatenate([pw_hi[-1][half:], pad_hi])[:n]))
    table_lo = jnp.stack(pw_lo)                   # (levels, n, 3)
    table_hi = jnp.stack(pw_hi)

    length = (ends - starts).astype(jnp.float32)  # >= 1
    k = jnp.floor(jnp.log2(jnp.maximum(length, 1.0)) + 1e-6).astype(jnp.int32)
    second = ends - (1 << k)                      # range [second, end) tail
    q_min = jnp.minimum(table_lo[k, starts], table_lo[k, second])
    q_max = jnp.maximum(table_hi[k, starts], table_hi[k, second])
    return q_min, q_max


def refit_bvh(bvh, world_verts: jax.Array, tris: jax.Array, world=None):
    """Jit-traceable AABB refit: same topology, new vertex positions.

    The TLAS/BLAS update-in-place analogue (the reference rebuilds or
    updates BLASes for skinned meshes each frame and refits the TLAS,
    GpuScene.cpp:872-1011 + VulkanAccelerationStructureKHR update mode).
    Median-split build keeps every node's triangles CONTIGUOUS in
    ``tri_order``, so each node's bounds are a range-min/max over the leaf
    bound arrays, answered for all nodes at once with a sparse-table RMQ.

    For a TwoLevelBVH, ``world`` (if given, (>=I, 4, 4) per SCENE-instance
    transforms gathered by the bvh's instance slots) also refreshes the
    instance o2w/w2o transforms and the TLAS is refit from the (possibly
    deformed) BLAS roots — moving instances costs no geometry work at all.
    """
    if isinstance(bvh, TwoLevelBVH):
        return _refit_two_level(bvh, world_verts, tris, world)
    v = world_verts[tris[bvh.tri_order]]          # (n, 3, 3) in leaf order
    lo = v.min(axis=1)                            # (n, 3)
    hi = v.max(axis=1)
    node_min, node_max = _rmq_bounds(lo, hi, bvh.node_start, bvh.node_end)
    return bvh._replace(
        node_min=node_min, node_max=node_max,
        tri_v0=v[:, 0], tri_e1=v[:, 1] - v[:, 0], tri_e2=v[:, 2] - v[:, 0],
    )


def _affine_inverse(m: jax.Array) -> jax.Array:
    """(..., 3, 4) affine -> (..., 3, 4) inverse, via the 3x3 adjugate."""
    r = m[..., :3, :3]
    t = m[..., :3, 3]
    c0 = jnp.cross(r[..., :, 1], r[..., :, 2], axis=-1)
    c1 = jnp.cross(r[..., :, 2], r[..., :, 0], axis=-1)
    c2 = jnp.cross(r[..., :, 0], r[..., :, 1], axis=-1)
    det = jnp.sum(r[..., :, 0] * c0, axis=-1, keepdims=True)[..., None]
    inv_det = jnp.where(jnp.abs(det) > 1e-20, 1.0 / det, 0.0)
    r_inv = jnp.stack([c0, c1, c2], axis=-2) * inv_det     # rows = adj^T
    t_inv = -jnp.einsum("...ab,...b->...a", r_inv, t, precision=mx.HIGHEST)
    return jnp.concatenate([r_inv, t_inv[..., None]], axis=-1)


def _refit_two_level(bvh: TwoLevelBVH, world_verts, tris, world):
    # 1. Deformable (per-instance BLAS) slots re-read skinned/morphed
    #    world-space vertices; shared static slots keep their object verts.
    own_i = jnp.maximum(bvh.slot_inst, 0)
    gid = bvh.inst_tri_base[own_i] + bvh.tri_order
    v = world_verts[tris[jnp.clip(gid, 0, tris.shape[0] - 1)]]   # (T, 3, 3)
    own = (bvh.slot_inst >= 0)[:, None]
    v0 = jnp.where(own, v[:, 0], bvh.tri_v0)
    e1 = jnp.where(own, v[:, 1] - v[:, 0], bvh.tri_e1)
    e2 = jnp.where(own, v[:, 2] - v[:, 0], bvh.tri_e2)
    v1 = v0 + e1
    v2 = v0 + e2
    lo = jnp.minimum(v0, jnp.minimum(v1, v2))
    hi = jnp.maximum(v0, jnp.maximum(v1, v2))

    # 2. BLAS node bounds: RMQ over tri slots (rows n_tlas:).
    nt = bvh.n_tlas
    b_min, b_max = _rmq_bounds(lo, hi, bvh.node_start[nt:], bvh.node_end[nt:])

    # 3. Instance transforms (moving instances).
    if world is not None:
        o2w = world[bvh.inst_id][..., :3, :4]
        w2o = jnp.concatenate(
            [jnp.eye(3, 4, dtype=jnp.float32)[None], _affine_inverse(o2w)]
        )
    else:
        o2w, w2o = bvh.inst_o2w, bvh.inst_w2o

    # 4. Instance world AABBs from refit BLAS roots + o2w.
    root = bvh.blas_root - nt
    r_lo = b_min[root]
    r_hi = b_max[root]
    c = 0.5 * (r_lo + r_hi)
    e = 0.5 * (r_hi - r_lo)
    rot = o2w[:, :3, :3]
    wc = jnp.einsum("iab,ib->ia", rot, c, precision=mx.HIGHEST) + o2w[:, :3, 3]
    we = jnp.einsum("iab,ib->ia", jnp.abs(rot), e, precision=mx.HIGHEST)
    if bvh.inst_active is not None:
        # Parked streaming slots stay parked through refit (their inst_id
        # aliases row 0, so without the mask a world-driven refit would
        # give them a live instance's bounds).
        act = bvh.inst_active[:, None]
        wc = jnp.where(act, wc, -1e9)
        we = jnp.where(act, we, 0.0)

    # 5. TLAS node bounds: RMQ over instances in TLAS leaf order.
    i_lo = (wc - we)[bvh.inst_order]
    i_hi = (wc + we)[bvh.inst_order]
    t_min, t_max_ = _rmq_bounds(i_lo, i_hi, bvh.node_start[:nt], bvh.node_end[:nt])

    node_min = jnp.concatenate([t_min, b_min])
    node_max = jnp.concatenate([t_max_, b_max])
    cbounds, node_int, tri_quad = _derive_packed(
        node_min, node_max, bvh.left, bvh.right, bvh.count, bvh.blas_root,
        v0, e1, e2,
    )
    wide_cb = wide_rec = quad_rec = inst_rec = None
    if bvh.wide_src is not None:
        wide_cb = _derive_wide_bounds(node_min, node_max, bvh.wide_src)
        wide_rec, quad_rec, inst_rec = _derive_wide_recs(
            wide_cb, bvh.wide_meta, tri_quad, bvh.tri_order, w2o,
            bvh.inst_tri_base, bvh.wide_root_blas,
        )
    return dataclasses.replace(
        bvh,
        node_min=node_min,
        node_max=node_max,
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        inst_o2w=o2w, inst_w2o=w2o,
        node_cbounds=cbounds, node_int=node_int, tri_quad=tri_quad,
        wide_cbounds=wide_cb,
        wide_rec=wide_rec, quad_rec=quad_rec, inst_rec=inst_rec,
    )


def _aabb_hit(node_lo, node_hi, origin, inv_dir, t_max):
    """Slab test; returns (hit, t_near). Shapes broadcast over rays."""
    t0 = (node_lo - origin) * inv_dir
    t1 = (node_hi - origin) * inv_dir
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    near = jnp.maximum(jnp.max(tmin, axis=-1), 0.0)
    far = jnp.minimum(jnp.min(tmax, axis=-1), t_max)
    return near <= far, near


def _tri_hit(v0, e1, e2, origin, direction, t_eps):
    """Moller-Trumbore; returns (valid, t, u, v)."""
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    # Small barycentric slack: rays through shared edges/vertices must hit at
    # least one of the adjacent triangles despite f32 rounding (watertight-ish).
    eps = 1e-6
    ok = (
        (jnp.abs(det) > 1e-12)
        & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
        & (t > t_eps)
    )
    return ok, t, u, v


def trace_rays(
    bvh: FlatBVH,
    origins: jax.Array,     # (R, 3)
    directions: jax.Array,  # (R, 3) need not be normalized
    t_max: float | jax.Array = 1e30,
    t_eps: float = 1e-4,
    any_hit: bool = False,
    max_steps: int = 512,
    chunk_size: int | None = None,
) -> Hit:
    """Batched closest-hit (or any-hit) traversal.

    All rays advance one BVH node per step in lockstep over the batch; each
    ray owns a fixed-depth stack. ``any_hit=True`` terminates a ray on its
    first accepted intersection (shadow/occlusion rays).

    ``chunk_size``: trace in sequential chunks via lax.map — the per-ray
    traversal stacks are R x STACK_DEPTH i32 (400 MB at 2M rays), and a
    frame tracing several full-screen ray batches can exhaust HBM; chunking
    bounds the live stack to one chunk at a time.
    """
    r_total = origins.shape[0]
    if chunk_size is not None and r_total > chunk_size:
        pad = (-r_total) % chunk_size
        o = jnp.concatenate([origins, jnp.ones((pad, 3), origins.dtype)])
        d = jnp.concatenate([directions, jnp.ones((pad, 3), directions.dtype)])
        k = o.shape[0] // chunk_size
        o = o.reshape(k, chunk_size, 3)
        d = d.reshape(k, chunk_size, 3)
        # A per-ray t_max array rides along with its chunk; a scalar closes
        # over unchanged (regression: flagship's 512x512 local-shadow rays
        # passed per-ray t_max into the 8192-chunk path).
        tm = jnp.asarray(t_max, jnp.float32)
        if tm.ndim > 0 and tm.shape != (r_total,):
            # Broadcastable arrays (e.g. shape (1,)) worked via closure
            # before chunking existed; normalize to per-ray so the
            # concatenate/reshape below is always valid.
            tm = jnp.broadcast_to(tm, (r_total,))
        if tm.ndim == 0:
            def one(args):
                return trace_rays(bvh, args[0], args[1], t_max=tm,
                                  t_eps=t_eps, any_hit=any_hit,
                                  max_steps=max_steps)

            hit = jax.lax.map(one, (o, d))
        else:
            t = jnp.concatenate([tm, jnp.zeros((pad,), jnp.float32)])
            t = t.reshape(k, chunk_size)

            def one(args):
                return trace_rays(bvh, args[0], args[1], t_max=args[2],
                                  t_eps=t_eps, any_hit=any_hit,
                                  max_steps=max_steps)

            hit = jax.lax.map(one, (o, d, t))
        return Hit(*(x.reshape(-1)[:r_total] for x in hit))
    if isinstance(bvh, TwoLevelBVH):
        if bvh.wide_meta is not None:
            return _trace_wide(bvh, origins, directions, t_max, t_eps,
                               any_hit, max_steps)
        return _trace_two_level(bvh, origins, directions, t_max, t_eps,
                                any_hit, max_steps)
    r = origins.shape[0]
    inv_dir = 1.0 / jnp.where(jnp.abs(directions) < 1e-12,
                              jnp.where(directions < 0, -1e-12, 1e-12), directions)

    stack = jnp.zeros((r, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((r,), jnp.int32)          # node 0 pre-pushed
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32)
    best_tri = jnp.full((r,), -1, jnp.int32)
    best_u = jnp.zeros((r,))
    best_v = jnp.zeros((r,))

    def cond(state):
        _, sp, _, _, _, _, step = state
        return jnp.any(sp > 0) & (step < max_steps)

    def body(state):
        stack, sp, best_t, best_tri, best_u, best_v, step = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(r), top]
        sp_pop = jnp.where(active, sp - 1, sp)

        n_lo = bvh.node_min[node]
        n_hi = bvh.node_max[node]
        hit_box, _ = _aabb_hit(n_lo, n_hi, origins, inv_dir, best_t)
        hit_box = hit_box & active

        is_leaf = bvh.count[node] > 0

        # -- leaf: test up to LEAF_SIZE triangles -----------------------------
        first = bvh.left[node]
        lcount = bvh.count[node]
        do_leaf = hit_box & is_leaf
        bt, btri, bu, bv = best_t, best_tri, best_u, best_v
        for k in range(LEAF_SIZE):
            slot = jnp.clip(first + k, 0, bvh.tri_v0.shape[0] - 1)
            ok, t, u, v = _tri_hit(
                bvh.tri_v0[slot], bvh.tri_e1[slot], bvh.tri_e2[slot],
                origins, directions, t_eps,
            )
            take = do_leaf & (k < lcount) & ok & (t < bt)
            bt = jnp.where(take, t, bt)
            btri = jnp.where(take, bvh.tri_order[slot], btri)
            bu = jnp.where(take, u, bu)
            bv = jnp.where(take, v, bv)

        # -- internal: push children, near child last (popped first) ----------
        do_int = hit_box & ~is_leaf
        l_child = bvh.left[node]
        r_child = bvh.right[node]
        hit_l, near_l = _aabb_hit(bvh.node_min[l_child], bvh.node_max[l_child], origins, inv_dir, bt)
        hit_r, near_r = _aabb_hit(bvh.node_min[r_child], bvh.node_max[r_child], origins, inv_dir, bt)
        hit_l = hit_l & do_int
        hit_r = hit_r & do_int
        l_first = near_l <= near_r

        far_child = jnp.where(l_first, r_child, l_child)
        near_child = jnp.where(l_first, l_child, r_child)
        far_ok = jnp.where(l_first, hit_r, hit_l)
        near_ok = jnp.where(l_first, hit_l, hit_r)

        rows = jnp.arange(r)
        new_sp = sp_pop
        stack = stack.at[rows, jnp.minimum(new_sp, STACK_DEPTH - 1)].set(
            jnp.where(far_ok, far_child, stack[rows, jnp.minimum(new_sp, STACK_DEPTH - 1)])
        )
        new_sp = jnp.where(far_ok, jnp.minimum(new_sp + 1, STACK_DEPTH - 1), new_sp)
        stack = stack.at[rows, jnp.minimum(new_sp, STACK_DEPTH - 1)].set(
            jnp.where(near_ok, near_child, stack[rows, jnp.minimum(new_sp, STACK_DEPTH - 1)])
        )
        new_sp = jnp.where(near_ok, jnp.minimum(new_sp + 1, STACK_DEPTH - 1), new_sp)

        if any_hit:
            # A ray that found any hit stops traversing.
            new_sp = jnp.where(btri >= 0, 0, new_sp)

        return stack, new_sp, bt, btri, bu, bv, step + 1

    stack, sp, best_t, best_tri, best_u, best_v, _ = jax.lax.while_loop(
        cond, body,
        (stack, sp, best_t, best_tri, best_u, best_v, jnp.zeros((), jnp.int32)),
    )
    return Hit(
        t=best_t, tri=best_tri, u=best_u, v=best_v, hit=best_tri >= 0
    )


def _trace_wide(
    bvh: TwoLevelBVH,
    origins: jax.Array,
    directions: jax.Array,
    t_max,
    t_eps: float,
    any_hit: bool,
    max_steps: int,
) -> Hit:
    """8-wide two-level SIMD-over-rays traversal.

    The while loop is serialized gather latency × worst-ray step count:
    the wide tree cuts the step count ~3x vs binary,
    and the packed records cut the per-step fetch count to THREE row
    gathers — instance record (w2o + tri base + wide BLAS root), node
    record (8 child bounds + descriptors), quad record (4 triangles +
    global ids) — everything else is fused elementwise arithmetic.
    Stack entries are child DESCRIPTORS (see _collapse_wide): internal
    wide-node ids push their hit children (near-on-top via a 19-comparator
    sorting network on slab distances + one masked scatter — elementwise);
    quad-leaf descriptors test their 4-aligned triangle row inline;
    instance-leaf descriptors switch to the instance's object space and
    process the instance's wide BLAS root IN THE SAME STEP (the root id
    rides the instance record, so entering an instance costs no extra
    step and no extra gather).
    Replaces the driver-built BVH8-style traversal of the reference's RT
    backend (arkose/rendering/backend/base/AccelerationStructure.h).
    """
    r = origins.shape[0]
    rows = jnp.arange(r)
    q_cap = bvh.quad_rec.shape[0] - 1
    big = jnp.float32(1e30)
    bc = jax.lax.bitcast_convert_type

    stack = jnp.zeros((r, WIDE_STACK_DEPTH), jnp.int32)
    sp = jnp.ones((r,), jnp.int32)              # wide TLAS root (id 0) pushed
    cur_inst = jnp.full((r,), -1, jnp.int32)
    base_sp = jnp.zeros((r,), jnp.int32)
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32)
    best_tri = jnp.full((r,), -1, jnp.int32)
    best_u = jnp.zeros((r,))
    best_v = jnp.zeros((r,))

    def cond(state):
        sp = state[1]
        step = state[-1]
        return jnp.any(sp > 0) & (step < max_steps)

    def body(state):
        stack, sp, cur_inst, base_sp, best_t, best_tri, best_u, best_v, step = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        desc = stack[rows, top]
        left_blas = active & (top < base_sp)
        cur_inst = jnp.where(left_blas, -1, cur_inst)
        base_sp = jnp.where(left_blas, 0, base_sp)
        sp_pop = jnp.where(active, sp - 1, sp)

        e = -desc - 1
        kind = e >> 28
        payload = e & 0x0FFFFFFF
        is_quad = active & (desc < 0) & (kind == 0)
        is_inst = active & (desc < 0) & (kind == 1)
        is_node = active & ((desc >= 0) | is_inst)
        # Entering an instance: switch space now; its BLAS root is processed
        # THIS step (root id comes from the instance record below).
        inst = jnp.where(is_inst, payload, cur_inst)
        cur_inst = inst
        base_sp = jnp.where(is_inst, sp_pop, base_sp)

        # -- fetch 1: instance record (identity row for TLAS space) -----------
        irow = bvh.inst_rec[inst + 1]                    # (r, 14) i32
        mm = bc(irow[:, :12], jnp.float32)               # w2o rows
        g_base = irow[:, 12]
        node = jnp.where(is_inst, irow[:, 13],
                         jnp.where(desc >= 0, desc, 0))

        # Elementwise affine transform: fuses into the loop body, where a
        # per-ray batched dot is a matrix product of its own.
        def _apply34(p, translate):
            return jnp.stack(
                [
                    mm[:, 4 * a + 0] * p[:, 0] + mm[:, 4 * a + 1] * p[:, 1]
                    + mm[:, 4 * a + 2] * p[:, 2]
                    + (mm[:, 4 * a + 3] if translate else 0.0)
                    for a in range(3)
                ],
                axis=-1,
            )

        o = _apply34(origins, True)
        d = _apply34(directions, False)
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                                jnp.where(d < 0, -1e-12, 1e-12), d)

        # -- fetch 2: quad leaf record — 4 triangles + their global ids -------
        qrow = payload >> 3
        qcount = payload & 7
        qr = bvh.quad_rec[jnp.clip(qrow, 0, q_cap)]      # (r, 40) i32
        quad = bc(qr[:, :36], jnp.float32)
        bt, btri, bu, bv = best_t, best_tri, best_u, best_v
        for k in range(4):
            v0 = quad[:, 9 * k + 0 : 9 * k + 3]
            e1 = quad[:, 9 * k + 3 : 9 * k + 6]
            e2 = quad[:, 9 * k + 6 : 9 * k + 9]
            ok, t, u, v = _tri_hit(v0, e1, e2, o, d, t_eps)
            take = is_quad & (k < qcount) & ok & (t < bt)
            bt = jnp.where(take, t, bt)
            btri = jnp.where(take, g_base + qr[:, 36 + k], btri)
            bu = jnp.where(take, u, bu)
            bv = jnp.where(take, v, bv)

        # -- fetch 3: node record — 8 child bounds + descriptors --------------
        wrec = bvh.wide_rec[node]                        # (r, 56) i32
        cb = bc(wrec[:, :48], jnp.float32)
        meta = wrec[:, 48:56]
        keys = []
        descs = []
        for i in range(WIDE_WIDTH):
            lo = cb[:, 6 * i : 6 * i + 3]
            hi = cb[:, 6 * i + 3 : 6 * i + 6]
            hit_i, near_i = _aabb_hit(lo, hi, o, inv_d, bt)
            # Empty slots are masked by descriptor, not bounds: the min/max
            # slab test treats an inverted (lo > hi) box as spanning every
            # axis, i.e. ALWAYS hit. Wide id 0 is the TLAS root — never a
            # child — so meta == 0 means "padding".
            live_i = meta[:, i] != 0
            keys.append(jnp.where(hit_i & is_node & live_i, near_i, big))
            descs.append(meta[:, i])
        if not any_hit:
            # Far-first push order -> near child popped first (closest-hit
            # pruning). Batcher 8-sort: 19 compare-exchanges, elementwise.
            net = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
                   (5, 7), (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6),
                   (1, 4), (3, 6), (2, 4), (3, 5), (3, 4)]
            for a, b in net:
                swap = keys[a] > keys[b]
                ka = jnp.where(swap, keys[b], keys[a])
                kb = jnp.where(swap, keys[a], keys[b])
                da = jnp.where(swap, descs[b], descs[a])
                db = jnp.where(swap, descs[a], descs[b])
                keys[a], keys[b], descs[a], descs[b] = ka, kb, da, db

        # -- pushes: ONE masked scatter for all 8 children --------------------
        # Invalid lanes are pointed out of bounds and dropped — a single
        # scatter per step replaces the 8 sequential .at[].set scatters of
        # the first cut.
        valid = [k < big for k in keys]
        # suffix[i] = # valid lanes after i -> desc_i goes to sp + suffix[i]:
        # packs valid lanes contiguously with lane 0 on top, whether or not
        # the sort ran (any_hit skips it, so valid lanes aren't a prefix).
        suffix = [sp_pop * 0]
        for v in reversed(valid[1:]):
            suffix.append(suffix[-1] + v.astype(jnp.int32))
        suffix = suffix[::-1]
        vcount = suffix[0] + valid[0].astype(jnp.int32)
        oob = jnp.int32(WIDE_STACK_DEPTH + 8)
        idx_lanes = []
        val_lanes = []
        for i in range(WIDE_WIDTH):
            pos = sp_pop + suffix[i]
            idx_lanes.append(jnp.where(valid[i], pos, oob))
            val_lanes.append(descs[i])
        idx = jnp.stack(idx_lanes, axis=-1)          # (r, 8)
        vals = jnp.stack(val_lanes, axis=-1)
        stack = stack.at[rows[:, None], idx].set(vals, mode="drop")
        new_sp = jnp.minimum(sp_pop + vcount, WIDE_STACK_DEPTH - 1)

        if any_hit:
            new_sp = jnp.where(btri >= 0, 0, new_sp)

        return stack, new_sp, cur_inst, base_sp, bt, btri, bu, bv, step + 1

    state = (stack, sp, cur_inst, base_sp, best_t, best_tri, best_u, best_v,
             jnp.zeros((), jnp.int32))
    state = jax.lax.while_loop(cond, body, state)
    best_t, best_tri, best_u, best_v = state[4:8]
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v, hit=best_tri >= 0)


def _trace_two_level(
    bvh: TwoLevelBVH,
    origins: jax.Array,
    directions: jax.Array,
    t_max,
    t_eps: float,
    any_hit: bool,
    max_steps: int,
) -> Hit:
    """Two-level SIMD-over-rays traversal, PACKED-RECORD edition.

    Per step, each ray fetches: its current instance transform (one 3x4
    row; row 0 = identity for the TLAS), the popped node's int record
    [left, right, count, redirect], and EITHER the node's packed children
    bounds (internal: both kids' AABBs live in the parent record, so no
    child gathers) OR its 4-aligned quad triangle row (leaf: one 36-lane
    row holds all four [v0,e1,e2] triangles). ~4 gathers/step versus ~9-12
    in the naive layout — the traversal loop is serialized gather steps, so
    this is the dominant constant.

    Instead of storing (node, instance) stack pairs, each ray keeps two
    registers: ``cur_inst`` (the instance whose BLAS it is inside, -1 =
    TLAS) and ``base_sp`` (the stack depth at BLAS entry); popping below
    ``base_sp`` exactly identifies the return to the TLAS (transitions
    never nest). Directions are NOT renormalized by the instance transform,
    so ``t`` is world-metric in both levels and hit ordering across
    instances is correct.
    """
    r = origins.shape[0]
    rows = jnp.arange(r)
    q_cap = bvh.tri_quad.shape[0] - 1

    stack = jnp.zeros((r, STACK_DEPTH), jnp.int32)
    sp = jnp.ones((r,), jnp.int32)              # TLAS root pre-pushed
    cur_inst = jnp.full((r,), -1, jnp.int32)
    base_sp = jnp.zeros((r,), jnp.int32)
    best_t = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (r,)).astype(jnp.float32)
    best_tri = jnp.full((r,), -1, jnp.int32)
    best_u = jnp.zeros((r,))
    best_v = jnp.zeros((r,))

    def cond(state):
        sp = state[1]
        step = state[-1]
        return jnp.any(sp > 0) & (step < max_steps)

    def body(state):
        stack, sp, cur_inst, base_sp, best_t, best_tri, best_u, best_v, step = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[rows, top]
        # Returning below the BLAS entry depth = back in the TLAS.
        left_blas = active & (top < base_sp)
        cur_inst = jnp.where(left_blas, -1, cur_inst)
        base_sp = jnp.where(left_blas, 0, base_sp)
        inst = cur_inst
        sp_pop = jnp.where(active, sp - 1, sp)

        # Ray in the node's space (identity for TLAS rows).
        m = bvh.inst_w2o[inst + 1]                       # (r, 3, 4)
        # Elementwise affine transform: fuses into the loop body, where a
        # per-ray batched dot is a matrix product of its own.
        def _apply34(p, translate):
            return jnp.stack(
                [
                    m[:, a, 0] * p[:, 0] + m[:, a, 1] * p[:, 1]
                    + m[:, a, 2] * p[:, 2] + (m[:, a, 3] if translate else 0.0)
                    for a in range(3)
                ],
                axis=-1,
            )

        o = _apply34(origins, True)
        d = _apply34(directions, False)
        inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                                jnp.where(d < 0, -1e-12, 1e-12), d)

        ints = bvh.node_int[node]                        # (r, 4)
        n_left = ints[:, 0]
        n_right = ints[:, 1]
        cnt = ints[:, 2]
        redirect = ints[:, 3]
        is_tri_leaf = cnt > 0
        is_inst_leaf = cnt < 0
        is_internal = active & (cnt == 0)

        # -- internal: children bounds live in THIS record --------------------
        cb = bvh.node_cbounds[node]                      # (r, 12)
        hit_l, near_l = _aabb_hit(cb[:, 0:3], cb[:, 3:6], o, inv_d, best_t)
        hit_r, near_r = _aabb_hit(cb[:, 6:9], cb[:, 9:12], o, inv_d, best_t)
        hit_l = hit_l & is_internal
        hit_r = hit_r & is_internal

        # -- triangle leaf: ONE quad row = all 4 [v0, e1, e2] ------------------
        do_leaf = active & is_tri_leaf
        quad = bvh.tri_quad[jnp.clip(n_left >> 2, 0, q_cap)]   # (r, 36)
        bt, btri, bu, bv = best_t, best_tri, best_u, best_v
        g_base = bvh.inst_tri_base[jnp.maximum(inst, 0)]
        for k in range(4):
            v0 = quad[:, 9 * k + 0 : 9 * k + 3]
            e1 = quad[:, 9 * k + 3 : 9 * k + 6]
            e2 = quad[:, 9 * k + 6 : 9 * k + 9]
            ok, t, u, v = _tri_hit(v0, e1, e2, o, d, t_eps)
            take = do_leaf & (k < cnt) & ok & (t < bt)
            bt = jnp.where(take, t, bt)
            slot = jnp.clip(n_left + k, 0, bvh.tri_order.shape[0] - 1)
            btri = jnp.where(take, g_base + bvh.tri_order[slot], btri)
            bu = jnp.where(take, u, bu)
            bv = jnp.where(take, v, bv)

        # -- pushes ------------------------------------------------------------
        l_first = near_l <= near_r
        far_child = jnp.where(l_first, n_right, n_left)
        near_child = jnp.where(l_first, n_left, n_right)
        far_ok = jnp.where(l_first, hit_r, hit_l)
        near_ok = jnp.where(l_first, hit_l, hit_r)

        do_inst = active & is_inst_leaf
        push2_ok = near_ok | do_inst
        push2_val = jnp.where(do_inst, redirect, near_child)

        new_sp = sp_pop
        slot1 = jnp.minimum(new_sp, STACK_DEPTH - 1)
        stack = stack.at[rows, slot1].set(
            jnp.where(far_ok, far_child, stack[rows, slot1])
        )
        new_sp = jnp.where(far_ok, jnp.minimum(new_sp + 1, STACK_DEPTH - 1), new_sp)
        slot2 = jnp.minimum(new_sp, STACK_DEPTH - 1)
        stack = stack.at[rows, slot2].set(
            jnp.where(push2_ok, push2_val, stack[rows, slot2])
        )
        # Entering a BLAS: remember the instance and the entry depth (the
        # pushed root's slot) so popping below it restores the TLAS.
        cur_inst = jnp.where(do_inst, n_left, cur_inst)
        base_sp = jnp.where(do_inst, new_sp, base_sp)
        new_sp = jnp.where(push2_ok, jnp.minimum(new_sp + 1, STACK_DEPTH - 1), new_sp)

        if any_hit:
            new_sp = jnp.where(btri >= 0, 0, new_sp)

        return stack, new_sp, cur_inst, base_sp, bt, btri, bu, bv, step + 1

    state = (stack, sp, cur_inst, base_sp, best_t, best_tri, best_u, best_v,
             jnp.zeros((), jnp.int32))
    state = jax.lax.while_loop(cond, body, state)
    best_t, best_tri, best_u, best_v = state[4:8]
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v, hit=best_tri >= 0)


def trace_rays_brute(
    world_verts: np.ndarray,
    tris: np.ndarray,
    tri_valid: np.ndarray,
    origins: np.ndarray,
    directions: np.ndarray,
    t_max: float = 1e30,
    t_eps: float = 1e-4,
):
    """NumPy brute-force reference for tests: O(R x T)."""
    r = origins.shape[0]
    best_t = np.full((r,), t_max, np.float32)
    best_tri = np.full((r,), -1, np.int32)
    for ti in np.nonzero(tri_valid)[0]:
        v0, v1, v2 = world_verts[tris[ti]]
        e1 = v1 - v0
        e2 = v2 - v0
        pvec = np.cross(directions, e2)
        det = (e1[None] * pvec).sum(-1)
        good = np.abs(det) > 1e-12
        inv = np.where(good, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = origins - v0
        u = (tvec * pvec).sum(-1) * inv
        qvec = np.cross(tvec, e1)
        v = (directions * qvec).sum(-1) * inv
        t = (e2[None] * qvec).sum(-1) * inv
        ok = good & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_eps) & (t < best_t)
        best_t[ok] = t[ok]
        best_tri[ok] = ti
    return best_t, best_tri
