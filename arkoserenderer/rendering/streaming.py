"""Asynchronous budgeted geometry streaming — the VertexManager state
machine + GpuScene upload-budget analogue.

Reference semantics being reproduced:
  * arkose/rendering/VertexManager.h:187-226 — per-mesh incremental
    streaming state machine (PendingAllocation -> UploadingVertexData ->
    ... -> Loaded), advanced a bounded amount per frame.
  * arkose/rendering/GpuScene.cpp:483-553 — per-frame upload BUDGET (the
    reference finalizes async textures under 75% of its upload buffer).

Realization: scene pools are fixed-capacity device arrays, so streaming
is pure ``dynamic_update_slice`` work — no allocation, no shape change, no
retrace. Uploads flow through a fixed-size staging chunk (the UploadBuffer
analogue): one jitted masked-DUS program per (dtype, row-shape) moves up to
CHUNK rows per dispatch, donating the pool buffer so the copy is in-place
on device. The host side stages work with ``Scene.stage_instance`` (pool
allocation + mirror writes + load-safe upload ordering) and optionally
prepares assets on TaskGraph worker threads (the reference's background
texture loads, GpuScene.cpp:1452-1655).

A partially-streamed instance is never visible: ``tri_valid`` and
``inst_valid`` rows are the LAST uploads of each ticket.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

CHUNK_ROWS = 65536        # rows per upload dispatch (per pool row-shape)
PENDING = "pending"       # asset prepare (host/TaskGraph) not finished
UPLOADING = "uploading"   # device copies in flight, budget-limited
LOADED = "loaded"


@partial(jax.jit, static_argnums=(4,), donate_argnums=(0,))
def _upload_chunk(pool, staging, offset, count, chunk):
    """Masked dynamic-update-slice of ``staging[:count]`` into
    ``pool[offset:offset+count]``. Handles offsets near the pool end by
    rolling the staging data (DUS clamps offsets; the roll re-aligns)."""
    n = pool.shape[0]
    off = jnp.minimum(offset, n - chunk)
    shift = offset - off
    idx = jnp.arange(chunk)
    mask = (idx >= shift) & (idx < shift + count)
    mask = mask.reshape((chunk,) + (1,) * (pool.ndim - 1))
    st = jnp.roll(staging, shift, axis=0)
    cur = jax.lax.dynamic_slice_in_dim(pool, off, chunk, axis=0)
    return jax.lax.dynamic_update_slice_in_dim(
        pool, jnp.where(mask, st, cur), off, axis=0
    )


@dataclasses.dataclass
class _Upload:
    field: str
    offset: int
    rows: np.ndarray
    done: int = 0

    @property
    def remaining(self) -> int:
        return self.rows.shape[0] - self.done

    @property
    def row_bytes(self) -> int:
        return int(self.rows.nbytes // max(self.rows.shape[0], 1))


@dataclasses.dataclass
class StreamTicket:
    """One streamed instance moving through the state machine."""

    uploads: list
    lights: object = None
    instance_id: int = -1
    material_id: int = -1
    state: str = UPLOADING
    prepare: object = None   # optional Future: host-side asset prepare

    @property
    def bytes_total(self) -> int:
        return sum(u.rows.nbytes for u in self.uploads)

    @property
    def bytes_done(self) -> int:
        return sum(u.done * u.row_bytes for u in self.uploads)


class StreamingManager:
    """Per-frame budgeted upload pump. Call ``tick(arrays)`` once per frame
    from the host loop; it returns the (same-shaped) SceneArrays with up to
    ``budget_bytes`` of newly-streamed data applied in-place on device."""

    def __init__(self, scene, budget_bytes: int = 4 << 20,
                 chunk_rows: int = CHUNK_ROWS):
        self.scene = scene
        self.budget_bytes = budget_bytes
        self.chunk_rows = chunk_rows
        self.queue: list[StreamTicket] = []
        self.loaded: list[StreamTicket] = []
        self.bytes_uploaded_last_tick = 0

    # -- enqueue ---------------------------------------------------------------

    def enqueue_instance(self, segment_id: int, world, lod_band=None) -> StreamTicket:
        """Stage an instance of an existing segment for budgeted upload."""
        kw = {} if lod_band is None else {"lod_band": lod_band}
        plan = self.scene.stage_instance(segment_id, world, **kw)
        t = StreamTicket(
            uploads=[_Upload(f, o, np.ascontiguousarray(r))
                     for (f, o, r) in plan["uploads"]],
            lights=plan["lights"],
            instance_id=plan["instance_id"],
        )
        self.queue.append(t)
        return t

    def enqueue_material(self, mat) -> StreamTicket:
        """Stage a NEW material's packed texture chain for budgeted upload
        (texture streaming — GpuScene.cpp:483-553's async-texture
        finalization under the frame's upload budget). The texel rows are
        the bulk and stream first; the 32-lane material record lands LAST,
        so a half-resident material is never sampleable."""
        plan = self.scene.stage_material(mat)
        t = StreamTicket(
            uploads=[_Upload(f, o, np.ascontiguousarray(r))
                     for (f, o, r) in plan["uploads"]],
            material_id=plan["material_id"],
        )
        self.queue.append(t)
        return t

    def enqueue_async(self, prepare_fn, *args) -> StreamTicket:
        """Prepare an asset on a TaskGraph worker (decode/import off the
        frame loop — the reference's background texture loads), then stream
        it. ``prepare_fn(*args)`` must return ``(segment_id, world)`` or a
        ready upload-plan dict from ``Scene.stage_instance``."""
        from arkoserenderer.core.taskgraph import schedule_task

        t = StreamTicket(uploads=[], state=PENDING)
        t.prepare = schedule_task(prepare_fn, *args, background=True)
        self.queue.append(t)
        return t

    @property
    def pending(self) -> int:
        return len(self.queue)

    # -- per-frame pump --------------------------------------------------------

    def tick(self, arrays):
        """Advance the state machine under the byte budget. Returns the
        updated SceneArrays (same pytree structure — never retraces)."""
        budget = self.budget_bytes
        spent = 0
        while self.queue and budget > 0:
            t = self.queue[0]
            if t.state == PENDING:
                if not t.prepare.done():
                    break                      # keep frame order deterministic
                result = t.prepare.result()
                if isinstance(result, dict):
                    plan = result
                else:
                    plan = self.scene.stage_instance(result[0], result[1])
                t.uploads = [_Upload(f, o, np.ascontiguousarray(r))
                             for (f, o, r) in plan["uploads"]]
                t.lights = plan["lights"]
                t.instance_id = plan["instance_id"]
                t.state = UPLOADING

            for u in t.uploads:
                while u.remaining > 0 and budget > 0:
                    n = min(u.remaining, self.chunk_rows)
                    arrays = self._apply(arrays, u, n)
                    nbytes = n * u.row_bytes
                    budget -= nbytes
                    spent += nbytes
                if u.remaining > 0:
                    break
            if all(u.remaining == 0 for u in t.uploads):
                # Activation epilogue: refit lights to the grown bounds
                # (small host-built arrays; see Scene.stage_instance).
                if t.lights is not None:
                    arrays = arrays._replace(lights=t.lights)
                if any(u.field.startswith("bvh.") for u in t.uploads):
                    # The streamed instance's BVH rows are in place: one
                    # in-jit refit folds its TLAS leaf + wide/packed records
                    # in (the CreatingBLAS->Loaded hop of VertexManager's
                    # state machine, without a host rebuild or retrace).
                    from arkoserenderer.ops.bvh import refit_bvh

                    arrays = arrays._replace(
                        bvh=refit_bvh(arrays.bvh, arrays.positions,
                                      arrays.indices)
                    )
                t.state = LOADED
                self.loaded.append(self.queue.pop(0))
        self.bytes_uploaded_last_tick = spent
        return arrays

    def _apply(self, arrays, u: _Upload, n: int):
        # "bvh.<name>" / "mat_tex.<name>" address a nested pytree inside
        # SceneArrays (streamed-instance TLAS wiring, streamed-material
        # texel chains; Scene.stage_instance / Scene.stage_material).
        nested = u.field.split(".", 1)
        if len(nested) == 2:
            import dataclasses as _dc

            parent = getattr(arrays, nested[0])
            pool = getattr(parent, nested[1])
            new_pool = self._apply_pool(pool, u, n)
            if hasattr(parent, "_replace"):   # NamedTuple (e.g. mat_tex)
                new_parent = parent._replace(**{nested[1]: new_pool})
            else:                             # dataclass (e.g. TwoLevelBVH)
                new_parent = _dc.replace(parent, **{nested[1]: new_pool})
            return arrays._replace(**{nested[0]: new_parent})
        pool = getattr(arrays, u.field)
        return arrays._replace(**{u.field: self._apply_pool(pool, u, n)})

    def _apply_pool(self, pool, u: _Upload, n: int):
        # Power-of-two chunk buckets: tiny uploads (single instance rows)
        # stage tiny buffers instead of a full CHUNK transfer, while the jit
        # cache stays bounded (one program per field x pow2 bucket).
        bucket = 1 << max(int(np.ceil(np.log2(max(u.rows.shape[0], 1)))), 0)
        chunk = min(self.chunk_rows, pool.shape[0], max(bucket, 1))
        rows = u.rows[u.done : u.done + n]
        staging = np.zeros((chunk,) + u.rows.shape[1:], u.rows.dtype)
        staging[:n] = rows
        # jnp.array (copy=True): jnp.asarray may ZERO-COPY alias the numpy
        # buffer on CPU, and this staging array is reused/freed while the
        # async upload still reads it — a nondeterministic corruption.
        new_pool = _upload_chunk(
            pool, jnp.array(staging), jnp.asarray(u.offset + u.done, jnp.int32),
            jnp.asarray(n, jnp.int32), chunk,
        )
        u.done += n
        return new_pool
