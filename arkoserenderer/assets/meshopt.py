"""Meshlet building + BC texture compression — native C++ with NumPy fallback.

Python-side of arkoserenderer/native/meshopt.cpp (the framework's
meshoptimizer/TextureCompressor equivalent; see that file's header for the
reference mapping). The shared library is a build product, never committed:
it is compiled from ``native/meshopt.cpp`` with g++ at first use and kept
next to the source (gitignored); if no compiler is available the NumPy
fallbacks produce identical results (slower).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
from pathlib import Path

import numpy as np

from arkoserenderer.core.logging import get_logger

log = get_logger("meshopt")

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "meshopt.cpp"
_LIB = _NATIVE_DIR / "libarkmeshopt.so"
_lib: ctypes.CDLL | None | bool = None  # None = not tried, False = unavailable


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is None:
        try:
            if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
                # Build to a private name, then rename: processes that build
                # at once (test workers) never load a half-written library.
                tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", "-O2", "-shared", "-fPIC", str(_SRC), "-o",
                         str(tmp)],
                        check=True, capture_output=True,
                    )
                    os.replace(tmp, _LIB)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(_LIB))
            lib.ark_build_meshlets.restype = ctypes.c_int32
            _lib = lib
        except Exception as e:  # no compiler / sandboxed fs
            log.warning("native meshopt unavailable (%s); using NumPy fallback", e)
            _lib = False
    return _lib or None


@dataclasses.dataclass
class Meshlets:
    """Per-meshlet triangle ranges + culling bounds
    (MeshletDataAsset analogue, arkcore/asset/MeshAsset.h meshlet data)."""

    tri_offset: np.ndarray  # (M,) into the (possibly reordered) triangle list
    tri_count: np.ndarray   # (M,)
    sphere: np.ndarray      # (M, 4) center xyz + radius
    cone: np.ndarray        # (M, 4) axis xyz + cutoff (dot < cutoff - backface)

    @property
    def count(self) -> int:
        return len(self.tri_offset)


def build_meshlets(
    positions: np.ndarray, indices: np.ndarray,
    max_verts: int = 64, max_tris: int = 126,
) -> Meshlets:
    """Greedy meshlet scan (reference limits: <=64 verts / <=126 tris,
    MeshletVisibilityBufferRenderNode.cpp:88-90)."""
    tris = np.ascontiguousarray(indices.reshape(-1, 3), np.int32)
    pos = np.ascontiguousarray(positions, np.float32)
    t = len(tris)
    if t == 0:
        z = np.zeros((0,), np.int32)
        return Meshlets(z, z, np.zeros((0, 4), np.float32), np.zeros((0, 4), np.float32))

    lib = _load()
    if lib is not None:
        off = np.zeros(t, np.int32)
        cnt = np.zeros(t, np.int32)
        bounds = np.zeros(t * 8, np.float32)
        m = lib.ark_build_meshlets(
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(t), ctypes.c_int32(max_verts), ctypes.c_int32(max_tris),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        b = bounds[: m * 8].reshape(m, 8)
        return Meshlets(off[:m].copy(), cnt[:m].copy(), b[:, :4].copy(), b[:, 4:].copy())

    # -- NumPy fallback (same greedy behavior) ---------------------------------
    offs, cnts, spheres, cones = [], [], [], []
    cursor = 0
    while cursor < t:
        start = cursor
        verts: set[int] = set()
        while cursor < t and cursor - start < max_tris:
            tri_set = set(tris[cursor])
            if len(verts | tri_set) > max_verts:
                break
            verts |= tri_set
            cursor += 1
        if cursor == start:
            cursor += 1
        seg = tris[start:cursor]
        pts = pos[seg.reshape(-1)]
        center = pos[seg.reshape(-1)].mean(0) if False else pts.mean(0)
        # match native: centroid of per-triangle centroids
        center = pos[seg].mean(axis=1).mean(axis=0)
        radius = np.linalg.norm(pts - center, axis=-1).max()
        e1 = pos[seg[:, 1]] - pos[seg[:, 0]]
        e2 = pos[seg[:, 2]] - pos[seg[:, 0]]
        fn = np.cross(e1, e2)
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        ok = ln[:, 0] > 1e-20
        fn = np.where(ok[:, None], fn / np.maximum(ln, 1e-20), 0.0)
        axis_v = fn.sum(0)
        al = np.linalg.norm(axis_v)
        if al > 1e-12:
            axis_v = axis_v / al
            cutoff = float(np.min(fn[ok] @ axis_v)) if ok.any() else 1.0
        else:
            axis_v = np.array([0, 0, 1.0], np.float32)
            cutoff = 1.0
        offs.append(start)
        cnts.append(cursor - start)
        spheres.append([*center, radius])
        cones.append([*axis_v, cutoff])
    return Meshlets(
        np.array(offs, np.int32), np.array(cnts, np.int32),
        np.array(spheres, np.float32), np.array(cones, np.float32),
    )


# ---------------------------------------------------------------------------
# BC4/BC5 block compression (TextureCompressor analogue)


def compress_bc4(channel: np.ndarray) -> np.ndarray:
    """(H, W) uint8 (dims % 4 == 0) -> (H/4 * W/4, 8) uint8 BC4 blocks."""
    h, w = channel.shape
    assert h % 4 == 0 and w % 4 == 0
    channel = np.ascontiguousarray(channel, np.uint8)
    lib = _load()
    out = np.zeros((h // 4) * (w // 4) * 8, np.uint8)
    if lib is not None:
        lib.ark_compress_bc4(
            channel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(h), ctypes.c_int32(w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.reshape(-1, 8)
    # NumPy fallback
    blocks = channel.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
    mn = blocks.min(1).astype(np.int32)
    mx = blocks.max(1).astype(np.int32)
    out = out.reshape(-1, 8)
    out[:, 0] = mx
    out[:, 1] = mn
    span = np.maximum(mx - mn, 1)[:, None]
    tq = np.rint((blocks.astype(np.int32) - mn[:, None]) * 7.0 / span).astype(np.int32)
    remap = np.array([1, 7, 6, 5, 4, 3, 2, 0], np.int64)
    codes = np.where((mx == mn)[:, None], 0, remap[np.clip(tq, 0, 7)])
    bits = np.zeros(len(blocks), np.uint64)
    for i in range(16):
        bits |= codes[:, i].astype(np.uint64) << np.uint64(3 * i)
    for i in range(6):
        out[:, 2 + i] = (bits >> np.uint64(8 * i)).astype(np.uint8)
    return out


def decompress_bc4(blocks: np.ndarray, height: int, width: int) -> np.ndarray:
    blocks = np.ascontiguousarray(blocks.reshape(-1), np.uint8)
    lib = _load()
    out = np.zeros(height * width, np.uint8)
    if lib is not None:
        lib.ark_decompress_bc4(
            blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(height), ctypes.c_int32(width),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out.reshape(height, width)
    blk = blocks.reshape(-1, 8)
    e0 = blk[:, 0].astype(np.int32)
    e1 = blk[:, 1].astype(np.int32)
    pal = np.zeros((len(blk), 8), np.int32)
    pal[:, 0] = e0
    pal[:, 1] = e1
    for i in range(1, 7):
        interp = ((7 - i) * e0 + i * e1) // 7
        alt = ((5 - i) * e0 + i * e1) // 5 if i < 5 else (0 if i == 5 else 255)
        pal[:, 1 + i] = np.where(e0 > e1, interp, alt)
    bits = np.zeros(len(blk), np.uint64)
    for i in range(6):
        bits |= blk[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    texels = np.zeros((len(blk), 16), np.uint8)
    for i in range(16):
        code = ((bits >> np.uint64(3 * i)) & np.uint64(7)).astype(np.int64)
        texels[:, i] = pal[np.arange(len(blk)), code]
    bh, bw = height // 4, width // 4
    return texels.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3).reshape(height, width)


def compress_bc5(r: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Two-channel BC5 (normal maps): (H,W)+(H,W) uint8 -> (blocks, 16)."""
    rb = compress_bc4(r)
    gb = compress_bc4(g)
    return np.concatenate([rb, gb], axis=1)
