"""Brute-force NumPy rasterizer — ground truth for unit tests only.

Per-pixel loop over every triangle; O(pixels x triangles), never used in the
render path. Must match ops/raster.py bit-for-bit in coverage and closely in
depth (same edge functions and conventions).
"""

from __future__ import annotations

import numpy as np

from arkoserenderer.core.types import VIS_NONE


def rasterize_numpy(
    clip: np.ndarray,
    indices: np.ndarray,
    tri_valid: np.ndarray,
    width: int,
    height: int,
    cull_backfaces: bool = True,
    w_eps: float = 1e-6,
):
    """Returns (vis (H,W) i32, depth (H,W) f32) — reverse-Z, far = 0."""
    vis = np.full((height, width), VIS_NONE, dtype=np.int32)
    depth = np.zeros((height, width), dtype=np.float32)

    for t in range(indices.shape[0]):
        if not tri_valid[t]:
            continue
        tri = clip[indices[t]]  # (3, 4)
        w = tri[:, 3]
        if np.any(w <= w_eps):
            continue
        ndc = tri[:, :3] / w[:, None]
        sx = (ndc[:, 0] * 0.5 + 0.5) * width
        sy = (0.5 - ndc[:, 1] * 0.5) * height
        s = np.stack([sx, sy], axis=-1)

        def edge(a, b, qx, qy):
            return (b[1] - a[1]) * (qx - a[0]) - (b[0] - a[0]) * (qy - a[1])

        area2 = edge(s[0], s[1], s[2, 0], s[2, 1])
        if cull_backfaces:
            if area2 <= 1e-12:
                continue
        elif abs(area2) <= 1e-12:
            continue

        # Only pixels whose centres can lie in the triangle: its bounding
        # box, widened by a pixel (the same answer as the whole frame).
        x0 = max(int(np.floor(s[:, 0].min())) - 1, 0)
        x1 = min(int(np.ceil(s[:, 0].max())) + 1, width)
        y0 = max(int(np.floor(s[:, 1].min())) - 1, 0)
        y1 = min(int(np.ceil(s[:, 1].max())) + 1, height)
        if x0 >= x1 or y0 >= y1:
            continue
        px, py = np.meshgrid(np.arange(x0, x1, dtype=np.float32) + 0.5,
                             np.arange(y0, y1, dtype=np.float32) + 0.5)
        e0 = edge(s[1], s[2], px, py)
        e1 = edge(s[2], s[0], px, py)
        e2 = edge(s[0], s[1], px, py)
        l0, l1, l2 = e0 / area2, e1 / area2, e2 / area2
        d = l0 * ndc[0, 2] + l1 * ndc[1, 2] + l2 * ndc[2, 2]
        win_vis = vis[y0:y1, x0:x1]
        win_depth = depth[y0:y1, x0:x1]
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (d > win_depth)
        win_vis[covered] = t
        win_depth[covered] = d[covered]
    return vis, depth
