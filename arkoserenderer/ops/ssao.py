"""Screen-space ambient occlusion (hemisphere kernel).

Role-equivalent to SSAONode (arkose/rendering/nodes/SSAONode.cpp +
shaders/ssao/ssao.comp): N hemisphere samples oriented by the pixel normal,
projected back into the depth buffer, range-checked occlusion with a
hash-rotated kernel; 3x3 blur to hide the rotation noise (the reference's
blur is a TODO there — we do better).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.halton import halton_sequence_2d


def make_ssao_kernel(n_samples: int = 16, seed_bias: float = 0.35) -> np.ndarray:
    """(n, 3) tangent-space hemisphere samples, biased toward the center."""
    h = halton_sequence_2d(n_samples, (2, 3))
    phi = 2.0 * np.pi * h[:, 0]
    cos_t = np.sqrt(1.0 - h[:, 1])  # cosine-weighted
    sin_t = np.sqrt(h[:, 1])
    d = np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], -1)
    # Scale samples inward so near-field occlusion dominates.
    scale = seed_bias + (1.0 - seed_bias) * (np.arange(n_samples) / n_samples) ** 2
    return (d * scale[:, None]).astype(np.float32)


def reconstruct_world_pos(depth_flat, px, py, inv_view_proj, width, height):
    """Reverse-Z depth + pixel centers -> world positions (N, 3).

    Sky pixels (depth == 0 with an infinite-far projection) would divide by
    w == 0; the guarded division returns 0 positions instead of inf (callers
    mask sky pixels anyway, and special values must never be materialized)."""
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    h = jnp.stack([ndc_x, ndc_y, depth_flat, jnp.ones_like(ndc_x)], axis=-1)
    w = mx.matmul(h, inv_view_proj.T)
    den = w[:, 3:4]
    inv = jnp.where(jnp.abs(den) > 1e-10, 1.0 / jnp.where(den == 0, 1.0, den), 0.0)
    return w[:, :3] * inv


def ssao(
    depth: jax.Array,        # (H, W) reverse-Z
    normal_flat: jax.Array,  # (N, 3) world normals
    valid_flat: jax.Array,   # (N,) coverage
    px: jax.Array,
    py: jax.Array,
    cam_view_proj: jax.Array,
    cam_near: jax.Array,
    width: int,
    height: int,
    kernel: np.ndarray,
    radius: float = 0.5,
    bias: float = 0.02,   # meters
    intensity: float = 1.0,
    samples_per_frame: int | None = None,  # stochastic subset under TAA
    frame_index: jax.Array | None = None,
    sample_depth: jax.Array | None = None,  # full-frame depth for the
    # occlusion fetches when ``depth`` is only this device's pixel band
    # (pixel-band SPMD: pass the all_gather-ed (full_h, W) depth so kernel
    # samples that land outside the band read the true neighbor rows).
) -> jax.Array:
    """Returns (N,) ambient visibility in [0,1] (1 = unoccluded).

    ``samples_per_frame``: evaluate only M randomly-chosen kernel samples
    per pixel per frame (expectation = the full N-sample estimate; TAA
    accumulates toward it — temporal SSAO). Each sample is a serialized
    2M-lane depth gather, most of the cost of this pass, so 16 -> 2
    samples cuts it ~8x.
    """
    depth_flat = depth.reshape(-1)
    inv_vp = jnp.linalg.inv(cam_view_proj)
    world = reconstruct_world_pos(depth_flat, px, py, inv_vp, width, height)

    n = normal_flat
    # Per-pixel random rotation of the kernel around the normal.
    angle = (px * 12.9898 + py * 78.233) * 43758.5453
    angle = (angle - jnp.floor(angle)) * (2.0 * jnp.pi)
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    helper = jnp.where(
        jnp.abs(n[:, 1:2]) < 0.99,
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), n.shape),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), n.shape),
    )
    t0 = mx.normalize(jnp.cross(helper, n))
    b0 = jnp.cross(n, t0)
    t = t0 * ca[:, None] + b0 * sa[:, None]
    b = -t0 * sa[:, None] + b0 * ca[:, None]

    kern = jnp.asarray(kernel)
    n_samples = kern.shape[0]
    depth_img = depth if sample_depth is None else sample_depth
    sample_h = depth_img.shape[0]

    stochastic = (
        samples_per_frame is not None and samples_per_frame < n_samples
    )
    if stochastic:
        # Per-pixel per-frame kernel-index hash; the 16-row kernel lookup
        # is a where-chain (elementwise), not a gather.
        fi = frame_index if frame_index is not None else 0
        base_seed = (
            px.astype(jnp.int32) * 7
            + py.astype(jnp.int32) * 73856093
            + fi * 19349663
        ).astype(jnp.uint32)

    def linearize(d):
        # Reverse-Z (infinite-far family): view distance = near / depth.
        return cam_near / jnp.maximum(d, 1e-8)

    def kernel_row(idx):
        """(N,) int -> (N, 3) via a 16-way select chain (no gather unit)."""
        out = jnp.broadcast_to(kern[0], (idx.shape[0], 3))
        for j in range(1, n_samples):
            out = jnp.where((idx == j)[:, None], kern[j], out)
        return out

    def occlusion_at(k3, acc):
        sample = world + (t * k3[:, 0:1] + b * k3[:, 1:2] + n * k3[:, 2:3]) * radius
        clip = mx.transform_points_h(cam_view_proj, sample)
        w_c = jnp.maximum(clip[:, 3], 1e-6)
        sx = (clip[:, 0] / w_c * 0.5 + 0.5) * width
        sy = (0.5 - clip[:, 1] / w_c * 0.5) * height
        sample_z = w_c  # view-space distance of the sample point
        xi = jnp.clip(sx.astype(jnp.int32), 0, width - 1)
        yi = jnp.clip(sy.astype(jnp.int32), 0, sample_h - 1)
        scene_z = linearize(depth_img.reshape(-1)[yi * width + xi])
        # Occluded when the scene surface is in FRONT of the sample point
        # (compare in view-space meters, not NDC).
        occluded = scene_z < sample_z - bias
        # Range check: ignore occluders far from the sample.
        range_w = jnp.clip(1.0 - jnp.abs(scene_z - sample_z) / radius, 0.0, 1.0)
        return acc + occluded.astype(jnp.float32) * range_w

    if stochastic:
        occ = jnp.zeros(world.shape[0])
        for j in range(samples_per_frame):
            h_ = (base_seed + np.uint32(j * 374761393)) * jnp.uint32(0x9E3779B1)
            h_ = (h_ ^ (h_ >> 16)) * jnp.uint32(0x85EBCA6B)
            idx = ((h_ >> 8) % n_samples).astype(jnp.int32)
            occ = occlusion_at(kernel_row(idx), occ)
        occ = occ * (n_samples / samples_per_frame)
        n_eff = n_samples
    else:
        occ = jax.lax.fori_loop(
            0, n_samples,
            lambda i, acc: occlusion_at(
                jnp.broadcast_to(kern[i], (world.shape[0], 3)), acc
            ),
            jnp.zeros(world.shape[0]),
        )
        n_eff = n_samples
    ao = 1.0 - intensity * occ / n_eff
    return jnp.where(valid_flat, jnp.clip(ao, 0.0, 1.0), 1.0)
