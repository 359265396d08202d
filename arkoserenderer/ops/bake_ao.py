"""Ambient-occlusion baking over the scene BVH.

Role-equivalent to BakeAmbientOcclusionNode (arkose/rendering/baking/
BakeAmbientOcclusionNode.cpp — offline RT AO / bent-normal baking): traces
hemisphere ray sets from surface points and returns occlusion (and bent
normals), for baking into vertex data or textures by the asset pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.halton import fibonacci_sphere
from arkoserenderer.ops.bvh import FlatBVH, trace_rays


def bake_ao(
    bvh: FlatBVH,
    points: jax.Array,     # (N, 3) world-space sample points
    normals: jax.Array,    # (N, 3)
    num_rays: int = 64,
    max_distance: float = 2.0,
    bias: float = 1e-2,
) -> tuple[jax.Array, jax.Array]:
    """Returns (ao (N,) in [0,1] — 1 = unoccluded, bent_normal (N, 3))."""
    dirs_all = jnp.asarray(fibonacci_sphere(num_rays * 2))  # both hemispheres

    n = points.shape[0]
    occl_sum = jnp.zeros((n,))
    bent_sum = jnp.zeros((n, 3))
    weight_sum = jnp.zeros((n,))

    origins = points + normals * bias
    for i in range(num_rays * 2):
        d = dirs_all[i]
        cos = mx.vdot(normals, d[None, :], keepdims=False)
        in_hemi = cos > 0.0
        hit = trace_rays(
            bvh, origins, jnp.broadcast_to(d, (n, 3)),
            t_max=max_distance, any_hit=True,
        )
        w = jnp.where(in_hemi, cos, 0.0)  # cosine-weighted
        occl_sum = occl_sum + w * hit.hit.astype(jnp.float32)
        bent_sum = bent_sum + jnp.where(
            (in_hemi & ~hit.hit)[:, None], d[None, :] * w[:, None], 0.0
        )
        weight_sum = weight_sum + w

    ao = 1.0 - occl_sum / jnp.maximum(weight_sum, 1e-6)
    bent = mx.normalize(bent_sum + normals * 1e-3)
    return ao, bent


def bake_vertex_ao(scene_arrays, num_rays: int = 64, max_distance: float = 2.0):
    """Vertex-domain AO over the whole scene pool (host convenience).

    Returns numpy (V,) ao and (V,3) bent normals for valid vertices.
    """
    from arkoserenderer.models.pathtracer import world_space_vertices

    wp = jnp.asarray(world_space_vertices(scene_arrays))
    inst = scene_arrays.vertex_instance
    nrm_w = mx.normalize(
        jnp.einsum("vij,vj->vi", scene_arrays.normal_mat[inst], scene_arrays.normals)
    )
    ao, bent = jax.jit(
        lambda b, p, n: bake_ao(b, p, n, num_rays=num_rays, max_distance=max_distance)
    )(scene_arrays.bvh, wp, nrm_w)
    return np.asarray(ao), np.asarray(bent)
