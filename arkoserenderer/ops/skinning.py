"""GPU skinning + morph targets as batched matmuls.

Role-equivalent to the reference's skinning compute kernel
(arkose/shaders/skinning/skinning.comp, dispatched from
GpuScene.cpp:629-711): morph-target blend (weighted delta sums) followed by
4-joint linear-blend skinning of positions / normals / tangents: gather the
4 palette matrices per vertex and contract, in full float32 (positions) —
XLA fuses the weighted blend into the transform. Static vertices pass
through untouched (weight sum == 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.core.mathx import HIGHEST, normalize


def skin_vertices(
    positions: jax.Array,      # (V, 3) bind-pose object space
    normals: jax.Array,        # (V, 3)
    tangents: jax.Array,       # (V, 4) xyz + handedness w
    skin_joints: jax.Array,    # (V, 4) i32 palette indices
    skin_weights: jax.Array,   # (V, 4) f32; all-zero row = static vertex
    palette: jax.Array,        # (J, 4, 4) joint_world @ inverse_bind
):
    """Returns (positions', normals', tangents') with skinned rows replaced."""
    w = skin_weights                                        # (V, 4)
    is_skinned = jnp.sum(w, axis=-1, keepdims=True) > 1e-6

    mats = palette[skin_joints]                             # (V, 4, 4, 4)
    blend = jnp.einsum("vk,vkab->vab", w, mats,
                       precision=HIGHEST)             # (V, 4, 4)

    p_new = (
        jnp.einsum("vab,vb->va", blend[:, :3, :3], positions,
                   precision=HIGHEST) + blend[:, :3, 3]
    )
    # Rotation-ish part for directions (LBS standard approximation).
    n_new = normalize(jnp.einsum("vab,vb->va", blend[:, :3, :3], normals,
                                 precision=HIGHEST))
    t_new = normalize(jnp.einsum("vab,vb->va", blend[:, :3, :3], tangents[:, :3],
                                 precision=HIGHEST))

    positions = jnp.where(is_skinned, p_new, positions)
    normals = jnp.where(is_skinned, n_new, normals)
    tangents = jnp.concatenate(
        [jnp.where(is_skinned, t_new, tangents[:, :3]), tangents[:, 3:4]], axis=-1
    )
    return positions, normals, tangents


def apply_morphs(
    positions: jax.Array,       # (V, 3)
    normals: jax.Array,         # (V, 3)
    morph_pos: jax.Array,       # (B, Vm, 3) position deltas for the morph block
    morph_nrm: jax.Array,       # (B, Vm, 3) normal deltas
    weights: jax.Array,         # (B,)
    vertex_offset: int,         # start of the morph block in the pool
):
    """Adds weighted morph deltas to a contiguous vertex range
    (MorphTargetAsset semantics: sparse block of the pool owns targets)."""
    vm = morph_pos.shape[1]
    dp = jnp.einsum("b,bvc->vc", weights, morph_pos,
                    precision=HIGHEST)   # matvec over targets
    dn = jnp.einsum("b,bvc->vc", weights, morph_nrm, precision=HIGHEST)
    positions = jax.lax.dynamic_update_slice_in_dim(
        positions,
        jax.lax.dynamic_slice_in_dim(positions, vertex_offset, vm) + dp,
        vertex_offset, axis=0,
    )
    normals = jax.lax.dynamic_update_slice_in_dim(
        normals,
        normalize(jax.lax.dynamic_slice_in_dim(normals, vertex_offset, vm) + dn),
        vertex_offset, axis=0,
    )
    return positions, normals
