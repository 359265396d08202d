"""Scene pass — always node #0, like the reference's GpuScene node.

Role-equivalent to the per-frame GpuScene execute (GpuScene.cpp:476-1011):
the per-frame scene-side work that must happen before any rendering. Round-1
scope: GPU skinning of the vertex pool from the uploaded joint palette
(skinning.comp analogue). Streaming, TLAS refit and light upload slot in
here as they land.

Publishes: geom.positions / geom.normals / geom.tangents — the (possibly
animated) object-space geometry every raster/shadow/shading pass consumes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops.skinning import apply_morphs, skin_vertices
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class ScenePass(RenderPass):
    name = "Scene"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.publish("geom.positions")
        reg.publish("geom.normals")
        reg.publish("geom.tangents")
        packed = cfg.shading_mode == "packed"
        if packed:
            # World-space packed vertex pool for the record-based shading
            # path (ops/packed_shading.build_vertex_world).
            from arkoserenderer.ops.packed_shading import record_layout_for

            layout = record_layout_for(cfg.scene)
            reg.publish("geom.vtx_world")
        has_skin = cfg.scene.has_skin
        has_hair = cfg.scene.has_hair
        hair_base = cfg.scene.hair_vertex_base
        has_morphs = cfg.scene.has_morphs
        morph_bases = cfg.scene.morph_vertex_base  # tuple: one per block

        def execute(state: dict, ctx: FrameContext) -> dict:
            s = ctx.scene
            if has_morphs:
                # Morph blend BEFORE skinning, like skinning.comp's order;
                # one block per morphed instance (static count, unrolled).
                p0, n0 = s.positions, s.normals
                for i, base in enumerate(morph_bases):
                    p0, n0 = apply_morphs(
                        p0, n0, s.morph_pos[i], s.morph_nrm[i],
                        s.morph_weights[i], base,
                    )
                s = s._replace(positions=p0, normals=n0)
            if has_skin:
                p, n, t = skin_vertices(
                    s.positions, s.normals, s.tangents,
                    s.skin_joints, s.skin_weights, s.palette,
                )
            else:
                p, n, t = s.positions, s.normals, s.tangents
            if has_hair:
                # Camera-facing ribbon expansion (HairMesh's per-frame strand
                # geometry, hair shading path): left/right verts straddle the
                # strand perpendicular to the view.
                hp = s.hair_points
                view = mx.normalize(ctx.camera.position[None, :] - hp)
                side = mx.normalize(jnp.cross(s.hair_tangents, view))
                side = side * s.hair_radius[:, None]
                ribbon = jnp.stack([hp - side, hp + side], axis=1).reshape(-1, 3)
                nrm = jnp.stack([view, view], axis=1).reshape(-1, 3)
                tan = jnp.concatenate(
                    [
                        jnp.stack([s.hair_tangents] * 2, axis=1).reshape(-1, 3),
                        jnp.ones((ribbon.shape[0], 1)),
                    ],
                    axis=-1,
                )
                p = jax.lax.dynamic_update_slice_in_dim(p, ribbon, hair_base, axis=0)
                n = jax.lax.dynamic_update_slice_in_dim(n, nrm, hair_base, axis=0)
                t = jax.lax.dynamic_update_slice_in_dim(t, tan, hair_base, axis=0)
            out = {"geom.positions": p, "geom.normals": n, "geom.tangents": t}
            if packed:
                from arkoserenderer.ops.packed_shading import build_vertex_world

                out["geom.vtx_world"] = build_vertex_world(
                    ctx.scene, p, n, t, layout=layout
                )
            return out

        return execute
