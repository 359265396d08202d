"""Geometry pass: vertex transform + visibility-buffer rasterization.

Role-equivalent to the reference's GPU-driven visibility-buffer render node
(arkose/rendering/meshlet/MeshletVisibilityBufferRenderNode.cpp): transforms
the unified vertex pool by per-instance matrices, culls + bins triangles,
and rasterizes triangle ids + depth.

Publishes:
  SceneDepth       (H, W)  f32 reverse-Z
  Visibility       (H, W)  i32 triangle id (VIS_NONE background)
  vis.setup        TriSetup pytree for the shading pass
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import raster
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


def lod_instance_mask(scene, cam_pos):
    """(Dmax,) bool — which drawables' LOD bands contain the camera distance.

    Selection uses the MAIN camera for every pass (shadows too), matching the
    reference's per-frame LOD pick in GpuScene (one LOD per mesh per frame —
    shadow rays/rasters see the same geometry the camera does)."""
    d = jnp.linalg.norm(scene.inst_sphere[:, :3] - cam_pos[None, :], axis=-1)
    band = scene.inst_lod_band
    return (d >= band[:, 0]) & (d < band[:, 1])


def transform_vertices_clip(scene, view_proj, positions=None):
    """Object-space vertex pool -> clip space via per-instance matrices.

    One (D,4,4) matmul to fold VP into each instance matrix, then a gather +
    batched (V,) transform, all in full float32 (clip positions).
    """
    mvp = jnp.einsum("ij,djk->dik", view_proj, scene.world,
                     precision=mx.HIGHEST)  # (D, 4, 4)
    m = mvp[scene.vertex_instance]                           # (V, 4, 4)
    p = scene.positions if positions is None else positions
    # Broadcast mul-adds, not einsum: the elementwise form fuses with the
    # gather above and the concat below, and is float32 on every device.
    lanes = [
        m[:, r, 0] * p[:, 0] + m[:, r, 1] * p[:, 1]
        + m[:, r, 2] * p[:, 2] + m[:, r, 3]
        for r in range(4)
    ]
    return jnp.stack(lanes, axis=-1)


def world_to_clip(view_proj, wpos):
    """(4,4) @ (V,3) world positions -> (V,4) clip, elementwise (see
    mathx.transform_point_lanes for why not a dot)."""
    lanes = mx.transform_point_lanes(view_proj, wpos)
    return jnp.stack(lanes, axis=-1)


class GeometryPass(RenderPass):
    name = "Geometry"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("geom.positions")
        packed = cfg.shading_mode == "packed"
        if packed:
            reg.get("geom.vtx_world")
            reg.publish("vis.records")
        reg.create("SceneDepth", (cfg.height, cfg.width), jnp.float32,
                   clear=mx.DEPTH_FAR)
        reg.create("Visibility", (cfg.height, cfg.width), jnp.int32, clear=-1)
        reg.publish("vis.setup")
        w, h, rcfg = cfg.width, cfg.height, cfg.raster
        full_h = cfg.frame_height

        def execute(state: dict, ctx: FrameContext) -> dict:
            if packed:
                clip = world_to_clip(
                    ctx.camera.view_proj, state["geom.vtx_world"][:, 0:3]
                )
            else:
                clip = transform_vertices_clip(
                    ctx.scene, ctx.camera.view_proj, state["geom.positions"]
                )
            # Per-instance frustum culling before triangle setup — the
            # task-shader culling stage (meshletVisibilityBuffer.task:24-58 /
            # common/culling.glsl sphere-vs-frustum) at instance granularity;
            # per-meshlet refinement comes with meshlet pools.
            planes = mx.frustum_planes_from_matrix(ctx.camera.view_proj)
            inst_visible = mx.frustum_test_spheres(
                planes, ctx.scene.inst_sphere[:, :3], ctx.scene.inst_sphere[:, 3]
            ) & ctx.scene.inst_valid & lod_instance_mask(ctx.scene, ctx.camera.position)
            tri_visible = ctx.scene.tri_valid & inst_visible[ctx.scene.tri_instance]
            if cfg.scene.has_meshlets:
                # Per-meshlet refinement: world-space sphere test + backface
                # cone test (the task-shader meshlet culling,
                # meshletVisibilityBuffer.task:24-58).
                m_inst = ctx.scene.meshlet_instance
                w_m = ctx.scene.world[m_inst]
                c_obj = ctx.scene.meshlet_sphere[:, :3]
                c_w = jnp.einsum("mij,mj->mi", w_m[:, :3, :3], c_obj,
                                 precision=mx.HIGHEST) + w_m[:, :3, 3]
                scale = jnp.linalg.norm(w_m[:, :3, :3], axis=1).max(axis=-1)
                r_w = ctx.scene.meshlet_sphere[:, 3] * scale
                ml_vis = mx.frustum_test_spheres(planes, c_w, r_w)
                # Cone: cull when every face points away from the camera.
                axis_w = mx.normalize(jnp.einsum(
                    "mij,mj->mi", w_m[:, :3, :3], ctx.scene.meshlet_cone[:, :3]
                ))
                cutoff = ctx.scene.meshlet_cone[:, 3]
                to_cam = ctx.camera.position[None, :] - c_w
                dist = jnp.linalg.norm(to_cam, axis=-1)
                cos_view = jnp.sum(axis_w * to_cam, axis=-1) / jnp.maximum(dist, 1e-6)
                # Conservative: visible unless the most-facing triangle still
                # points away (standard meshlet cone test with sphere slack).
                cone_ok = (cutoff < 0.1) | (
                    cos_view > -jnp.sqrt(jnp.maximum(1.0 - cutoff * cutoff, 0.0))
                    - r_w / jnp.maximum(dist, 1e-6)
                )
                ml_vis = ml_vis & cone_ok & ctx.scene.meshlet_valid
                tri_visible = tri_visible & ml_vis[ctx.scene.tri_meshlet]
            if cfg.scene.has_translucent:
                # Translucent materials render in their own forward pass.
                from arkoserenderer.scene.scene import BLEND_TRANSLUCENT

                mat_of_tri = ctx.scene.inst_material[ctx.scene.tri_instance]
                tri_visible = tri_visible & (
                    ctx.scene.materials.blend_mode[mat_of_tri] != BLEND_TRANSLUCENT
                )
            # Screen mapping uses the FULL frame dims; binning + raster cover
            # only this device's band (h rows at ctx.row_offset).
            setup = raster.setup_triangles(
                clip, ctx.scene.indices, tri_visible, w, full_h,
                w_eps=ctx.camera.near,
            )
            bins = raster.bin_triangles(setup, w, h, rcfg, y_offset=ctx.row_offset)
            vis, depth = raster.rasterize_tiles(
                setup, bins, w, h, rcfg, y_offset=ctx.row_offset
            )
            out = {
                "SceneDepth": depth,
                "Visibility": vis,
                "vis.setup": setup,
                "vis.overflow": bins.overflow,
            }
            if packed:
                from arkoserenderer.ops.packed_shading import (
                    build_records,
                    record_layout_for,
                )

                out["vis.records"] = build_records(
                    setup, state["geom.vtx_world"], ctx.scene.indices,
                    ctx.scene.tri_material, ctx.scene.mat_records,
                    layout=record_layout_for(cfg.scene),
                )
            return out

        return execute
