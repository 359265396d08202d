"""Translucent pass: closest-layer transparency over the opaque scene.

Role-equivalent to the reference's translucent forward pass
(ForwardRenderNode in Translucent mode, ShowcaseApp order after SkyView):
translucent-material triangles are rasterized into their own visibility
layer (depth-tested against the opaque depth, closest translucent surface
wins), shaded with the full material path, and alpha-blended over
SceneColor. Order-independent transparency comes from DEPTH PEELING:
``layers`` front-most translucent surfaces are extracted (each raster pass
rejects fragments at or in front of the previous layer via the raster's
``depth_limit`` hook), shaded, and composited back-to-front — exact OIT for
up to ``layers`` overlapping surfaces, unlike the reference's sorted draws.
Velocity from the closest layer replaces the background's for TAA
stability.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import raster
from arkoserenderer.ops.shading import shade_visibility_buffer
from arkoserenderer.rendering.passes.geometry import transform_vertices_clip
from arkoserenderer.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer.rendering.registry import Registry
from arkoserenderer.scene.scene import BLEND_TRANSLUCENT


class TranslucentPass(RenderPass):
    name = "ForwardTranslucent"

    def __init__(self, layers: int = 1):
        assert layers >= 1
        self.layers = layers

    def construct(self, cfg: PipelineConfig, reg: Registry):
        layers = self.layers
        h, w = cfg.height, cfg.width
        reg.get("geom.positions")
        reg.get("geom.normals")
        reg.get("geom.tangents")
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneVelocity")
        use_shadow = reg.has("ShadowMap.sun")
        if use_shadow:
            reg.get("ShadowMap.sun")
        rcfg = cfg.raster
        full_h = cfg.frame_height
        px, py = pixel_centers(cfg)
        n_spots = cfg.scene.n_spots
        n_points = cfg.scene.n_points
        tex_flags = cfg.scene

        def execute(state: dict, ctx: FrameContext) -> dict:
            scene = ctx.scene
            mat_of_tri = scene.inst_material[scene.tri_instance]
            translucent = (
                scene.materials.blend_mode[mat_of_tri] == BLEND_TRANSLUCENT
            ) & scene.tri_valid

            clip = transform_vertices_clip(
                scene, ctx.camera.view_proj, state["geom.positions"]
            )
            setup = raster.setup_triangles(
                clip, scene.indices, translucent, w, full_h,
                cull_backfaces=False, w_eps=ctx.camera.near,
            )
            bins = raster.bin_triangles(setup, w, h, rcfg, y_offset=ctx.row_offset)
            py_g = py + ctx.row_offset.astype(py.dtype)
            opaque_depth = state["SceneDepth"]

            # -- depth peeling: extract the K front-most translucent layers.
            peeled = []  # [(color (h,w,3), alpha (h,w,1), velocity, depth)]
            limit = None  # layer 0: unrestricted (closest surface)
            for _layer in range(layers):
                vis, depth = raster.rasterize_tiles(
                    setup, bins, w, h, rcfg, y_offset=ctx.row_offset,
                    depth_limit=limit,
                )
                in_front = mx.depth_closer(depth, opaque_depth)
                vis = jnp.where(in_front, vis, -1)
                gb = shade_visibility_buffer(
                    scene, ctx.camera, vis.reshape(-1), depth.reshape(-1),
                    setup, px, py_g, w, full_h,
                    shadow_map=state["ShadowMap.sun"] if use_shadow else None,
                    sun_shadow_vp=scene.lights.sun_view_proj if use_shadow else None,
                    positions=state["geom.positions"],
                    normals=state["geom.normals"],
                    tangents=state["geom.tangents"],
                    n_spots=n_spots, n_points=n_points, tex_flags=tex_flags,
                )
                tri = setup.orig_tri[jnp.maximum(vis.reshape(-1), 0)]
                alpha = scene.materials.base_color_factor[
                    scene.inst_material[scene.tri_instance[tri]]
                ][:, 3]
                a = jnp.where(gb.valid, alpha, 0.0).reshape(h, w, 1)
                peeled.append((gb.color.reshape(h, w, 3), a,
                               gb.velocity.reshape(h, w, 2)))
                limit = depth  # next layer: strictly behind this one

            # -- composite back-to-front (exact OIT for K layers).
            color = state["SceneColor"]
            for lc, la, _lv in reversed(peeled):
                color = color * (1.0 - la) + lc * la
            a0 = peeled[0][1]
            vel = jnp.where(
                (a0[..., 0] > 0.5)[..., None], peeled[0][2], state["SceneVelocity"]
            )
            return {"SceneColor": color, "SceneVelocity": vel}

        return execute
