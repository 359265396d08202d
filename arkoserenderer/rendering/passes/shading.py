"""Deferred shading pass wrapping ops/shading.shade_visibility_buffer.

Publishes the G-buffer channels the reference's GpuScene creates
(GpuScene.cpp:325-362) and VisibilityBufferShadingNode fills:
SceneColor, SceneNormal, SceneVelocity, SceneBaseColor, SceneMaterial.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.ops.shading import shade_visibility_buffer
from arkoserenderer.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer.rendering.registry import Registry


class VisibilityShadingPass(RenderPass):
    name = "VisibilityShading"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("Visibility")
        reg.get("SceneDepth")
        reg.get("vis.setup")
        packed = cfg.shading_mode == "packed"
        if packed:
            reg.get("vis.records")
        else:
            reg.get("geom.positions")
            reg.get("geom.normals")
            reg.get("geom.tangents")
        n_spots = cfg.scene.n_spots
        n_points = cfg.scene.n_points
        tex_flags = cfg.scene
        any_tex = (
            tex_flags.uses_base_tex or tex_flags.uses_normal_tex
            or tex_flags.uses_mr_tex or tex_flags.uses_emissive_tex
            or tex_flags.uses_occlusion_tex
        )
        texture_quality = cfg.texture_quality
        use_shadow = reg.has("ShadowMap.sun")
        use_moments = packed and reg.has("ShadowMoments.sun")
        if use_moments:
            reg.get("ShadowMoments.sun")
        elif use_shadow:
            reg.get("ShadowMap.sun")
        use_rt_shadow = reg.has("ShadowMask.sun")
        if use_rt_shadow:
            reg.get("ShadowMask.sun")
        use_local_shadow = reg.has("ShadowMap.locals")
        if use_local_shadow:
            reg.get("ShadowMap.locals")
        use_rt_local = reg.has("ShadowMask.locals")
        if use_rt_local:
            reg.get("ShadowMask.locals")
            reg.get("ShadowMask.points")
        spot_shadow_flags = cfg.scene.spot_shadow_casters
        reg.create("SceneColor", (h, w, 3), jnp.float32)
        reg.create("SceneNormal", (h, w, 3), jnp.float32)
        reg.create("SceneVelocity", (h, w, 2), jnp.float32)
        reg.create("SceneBaseColor", (h, w, 3), jnp.float32)
        reg.create("SceneMaterial", (h, w, 4), jnp.float32)
        reg.create("SceneCoverage", (h, w), jnp.bool_)
        px, py = pixel_centers(cfg)

        full_h = cfg.frame_height

        def execute(state: dict, ctx: FrameContext) -> dict:
            vis_flat = state["Visibility"].reshape(-1)
            depth_flat = state["SceneDepth"].reshape(-1)
            py_global = py + ctx.row_offset.astype(py.dtype)
            if packed:
                from arkoserenderer.ops.packed_shading import (
                    record_layout_for,
                    shade_packed,
                )

                gb = shade_packed(
                    ctx.scene, ctx.camera, vis_flat, depth_flat,
                    state["vis.records"], px, py_global, w, full_h,
                    shadow_moments=state["ShadowMoments.sun"] if use_moments else None,
                    sun_shadow_vp=(
                        ctx.scene.lights.sun_view_proj if use_moments else None
                    ),
                    shadow_mask=(
                        state["ShadowMask.sun"].reshape(-1) if use_rt_shadow else None
                    ),
                    local_shadow_maps=(
                        state["ShadowMap.locals"] if use_local_shadow else None
                    ),
                    spot_shadow_flags=(
                        spot_shadow_flags if use_local_shadow else None
                    ),
                    rt_spot_masks=(
                        state["ShadowMask.locals"].reshape(
                            state["ShadowMask.locals"].shape[0], -1
                        ) if use_rt_local else None
                    ),
                    rt_point_masks=(
                        state["ShadowMask.points"].reshape(
                            state["ShadowMask.points"].shape[0], -1
                        ) if use_rt_local else None
                    ),
                    n_spots=n_spots,
                    n_points=n_points,
                    any_tex=any_tex,
                    texture_quality=texture_quality,
                    shadow_filter=(
                        cfg.shadow_filter
                        if cfg.shadow_filter != "auto"
                        else "bilinear"
                    ),
                    frame_index=ctx.frame_index,
                    mip_bias=cfg.mip_bias,
                    layout=record_layout_for(cfg.scene),
                )
                return {
                    "SceneColor": gb.color.reshape(h, w, 3),
                    "SceneNormal": gb.normal.reshape(h, w, 3),
                    "SceneVelocity": gb.velocity.reshape(h, w, 2),
                    "SceneBaseColor": gb.base_color.reshape(h, w, 3),
                    "SceneMaterial": gb.material.reshape(h, w, 4),
                    "SceneCoverage": gb.valid.reshape(h, w),
                }
            gb = shade_visibility_buffer(
                ctx.scene, ctx.camera, vis_flat, depth_flat,
                state["vis.setup"], px, py_global, w, full_h,
                shadow_map=state["ShadowMap.sun"] if use_shadow else None,
                sun_shadow_vp=ctx.scene.lights.sun_view_proj if use_shadow else None,
                shadow_mask=state["ShadowMask.sun"].reshape(-1) if use_rt_shadow else None,
                local_shadow_maps=state["ShadowMap.locals"] if use_local_shadow else None,
                spot_shadow_flags=spot_shadow_flags if use_local_shadow else None,
                positions=state["geom.positions"],
                normals=state["geom.normals"],
                tangents=state["geom.tangents"],
                n_spots=n_spots,
                n_points=n_points,
                tex_flags=tex_flags,
                texture_quality=texture_quality,
            )
            return {
                "SceneColor": gb.color.reshape(h, w, 3),
                "SceneNormal": gb.normal.reshape(h, w, 3),
                "SceneVelocity": gb.velocity.reshape(h, w, 2),
                "SceneBaseColor": gb.base_color.reshape(h, w, 3),
                "SceneMaterial": gb.material.reshape(h, w, 4),
                "SceneCoverage": gb.valid.reshape(h, w),
            }

        return execute
