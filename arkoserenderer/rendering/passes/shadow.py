"""Directional sun shadow map: depth-only raster from the light's ortho view.

Role-equivalent to DirectionalShadowDrawNode (8k ortho shadow map drawn via
the meshlet depth-only path, arkose/rendering/shadow/
DirectionalShadowDrawNode.cpp); the PCF projection to screen space happens in
the shading pass (projectShadow.comp equivalent lives in ops/shadow.py).

Under pixel-band SPMD sharding each device rasterizes a horizontal band of
the shadow map and the full map is reassembled with an all_gather over the
mesh axis (ICI) — every band's shading can sample anywhere in the map.

Publishes: ShadowMap.sun (S, S) f32 reverse-Z depth (full map on every device).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import raster
from arkoserenderer.rendering.passes.geometry import lod_instance_mask, transform_vertices_clip
from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry


class SunShadowPass(RenderPass):
    name = "SunShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        s = cfg.shadow_map_size
        reg.get("geom.positions")
        packed = cfg.shading_mode == "packed"
        if packed:
            reg.get("geom.vtx_world")
            # Prefiltered VSM moments for the single-tap shadow sample
            # (ops/shadow.shadow_moments; reduce_window prefilter is ~free).
            reg.create(
                "ShadowMoments.sun", (s // 2, s // 2, 2), jnp.float32,
                persistent=not (
                    getattr(cfg.scene, "dynamic", False)
                    or cfg.scene.has_skin or cfg.scene.has_morphs
                    or cfg.scene.has_hair
                ),
            )
        # Cached shadow maps: when nothing that casts shadows can move
        # (no skinning / morphs / hair / host-driven transforms), the sun
        # map is identical every frame — render it once and reuse until the
        # host bumps the scene version (streaming, edits, physics). The
        # classic static-shadow-cache optimization; the reference re-draws
        # per frame because its scenes are assumed dynamic.
        persist = not (
            getattr(cfg.scene, "dynamic", False)
            or cfg.scene.has_skin or cfg.scene.has_morphs or cfg.scene.has_hair
        )
        reg.create("ShadowMap.sun", (s, s), jnp.float32, clear=mx.DEPTH_FAR,
                   persistent=persist)
        if persist:
            reg.create("scene.version", (), jnp.int32, clear=-1, persistent=True)
            reg.create("SunShadow.version", (), jnp.int32, clear=-2,
                       persistent=True)
        rcfg = cfg.raster
        shard_axis = cfg.shard_axis
        n_shards = cfg.shard_count
        band = s // n_shards
        assert band % rcfg.tile_h == 0 and s % rcfg.tile_w == 0, (
            "shadow map size must tile evenly across shards"
        )

        cacheable = not (
            getattr(cfg.scene, "dynamic", False)
            or cfg.scene.has_skin or cfg.scene.has_morphs or cfg.scene.has_hair
        )

        def execute(state: dict, ctx: FrameContext) -> dict:
            def _render(_):
                if packed:
                    from arkoserenderer.rendering.passes.geometry import world_to_clip

                    clip = world_to_clip(
                        ctx.scene.lights.sun_view_proj,
                        state["geom.vtx_world"][:, 0:3],
                    )
                else:
                    clip = transform_vertices_clip(
                        ctx.scene, ctx.scene.lights.sun_view_proj,
                        state["geom.positions"],
                    )
                tri_valid = ctx.scene.tri_valid
                # Light-frustum culling (DirectionalShadowDrawNode's culling).
                planes = mx.frustum_planes_from_matrix(ctx.scene.lights.sun_view_proj)
                inst_vis = mx.frustum_test_spheres(
                    planes, ctx.scene.inst_sphere[:, :3], ctx.scene.inst_sphere[:, 3]
                ) & ctx.scene.inst_valid & lod_instance_mask(ctx.scene, ctx.camera.position)
                tri_valid = tri_valid & inst_vis[ctx.scene.tri_instance]
                if cfg.scene.has_translucent:
                    # Translucent surfaces don't occlude the sun (no colored
                    # shadow support yet).
                    from arkoserenderer.scene.scene import BLEND_TRANSLUCENT

                    mat_of_tri = ctx.scene.inst_material[ctx.scene.tri_instance]
                    tri_valid = tri_valid & (
                        ctx.scene.materials.blend_mode[mat_of_tri] != BLEND_TRANSLUCENT
                    )
                setup = raster.setup_triangles(
                    clip, ctx.scene.indices, tri_valid, s, s,
                    cull_backfaces=False,  # avoid peter-panning on single-sided geo
                )
                if shard_axis is None:
                    bins = raster.bin_triangles(setup, s, s, rcfg)
                    _, depth = raster.rasterize_tiles(
                        setup, bins, s, s, rcfg, depth_only=True
                    )
                else:
                    y0 = jax.lax.axis_index(shard_axis) * band
                    bins = raster.bin_triangles(setup, s, band, rcfg, y_offset=y0)
                    _, band_depth = raster.rasterize_tiles(
                        setup, bins, s, band, rcfg, depth_only=True, y_offset=y0
                    )
                    depth = jax.lax.all_gather(
                        band_depth, shard_axis, axis=0, tiled=True
                    )  # (S, S) on every device — rides ICI
                if packed:
                    from arkoserenderer.ops.shadow import shadow_moments

                    return depth, shadow_moments(depth)
                return (depth,)

            if not cacheable:
                res = _render(None)
            else:
                # Static scene: reuse the cached map until the host bumps
                # the scene version (streaming / edits / physics commits).
                def _reuse(_):
                    if packed:
                        return state["ShadowMap.sun"], state["ShadowMoments.sun"]
                    return (state["ShadowMap.sun"],)

                dirty = (ctx.frame_index == 0) | (
                    state["scene.version"] != state["SunShadow.version"]
                )
                res = jax.lax.cond(dirty, _render, _reuse, None)

            out = {"ShadowMap.sun": res[0]}
            if packed:
                out["ShadowMoments.sun"] = res[1]
            if cacheable:
                out["SunShadow.version"] = state["scene.version"]
                out["scene.version"] = state["scene.version"]
            return out

        return execute


class LocalShadowPass(RenderPass):
    """Per-spot-light shadow atlas: one depth-only perspective raster per
    casting spot light, unrolled at the compile-time light count.

    Role-equivalent to LocalShadowDrawNode + the shadow map atlas in
    ShadowMapAtlas (arkose/rendering/shadow/LocalShadowDrawNode.cpp): each
    local light gets an atlas tile; shading PCF-samples its tile through the
    light's perspective matrix.

    Publishes: ShadowMap.locals (n_spots, A, A) f32 reverse-Z depth (tiles
    for non-casting lights stay at the far clear and are skipped by the
    shading permutation anyway).
    """

    name = "LocalShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        a = cfg.local_shadow_map_size
        n_spots = cfg.scene.n_spots
        casters = cfg.scene.spot_shadow_casters
        reg.get("geom.positions")
        reg.create("ShadowMap.locals", (max(n_spots, 1), a, a), jnp.float32,
                   clear=mx.DEPTH_FAR)
        rcfg = cfg.raster
        assert a % rcfg.tile_h == 0 and a % rcfg.tile_w == 0, (
            "local shadow map size must be tileable"
        )

        def execute(state: dict, ctx: FrameContext) -> dict:
            tiles = []
            far = jnp.full((a, a), mx.DEPTH_FAR, jnp.float32)
            base_valid = ctx.scene.tri_valid
            if cfg.scene.has_translucent:
                from arkoserenderer.scene.scene import BLEND_TRANSLUCENT

                mat_of_tri = ctx.scene.inst_material[ctx.scene.tri_instance]
                base_valid = base_valid & (
                    ctx.scene.materials.blend_mode[mat_of_tri] != BLEND_TRANSLUCENT
                )
            for i in range(max(n_spots, 1)):
                if i >= len(casters) or not casters[i]:
                    tiles.append(far)
                    continue
                vp = ctx.scene.lights.spot_view_proj[i]
                clip = transform_vertices_clip(ctx.scene, vp, state["geom.positions"])
                planes = mx.frustum_planes_from_matrix(vp)
                inst_vis = mx.frustum_test_spheres(
                    planes, ctx.scene.inst_sphere[:, :3], ctx.scene.inst_sphere[:, 3]
                ) & ctx.scene.inst_valid & lod_instance_mask(
                    ctx.scene, ctx.camera.position
                )
                tri_valid = base_valid & inst_vis[ctx.scene.tri_instance]
                setup = raster.setup_triangles(
                    clip, ctx.scene.indices, tri_valid, a, a, cull_backfaces=False
                )
                bins = raster.bin_triangles(setup, a, a, rcfg)
                _, depth = raster.rasterize_tiles(
                    setup, bins, a, a, rcfg, depth_only=True
                )
                tiles.append(depth)
            return {"ShadowMap.locals": jnp.stack(tiles)}

        return execute
