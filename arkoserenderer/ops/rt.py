"""Shared ray-traced shading helpers for screen-space RT passes.

Role-equivalent to the reference's RT hit-group shaders (the closest-hit
surface reconstruction in shaders/rt-reflections/raygen.rgen, rt-shadow/
raygen.rgen, and common/rtData access patterns): given BVH hits, reconstruct
the surface (position/normal/uv/material), evaluate simple direct lighting
(sun with an any-hit shadow ray) and optionally previous-frame DDGI for
ambient — the same "simplified shading at ray hits" the reference uses for
secondary rays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops.bvh import Hit, trace_rays
from arkoserenderer.ops.envmap import sample_equirect


def surface_at_hits(scene, hit: Hit, with_uv_density: bool = False):
    """Reconstruct geometry + material ids at hit points.

    ``with_uv_density=True`` additionally returns sqrt(uv-area / world-area)
    per hit — the uv length per world unit, which turns a ray-cone radius
    into a texture-LOD footprint (the RT analogue of screen derivatives;
    there are no implicit derivatives at ray hits, same reason the
    reference's hit shaders use explicit LOD)."""
    tri = jnp.maximum(hit.tri, 0)
    corners = scene.indices[tri]
    inst = scene.tri_instance[tri]
    bary = jnp.stack([1.0 - hit.u - hit.v, hit.u, hit.v], axis=-1)
    obj_pos = jnp.einsum("rk,rkc->rc", bary, scene.positions[corners],
                         precision=mx.HIGHEST)
    w_m = scene.world[inst]
    world_pos = jnp.einsum("rij,rj->ri", w_m[:, :3, :3], obj_pos,
                           precision=mx.HIGHEST) + w_m[:, :3, 3]
    obj_nrm = jnp.einsum("rk,rkc->rc", bary, scene.normals[corners],
                         precision=mx.HIGHEST)
    nrm = mx.normalize(jnp.einsum("rij,rj->ri", scene.normal_mat[inst], obj_nrm,
                                  precision=mx.HIGHEST))
    uv = jnp.einsum("rk,rkc->rc", bary, scene.uvs[corners], precision=mx.HIGHEST)
    mat_id = scene.inst_material[inst]
    if not with_uv_density:
        return world_pos, nrm, uv, mat_id

    p = scene.positions[corners]                     # (R, 3, 3) object space
    e1w = jnp.einsum("rij,rj->ri", w_m[:, :3, :3], p[:, 1] - p[:, 0],
                     precision=mx.HIGHEST)
    e2w = jnp.einsum("rij,rj->ri", w_m[:, :3, :3], p[:, 2] - p[:, 0],
                     precision=mx.HIGHEST)
    area_w = 0.5 * jnp.linalg.norm(jnp.cross(e1w, e2w), axis=-1)
    t_uv = scene.uvs[corners]
    e1u = t_uv[:, 1] - t_uv[:, 0]
    e2u = t_uv[:, 2] - t_uv[:, 0]
    area_uv = 0.5 * jnp.abs(e1u[:, 0] * e2u[:, 1] - e1u[:, 1] * e2u[:, 0])
    uv_density = jnp.sqrt(area_uv / jnp.maximum(area_w, 1e-12))
    return world_pos, nrm, uv, mat_id, uv_density


def shade_hits_simple(
    scene,
    hit: Hit,
    ray_dirs: jax.Array,
    exposure: jax.Array,
    ddgi_sample=None,   # callable (world_pos, normal) -> irradiance, optional
) -> jax.Array:
    """(R, 3) radiance: diffuse sun + optional DDGI ambient at hits, env on
    miss. Pre-exposed."""
    world_pos, nrm, uv, mat_id = surface_at_hits(scene, hit)
    nrm = nrm * jnp.where(mx.vdot(nrm, -ray_dirs) < 0.0, -1.0, 1.0)
    albedo = scene.materials.base_color_factor[mat_id][:, :3]
    emissive = scene.materials.emissive_factor[mat_id]

    sun_l = -scene.lights.sun_direction
    occl = trace_rays(
        scene.bvh, jnp.where(hit.hit[:, None], world_pos + nrm * 1e-2, -1e7),
        jnp.broadcast_to(sun_l, world_pos.shape), any_hit=True, t_max=1e4,
    )
    n_dot_l = jnp.clip(mx.vdot(nrm, sun_l[None, :], keepdims=False), 0.0, 1.0)
    color = (
        albedo / jnp.pi
        * (scene.lights.sun_color * exposure)[None, :]
        * (n_dot_l * (~occl.hit))[:, None]
        * scene.lights.sun_valid
    ) + emissive * exposure
    if ddgi_sample is not None:
        color = color + ddgi_sample(world_pos, nrm) * albedo / jnp.pi

    env = sample_equirect(scene.env_map, ray_dirs) * scene.env_brightness * exposure
    return jnp.where(hit.hit[:, None], color, env)


def shade_hits(
    scene,
    hit: Hit,
    ray_origins: jax.Array,
    ray_dirs: jax.Array,
    exposure: jax.Array,
    cone_spread: float = 2e-3,   # ray-cone half-angle (rad) ~ pixel footprint
    ddgi_sample=None,
    chunk_size: int | None = None,
    n_spots: int = 0,            # static local-light counts: hits evaluate
    n_points: int = 0,           # the same lights the primary pipeline does
    spot_casters: tuple = (),
    point_casters: tuple = (),
) -> jax.Array:
    """(R, 3) HONEST hit shading for reflection rays: textured material
    (packed-pool sample at ray-cone LOD), Filament BRDF for the sun with an
    any-hit shadow ray, emissive, point/spot-free env fallback on miss.

    The closest-hit analogue of the reference's RT pipeline (rt-reflections/
    raygen.rgen evaluates the full material + shadow at hits) — mirrors must
    match the path tracer, not a flat-albedo approximation. Pre-exposed.
    """
    from arkoserenderer.ops import brdf as brdf_ops
    from arkoserenderer.ops import mattex
    from arkoserenderer.ops.packed_shading import (
        M_BASEF, M_EMIF, M_METAL, M_ROUGH, M_TEXMETA,
    )

    world_pos, nrm, uv, mat_id, uv_density = surface_at_hits(
        scene, hit, with_uv_density=True
    )
    nrm = nrm * jnp.where(mx.vdot(nrm, -ray_dirs) < 0.0, -1.0, 1.0)
    mrec = scene.mat_records[mat_id]                  # (R, 32)

    # Ray-cone texture footprint: cone radius at the hit x uv-per-world.
    t_hit = hit.t * jnp.linalg.norm(ray_dirs, axis=-1)
    footprint = jnp.maximum(t_hit * cone_spread, 1e-6) * uv_density
    duv = jnp.stack([footprint, jnp.zeros_like(footprint)], axis=-1)
    ms = mattex.sample_packed(
        scene.mat_tex.rows,
        mrec[:, M_TEXMETA : M_TEXMETA + mattex.META_LANES],
        uv, duv, duv[:, ::-1], quality="bilinear",
    )
    base = ms.base[:, :3] * mrec[:, M_BASEF : M_BASEF + 3]
    rough = jnp.clip(ms.rough_metal[:, 0:1] * mrec[:, M_ROUGH : M_ROUGH + 1], 0.0, 1.0)
    metal = jnp.clip(ms.rough_metal[:, 1:2] * mrec[:, M_METAL : M_METAL + 1], 0.0, 1.0)
    emissive = ms.emissive * mrec[:, M_EMIF : M_EMIF + 3]

    sun_l = -scene.lights.sun_direction
    # Sun-occlusion rays only matter where the primary ray HIT something;
    # park the misses outside the scene so they exit in one step.
    occl_org = jnp.where(hit.hit[:, None], world_pos + nrm * 1e-2, -1e7)
    # t_max well under the parking distance: parked rays' slab interval
    # exceeds t_max, so they miss the root in one step.
    occl = trace_rays(
        scene.bvh, occl_org,
        jnp.broadcast_to(sun_l, world_pos.shape), any_hit=True,
        t_max=1e4, chunk_size=chunk_size,
    )
    view = -mx.normalize(ray_dirs)
    # brdf.evaluate returns f(l, v) * <n.l> — multiply by illuminance only.
    fr = brdf_ops.evaluate(
        jnp.broadcast_to(sun_l, nrm.shape), view, nrm, base, rough, metal
    )
    color = (
        fr
        * (scene.lights.sun_color * exposure)[None, :]
        * (~occl.hit)[:, None]
        * scene.lights.sun_valid
    ) + emissive * exposure

    # Local lights at reflection hits (same radiometry as the primary
    # shading loop, ops/packed_shading): reflections of spot/point-lit
    # surfaces must carry their light. Occlusion rays for casters, parked
    # for primary misses (one-step exit).
    for li in range(n_spots):
        to_l = scene.lights.spot_pos[li][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        dist = jnp.sqrt(dist2)
        l_dir = to_l / dist
        cos_dir = -mx.vdot(l_dir, scene.lights.spot_dir[li][None, :],
                           keepdims=False)
        cone = scene.lights.spot_cone[li]
        tt = jnp.clip((cos_dir - cone[1])
                      / jnp.maximum(cone[0] - cone[1], 1e-4), 0.0, 1.0)
        angle_idx = jnp.clip(
            (jnp.arccos(jnp.clip(cos_dir, -1.0, 1.0)) / jnp.pi * 255.0)
            .astype(jnp.int32), 0, 255)
        falloff = tt * tt * scene.lights.spot_ies[li][angle_idx] / dist2[:, 0]
        if li >= len(spot_casters) or spot_casters[li]:
            occ_l = trace_rays(
                scene.bvh, occl_org, l_dir,
                t_max=jnp.maximum(dist[:, 0] - 6e-2, 1e-3),
                any_hit=True, chunk_size=chunk_size,
            )
            falloff = falloff * (~occ_l.hit)
        fr_l = brdf_ops.evaluate(l_dir, view, nrm, base, rough, metal)
        color = color + fr_l * (
            scene.lights.spot_color[li][None, :] * exposure
        ) * falloff[:, None]
    for li in range(n_points):
        to_l = scene.lights.point_pos[li][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        dist = jnp.sqrt(dist2)
        l_dir = to_l / dist
        vis_l = 1.0
        if li < len(point_casters) and point_casters[li]:
            occ_l = trace_rays(
                scene.bvh, occl_org, l_dir,
                t_max=jnp.maximum(dist[:, 0] - 6e-2, 1e-3),
                any_hit=True, chunk_size=chunk_size,
            )
            vis_l = (~occ_l.hit).astype(jnp.float32)[:, None]
        fr_l = brdf_ops.evaluate(l_dir, view, nrm, base, rough, metal)
        color = color + fr_l * (
            scene.lights.point_color[li][None, :] * exposure
        ) / dist2 * vis_l

    # Diffuse ambient at the hit, matching what the PRIMARY pipeline applies
    # in LightingCompose (passes/post.py): DDGI when available, else the
    # flat env-average ambient — reflections of surfaces must carry the same
    # energy as those surfaces rendered directly (path-tracer parity).
    diffuse = base * (1.0 - metal) * ms.occlusion[:, None]
    if ddgi_sample is not None:
        color = color + ddgi_sample(world_pos, nrm) * diffuse
    else:
        from arkoserenderer.ops.envmap import ambient_of_normal

        ambient = ambient_of_normal(scene.env_map, nrm, scene.env_brightness)
        ambient = (ambient + scene.lights.ambient_lx / jnp.pi) * exposure
        color = color + diffuse * ambient

    env = sample_equirect(scene.env_map, ray_dirs) * scene.env_brightness * exposure
    return jnp.where(hit.hit[:, None], color, env)


def trace_shadow_mask(
    scene,
    world_pos: jax.Array,    # (N, 3) receiver points
    light_dir: jax.Array,    # (3,) direction TOWARD the light
    valid: jax.Array,        # (N,) geometry coverage
    t_max: float | jax.Array = 1e4,
    bias: float = 3e-2,
    chunk_size: int | None = None,
) -> jax.Array:
    """(N,) visibility mask via any-hit rays (rt-shadow raygen analogue).

    Bias is applied along the LIGHT direction so no surface normal is needed
    — the pass can run straight off the depth buffer before shading."""
    dirs = jnp.broadcast_to(light_dir, world_pos.shape)
    origins = world_pos + dirs * bias
    occl = trace_rays(scene.bvh, origins, dirs, t_max=t_max, any_hit=True,
                      chunk_size=chunk_size)
    return jnp.where(valid, (~occl.hit).astype(jnp.float32), 1.0)
