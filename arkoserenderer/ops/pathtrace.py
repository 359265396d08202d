"""Progressive path tracer over the scene BVH.

Role-equivalent to PathTracerNode (arkose/rendering/pathtracer/
PathTracerNode.cpp + shaders/pathtracer/*): a megakernel-style wavefront of
H*W camera rays, N bounces of BRDF-importance-sampled GGX+Lambert transport
with next-event estimation toward the sun, environment light on miss, and a
persistent accumulation buffer that converges over frames (the reference's
only "resumable computation", reset on camera moves).

Serves as the ground-truth image source for validating the raster pipeline
(SURVEY.md §4) and as the PathTracerApp-equivalent flagship mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import brdf
from arkoserenderer.ops import texture as tx
from arkoserenderer.ops.bvh import FlatBVH, trace_rays
from arkoserenderer.ops.envmap import sample_equirect
from arkoserenderer.scene.camera import CameraState
from arkoserenderer.scene.scene import SceneArrays


def _onb(n):
    """Branchless orthonormal basis from a unit normal (Frisvad/Duff)."""
    s = jnp.where(n[:, 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2:3])
    b = n[:, 0:1] * n[:, 1:2] * a
    t = jnp.concatenate(
        [1.0 + s * n[:, 0:1] ** 2 * a, s * b, -s * n[:, 0:1]], axis=-1
    )
    bt = jnp.concatenate([b, s + n[:, 1:2] ** 2 * a, -n[:, 1:2]], axis=-1)
    return t, bt


def _cosine_sample(n, u1, u2):
    t, b = _onb(n)
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = (r * jnp.cos(phi))[:, None]
    y = (r * jnp.sin(phi))[:, None]
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))[:, None]
    return mx.normalize(x * t + y * b + z * n)


def _surface_at_hit(scene: SceneArrays, hit_tri, hit_u, hit_v):
    """Interpolate geometry + material at BVH hits (object arrays are
    world-pretransformed per instance at scene build... here object space ==
    world only for identity instances, so transform explicitly). Also
    returns sqrt(uv-area / world-area) — the uv length per world unit that
    turns a ray-cone radius into a texture footprint (no implicit screen
    derivatives exist at ray hits; same scheme as ops/rt.surface_at_hits)."""
    corners = scene.indices[hit_tri]                 # (R, 3)
    inst = scene.tri_instance[hit_tri]
    w_m = scene.world[inst]
    n_m = scene.normal_mat[inst]
    bary = jnp.stack(
        [1.0 - hit_u - hit_v, hit_u, hit_v], axis=-1
    )                                               # (R, 3)
    obj_pos = jnp.einsum("rk,rkc->rc", bary, scene.positions[corners],
                         precision=mx.HIGHEST)
    world_pos = jnp.einsum("rij,rj->ri", w_m[:, :3, :3], obj_pos,
                           precision=mx.HIGHEST) + w_m[:, :3, 3]
    obj_nrm = jnp.einsum("rk,rkc->rc", bary, scene.normals[corners],
                         precision=mx.HIGHEST)
    world_nrm = mx.normalize(jnp.einsum("rij,rj->ri", n_m, obj_nrm,
                                        precision=mx.HIGHEST))
    uv = jnp.einsum("rk,rkc->rc", bary, scene.uvs[corners], precision=mx.HIGHEST)
    mat_id = scene.inst_material[inst]
    p = scene.positions[corners]
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
    return world_pos, world_nrm, uv, mat_id, uv_density


def _material_at(scene: SceneArrays, mat_id, uv, footprint):
    """``footprint``: uv-space diameter of the ray cone at the hit (R,).
    Per-texture LOD = log2(footprint * texel resolution) — the ray-cone
    equivalent of screen-derivative mip selection (raster pipelines get this
    from duv/dx; ray hits must carry it explicitly)."""
    m = scene.materials

    def lod_for(tex_id):
        size0 = scene.textures.mip_size[tex_id, 0].astype(jnp.float32).max(-1)
        return jnp.log2(jnp.maximum(footprint * size0, 1e-6))

    base_tex = tx.sample_trilinear(
        scene.textures, m.base_color_tex[mat_id], uv,
        lod_for(m.base_color_tex[mat_id]),
    )
    base = base_tex[:, :3] * m.base_color_factor[mat_id][:, :3]
    mr = tx.sample_trilinear(
        scene.textures, m.mr_tex[mat_id], uv,
        lod_for(m.mr_tex[mat_id]), decode_srgb=False,
    )
    rough = jnp.clip(mr[:, 1:2] * m.roughness_factor[mat_id][:, None], 0.05, 1.0)
    metal = jnp.clip(mr[:, 2:3] * m.metallic_factor[mat_id][:, None], 0.0, 1.0)
    emissive = m.emissive_factor[mat_id]
    cc = m.clearcoat[mat_id][:, None]
    cc_rough = m.clearcoat_roughness[mat_id][:, None]
    return base, rough, metal, emissive, cc, cc_rough


SUN_COS = 0.9999  # ~0.8 degree solid-angle sun for NEE


def trace_path(
    scene: SceneArrays,
    bvh: FlatBVH,
    cam: CameraState,
    px: jax.Array,        # (R,) pixel centers
    py: jax.Array,
    width: int,
    height: int,
    key: jax.Array,       # PRNG key for this frame
    max_bounces: int = 3,
    aa: bool = True,
    n_spots: int = 0,     # static local-light counts (NEE per light)
    n_points: int = 0,
    spot_casters: tuple = (),   # per-light cast_shadows flags: a light the
    point_casters: tuple = (),  # raster leaves unshadowed is matched here
    sun_cos_radius: float = 1.0,      # cos(sun angular radius); < 1 = soft
    spot_source_radius: tuple = (),   # world-unit radii; > 0 = soft
    point_source_radius: tuple = (),
) -> jax.Array:
    """One sample per pixel of path-traced radiance (pre-exposed). (R, 3)."""
    r = px.shape[0]
    exposure = cam.exposure

    k_aa, key = jax.random.split(key)
    jitter = (jax.random.uniform(k_aa, (r, 2)) - 0.5) if aa else jnp.zeros((r, 2))

    inv_vp = jnp.linalg.inv(cam.unjittered_view_proj)
    ndc_x = (px + jitter[:, 0]) / width * 2.0 - 1.0
    ndc_y = (0.5 - (py + jitter[:, 1]) / height) * 2.0
    target_h = jnp.stack(
        [ndc_x, ndc_y, jnp.full_like(ndc_x, 0.5), jnp.ones_like(ndc_x)], axis=-1
    )
    target_h = mx.matmul(target_h, inv_vp.T)
    den = target_h[:, 3:4]
    inv = jnp.where(jnp.abs(den) > 1e-10, 1.0 / jnp.where(den == 0, 1.0, den), 0.0)
    target = target_h[:, :3] * inv
    origins = jnp.broadcast_to(cam.position, (r, 3))
    dirs = mx.normalize(target - origins)

    radiance = jnp.zeros((r, 3))
    throughput = jnp.ones((r, 3))
    alive = jnp.ones((r,), bool)

    # Ray-cone texture LOD: one pixel subtends ~2/(P11*height) radians
    # vertically (P11 = 1/tan(fov_y/2)); the cone radius grows linearly with
    # accumulated ray distance. Primary hits thus mip-filter like the raster
    # pipeline's screen derivatives (tests/test_truth.py compares the two).
    cone_spread = 2.0 / (jnp.abs(cam.unjittered_proj[1, 1]) * height)
    cone_t = jnp.zeros((r,))

    sun_l = -scene.lights.sun_direction
    sun_radiance = scene.lights.sun_color * exposure

    for bounce in range(max_bounces + 1):
        hit = trace_rays(bvh, origins, dirs)
        cone_t = cone_t + jnp.where(hit.hit, hit.t, 0.0)

        # Miss -> environment.
        env = sample_equirect(scene.env_map, dirs) * scene.env_brightness * exposure
        radiance = radiance + jnp.where(
            (alive & ~hit.hit)[:, None], throughput * env, 0.0
        )
        alive = alive & hit.hit
        if bounce == max_bounces:
            break

        tri = jnp.maximum(hit.tri, 0)
        world_pos, n, uv, mat_id, uv_density = _surface_at_hit(
            scene, tri, hit.u, hit.v
        )
        # Cone ellipse long axis stretches by 1/cos(incidence) on the
        # surface; mip selection keys on the LONG axis (the raster path's
        # max-gradient rho does the same), so grazing hits mip up properly.
        grazing = jnp.maximum(jnp.abs(mx.vdot(n, dirs, keepdims=False)), 0.05)
        footprint = (
            jnp.maximum(cone_t * cone_spread, 1e-6) * uv_density / grazing
        )
        base, rough, metal, emissive, cc, cc_rough = _material_at(
            scene, mat_id, uv, footprint
        )
        # Face-forward the shading normal against the incoming ray.
        n = n * jnp.where(mx.vdot(n, -dirs) < 0.0, -1.0, 1.0)

        radiance = radiance + jnp.where(
            alive[:, None], throughput * emissive * exposure, 0.0
        )

        view = -dirs

        # -- next-event estimation: sun ---------------------------------------
        # Soft sun (angular radius > 0): the OCCLUSION ray cone-samples the
        # sun disk (the raster soft path's occlusion-only approximation —
        # shading stays at the central direction); hard sun keeps the
        # deterministic single ray (and the exact pre-soft random stream).
        shadow_org = world_pos + n * 1e-3
        if sun_cos_radius < 1.0:
            k_sun, key = jax.random.split(key)
            us = jax.random.uniform(k_sun, (r, 2))
            sun_occ_dir = mx.sample_cone(
                sun_l[None, :], sun_cos_radius, us[:, 0], us[:, 1]
            )
        else:
            sun_occ_dir = jnp.broadcast_to(sun_l, (r, 3))
        occl = trace_rays(bvh, shadow_org, sun_occ_dir, any_hit=True)
        # Clearcoat lobe included: the raster's direct term carries it
        # (ops/packed_shading), so ground truth must too.
        fr_sun = brdf.evaluate(
            jnp.broadcast_to(sun_l, (r, 3)), view, n, base, rough, metal,
            cc, cc_rough,
        )
        lit = alive & ~occl.hit
        radiance = radiance + jnp.where(
            lit[:, None], throughput * fr_sun * sun_radiance * scene.lights.sun_valid, 0.0
        )

        # -- next-event estimation: local lights (same radiometry as the
        # raster path, ops/packed_shading — smooth cone^2 * IES / d^2 for
        # spots, 1/d^2 points — but with EXACT occlusion rays instead of
        # PCF shadow maps: the ground truth the raster local-light path is
        # validated against).
        for li in range(n_spots):
            to_l = scene.lights.spot_pos[li][None, :] - world_pos
            dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
            dist = jnp.sqrt(dist2)
            l_dir = to_l / dist
            casts = li >= len(spot_casters) or spot_casters[li]
            radius = (spot_source_radius[li]
                      if li < len(spot_source_radius) else 0.0)
            if casts:
                occ_dir, occ_tmax = l_dir, (dist - 2e-3)[:, 0]
                if radius > 0.0:   # soft: disk-jittered occlusion target
                    k_l, key = jax.random.split(key)
                    ul = jax.random.uniform(k_l, (r, 2))
                    off = mx.sample_disk_offset(l_dir, radius,
                                                ul[:, 0], ul[:, 1])
                    to_j = to_l + off
                    d_j = jnp.sqrt(jnp.maximum(mx.vdot(to_j, to_j), 1e-6))
                    occ_dir, occ_tmax = to_j / d_j, (d_j - 2e-3)[:, 0]
                occ_hit = trace_rays(
                    bvh, world_pos + n * 1e-3, occ_dir,
                    t_max=occ_tmax, any_hit=True,
                ).hit
            else:   # the raster leaves this light unshadowed — match it
                occ_hit = jnp.zeros(r, bool)
            cos_dir = -mx.vdot(l_dir, scene.lights.spot_dir[li][None, :],
                               keepdims=False)
            cone = scene.lights.spot_cone[li]
            tt = jnp.clip(
                (cos_dir - cone[1]) / jnp.maximum(cone[0] - cone[1], 1e-4),
                0.0, 1.0,
            )
            angle_idx = jnp.clip(
                (jnp.arccos(jnp.clip(cos_dir, -1.0, 1.0)) / jnp.pi * 255.0)
                .astype(jnp.int32), 0, 255,
            )
            ies = scene.lights.spot_ies[li][angle_idx]
            falloff = tt * tt * ies / dist2[:, 0]
            fr = brdf.evaluate(l_dir, view, n, base, rough, metal,
                               cc, cc_rough)
            radiance = radiance + jnp.where(
                (alive & ~occ_hit)[:, None],
                throughput * fr * (scene.lights.spot_color[li][None, :]
                                   * exposure) * falloff[:, None],
                0.0,
            )
        for li in range(n_points):
            to_l = scene.lights.point_pos[li][None, :] - world_pos
            dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
            dist = jnp.sqrt(dist2)
            l_dir = to_l / dist
            casts_p = li >= len(point_casters) or point_casters[li]
            radius_p = (point_source_radius[li]
                        if li < len(point_source_radius) else 0.0)
            if casts_p:
                occ_dir, occ_tmax = l_dir, (dist - 2e-3)[:, 0]
                if radius_p > 0.0:   # soft: disk-jittered occlusion target
                    k_l, key = jax.random.split(key)
                    ul = jax.random.uniform(k_l, (r, 2))
                    off = mx.sample_disk_offset(l_dir, radius_p,
                                                ul[:, 0], ul[:, 1])
                    to_j = to_l + off
                    d_j = jnp.sqrt(jnp.maximum(mx.vdot(to_j, to_j), 1e-6))
                    occ_dir, occ_tmax = to_j / d_j, (d_j - 2e-3)[:, 0]
                occ_p_hit = trace_rays(
                    bvh, world_pos + n * 1e-3, occ_dir,
                    t_max=occ_tmax, any_hit=True,
                ).hit
            else:
                occ_p_hit = jnp.zeros(r, bool)
            fr = brdf.evaluate(l_dir, view, n, base, rough, metal,
                               cc, cc_rough)
            radiance = radiance + jnp.where(
                (alive & ~occ_p_hit)[:, None],
                throughput * fr * (scene.lights.point_color[li][None, :]
                                   * exposure) / dist2,
                0.0,
            )

        # -- sample continuation direction ------------------------------------
        k1, k2, k3, key = jax.random.split(key, 4)
        u1 = jax.random.uniform(k1, (r,))
        u2 = jax.random.uniform(k2, (r,))
        pick_spec = jax.random.uniform(k3, (r,)) < (0.5 * metal[:, 0] + 0.04)

        # Diffuse: cosine-weighted; f * cos / pdf = albedo.
        d_diff = _cosine_sample(n, u1, u2)
        w_diff = base * (1.0 - metal)

        # Specular: VNDF GGX half-vector sample in tangent space.
        t, b = _onb(n)
        v_ts = jnp.stack(
            [mx.vdot(view, t, False), mx.vdot(view, b, False), mx.vdot(view, n, False)],
            axis=-1,
        )
        h_ts = brdf.sample_ggx_vndf(v_ts, (rough * rough)[:, 0], u1, u2)
        h_w = h_ts[:, 0:1] * t + h_ts[:, 1:2] * b + h_ts[:, 2:3] * n
        d_spec = mx.normalize(mx.reflect(dirs, h_w))
        f0 = brdf.base_f0(base, metal)
        # VNDF weight: F * G2/G1 ~ F * smith shadowing of outgoing.
        n_dot_l = jnp.clip(mx.vdot(n, d_spec), 0.0, 1.0)
        w_spec = brdf.f_schlick(jnp.clip(mx.vdot(view, h_w), 0.0, 1.0), f0) * jnp.where(
            n_dot_l > 0.0, 1.0, 0.0
        )

        dirs = jnp.where(pick_spec[:, None], d_spec, d_diff)
        contrib = jnp.where(pick_spec[:, None], w_spec, w_diff)
        # One-sample MIS between the two strategies (probability weights).
        p = jnp.where(pick_spec, 0.5 * metal[:, 0] + 0.04, 1.0 - (0.5 * metal[:, 0] + 0.04))
        throughput = throughput * contrib / jnp.maximum(p, 1e-3)[:, None]
        origins = world_pos + n * 1e-3
        # Kill rays leaving below the surface.
        alive = alive & (mx.vdot(n, dirs, False) > 0.0)
        throughput = jnp.where(alive[:, None], throughput, 0.0)

    return radiance
