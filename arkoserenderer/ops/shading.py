"""Full-screen deferred material shading from the visibility buffer.

Role-equivalent to the reference's VisibilityBufferShadingNode
(arkose/rendering/nodes/VisibilityBufferShadingNode.cpp +
shaders/visibility-buffer/shadeVisibilityBuffer.comp:1-278): per pixel,
reconstruct the triangle + perspective-correct barycentrics and their
derivatives, interpolate attributes, sample material textures with
gradient-correct LOD, apply normal mapping, and evaluate the Filament BRDF
for the sun (with shadow mask) and local lights, writing SceneColor plus the
G-buffer channels (normal+velocity, base color, material) that downstream
passes (TAA, SSAO, reflections, compose) consume.

The whole screen is flattened to (N = H*W) and shaded as one SIMD batch —
the array-program replacement for a compute dispatch over 8x8 groups.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import brdf
from arkoserenderer.ops import interpolate as ip
from arkoserenderer.ops import texture as tx
from arkoserenderer.ops.envmap import average_radiance, sample_equirect
from arkoserenderer.ops.raster import TriSetup
from arkoserenderer.ops.shadow import sample_shadow_pcf
from arkoserenderer.scene.camera import CameraState
from arkoserenderer.scene.scene import SceneArrays


class GBuffer(NamedTuple):
    """Flattened (N, ...) G-buffer — mirrors GpuScene's targets
    (GpuScene.cpp:325-362): SceneColor, SceneNormalVelocity split in two,
    SceneBaseColor, SceneMaterial (roughness/metallic/occlusion)."""

    color: jax.Array        # (N, 3) pre-exposed linear HDR
    normal: jax.Array       # (N, 3) world-space shading normal
    velocity: jax.Array     # (N, 2) screen-space motion in pixels (cur - prev)
    base_color: jax.Array   # (N, 3)
    material: jax.Array     # (N, 4) roughness, metallic, cavity/ao, subsurface
    depth: jax.Array        # (N,) raster depth (reverse-Z)
    valid: jax.Array        # (N,) bool geometry coverage


def shade_visibility_buffer(
    scene: SceneArrays,
    cam: CameraState,
    vis_flat: jax.Array,        # (N,) raster triangle ids
    depth_flat: jax.Array,      # (N,)
    setup: TriSetup,
    px: jax.Array,              # (N,) pixel centers
    py: jax.Array,
    width: int,
    height: int,
    shadow_map: jax.Array | None = None,   # (S, S) sun shadow depth
    sun_shadow_vp: jax.Array | None = None,
    shadow_mask: jax.Array | None = None,  # (N,) RT shadow mask (wins over map)
    local_shadow_maps: jax.Array | None = None,  # (S_lights, A, A) spot atlas
    spot_shadow_flags: tuple | None = None,      # per-spot casts-shadow (static)
    positions: jax.Array | None = None,    # animated object-space pools
    normals: jax.Array | None = None,      # (defaults: the static scene pools)
    tangents: jax.Array | None = None,
    n_spots: int | None = None,            # static light counts (loop unroll)
    n_points: int | None = None,
    tex_flags=None,                        # SceneStatic texture-usage flags
    texture_quality: str = "trilinear",
) -> GBuffer:
    positions = scene.positions if positions is None else positions
    normals = scene.normals if normals is None else normals
    tangents = scene.tangents if tangents is None else tangents
    if n_spots is None:
        n_spots = scene.lights.spot_pos.shape[0]
    if n_points is None:
        n_points = scene.lights.point_pos.shape[0]

    geom = ip.pixel_barycentrics(vis_flat, setup, scene.indices, px, py)
    n = px.shape[0]
    exposure = cam.exposure

    inst = scene.tri_instance[geom.tri]          # (N,)
    mat_id = scene.inst_material[inst]           # (N,)
    m = scene.materials

    # -- interpolate geometry --------------------------------------------------
    obj_pos = ip.interpolate(positions, geom)            # (N, 3)
    w_mats = scene.world[inst]                                  # (N, 4, 4)
    world_pos = (
        jnp.einsum("nij,nj->ni", w_mats[:, :3, :3], obj_pos,
                   precision=mx.HIGHEST) + w_mats[:, :3, 3]
    )
    pw_mats = scene.prev_world[inst]
    prev_world_pos = (
        jnp.einsum("nij,nj->ni", pw_mats[:, :3, :3], obj_pos,
                   precision=mx.HIGHEST) + pw_mats[:, :3, 3]
    )

    obj_nrm = ip.interpolate(normals, geom)
    n_mats = scene.normal_mat[inst]
    world_nrm = mx.normalize(jnp.einsum("nij,nj->ni", n_mats, obj_nrm,
                                        precision=mx.HIGHEST))
    obj_tan = ip.interpolate(tangents, geom)
    world_tan = mx.normalize(
        jnp.einsum("nij,nj->ni", w_mats[:, :3, :3], obj_tan[:, :3],
                   precision=mx.HIGHEST)
    )

    uv, duv_dx, duv_dy = ip.interpolate_with_grad(scene.uvs, geom)

    # -- material texture fetches -------------------------------------------
    # Sampler chains compile only for texture slots the scene actually uses
    # (SceneStatic flags — the reference's shader-permutation equivalent).
    def _use(flag, default=True):
        return default if tex_flags is None else getattr(tex_flags, flag)

    tq = texture_quality
    _p2 = bool(getattr(tex_flags, "textures_pow2", False))
    if _use("uses_base_tex"):
        base_tex = tx.sample_grad(scene.textures, m.base_color_tex[mat_id], uv, duv_dx, duv_dy, quality=tq, pow2=_p2)
        base_color = base_tex[:, :3] * m.base_color_factor[mat_id][:, :3]
    else:
        base_color = m.base_color_factor[mat_id][:, :3]

    if _use("uses_mr_tex"):
        mr_tex = tx.sample_grad(
            scene.textures, m.mr_tex[mat_id], uv, duv_dx, duv_dy,
            decode_srgb=False, quality=tq, pow2=_p2,
        )
        roughness = jnp.clip(mr_tex[:, 1:2] * m.roughness_factor[mat_id][:, None], 0.0, 1.0)
        metallic = jnp.clip(mr_tex[:, 2:3] * m.metallic_factor[mat_id][:, None], 0.0, 1.0)
    else:
        roughness = jnp.clip(m.roughness_factor[mat_id][:, None], 0.0, 1.0)
        metallic = jnp.clip(m.metallic_factor[mat_id][:, None], 0.0, 1.0)

    if _use("uses_emissive_tex", False):
        emissive_tex = tx.sample_grad(
            scene.textures, m.emissive_tex[mat_id], uv, duv_dx, duv_dy,
            quality=tq, pow2=_p2,
        )
        emissive = emissive_tex[:, :3] * m.emissive_factor[mat_id]
    else:
        emissive = m.emissive_factor[mat_id]

    if _use("uses_occlusion_tex", False):
        occl_tex = tx.sample_grad(
            scene.textures, m.occlusion_tex[mat_id], uv, duv_dx, duv_dy,
            decode_srgb=False, quality=tq, pow2=_p2,
        )
        occlusion = occl_tex[:, 0:1]
    else:
        occlusion = jnp.ones_like(roughness)

    # -- normal mapping (MikkT-style TBN) ----------------------------------------
    if _use("uses_normal_tex"):
        nrm_tex = tx.sample_grad(
            scene.textures, m.normal_tex[mat_id], uv, duv_dx, duv_dy,
            decode_srgb=False, quality=tq, pow2=_p2,
        )
        n_ts = nrm_tex[:, :3] * 2.0 - 1.0
        bitan = jnp.cross(world_nrm, world_tan) * obj_tan[:, 3:4]
        shading_nrm = mx.normalize(
            n_ts[:, 0:1] * world_tan + n_ts[:, 1:2] * bitan + n_ts[:, 2:3] * world_nrm
        )
    else:
        shading_nrm = world_nrm

    view = mx.normalize(cam.position[None, :] - world_pos)
    # Double-sided materials and back-facing raster results flip the normal
    # toward the viewer.
    facing = jnp.sign(mx.vdot(shading_nrm, view))
    flip = jnp.where(m.double_sided[mat_id][:, None], facing, 1.0)
    shading_nrm = shading_nrm * jnp.where(flip == 0.0, 1.0, flip)

    clearcoat = m.clearcoat[mat_id][:, None]
    cc_rough = m.clearcoat_roughness[mat_id][:, None]

    # -- direct lighting -----------------------------------------------------------
    color = emissive * exposure

    sun_l = -scene.lights.sun_direction[None, :]
    n_dot_l_geo = jnp.clip(mx.vdot(world_nrm, sun_l, keepdims=False), 0.0, 1.0)
    if shadow_mask is not None:
        shadow = shadow_mask
    elif shadow_map is not None:
        shadow = sample_shadow_pcf(shadow_map, sun_shadow_vp, world_pos, n_dot_l_geo)
    else:
        shadow = jnp.ones((n,))
    sun_fr = brdf.evaluate(
        jnp.broadcast_to(sun_l, (n, 3)), view, shading_nrm,
        base_color, roughness, metallic, clearcoat, cc_rough,
    )
    sun_radiance = scene.lights.sun_color[None, :] * exposure
    color = color + sun_fr * sun_radiance * shadow[:, None] * scene.lights.sun_valid

    # Local lights: the ACTUAL light counts are compile-time constants
    # (SceneStatic), so the loops unroll to exactly the work needed — the
    # analogue of the reference building PSO permutations per light setup.
    for i in range(n_spots):
        to_l = scene.lights.spot_pos[i][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        l = to_l * jax.lax.rsqrt(dist2)
        cos_dir = -mx.vdot(l, scene.lights.spot_dir[i][None, :], keepdims=False)
        cone = scene.lights.spot_cone[i]
        t = jnp.clip((cos_dir - cone[1]) / jnp.maximum(cone[0] - cone[1], 1e-4), 0.0, 1.0)
        # IES photometric profile: polar-angle LUT (IESProfile analogue).
        angle_idx = jnp.clip(
            (jnp.arccos(jnp.clip(cos_dir, -1.0, 1.0)) / jnp.pi * 255.0).astype(jnp.int32),
            0, 255,
        )
        ies = scene.lights.spot_ies[i][angle_idx]
        falloff = t * t * ies / dist2[:, 0]
        if (
            local_shadow_maps is not None
            and spot_shadow_flags is not None
            and i < len(spot_shadow_flags)
            and spot_shadow_flags[i]
        ):
            # Local shadow atlas tile through the light's perspective
            # matrix (LocalShadowDrawNode + projectShadow equivalents).
            n_dot_l_spot = jnp.clip(mx.vdot(world_nrm, l, keepdims=False), 0.0, 1.0)
            falloff = falloff * sample_shadow_pcf(
                local_shadow_maps[i], scene.lights.spot_view_proj[i],
                world_pos, n_dot_l_spot,
            )
        fr = brdf.evaluate(l, view, shading_nrm, base_color, roughness, metallic)
        color = color + fr * (
            scene.lights.spot_color[i][None, :] * exposure
        ) * falloff[:, None]

    for i in range(n_points):
        to_l = scene.lights.point_pos[i][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        l = to_l * jax.lax.rsqrt(dist2)
        fr = brdf.evaluate(l, view, shading_nrm, base_color, roughness, metallic)
        color = color + fr * (
            scene.lights.point_color[i][None, :] * exposure
        ) / dist2

    # NOTE: ambient / indirect terms are NOT added here — the lighting
    # compose pass (LightingComposeNode analogue) combines them with SSAO /
    # DDGI / reflections, exactly like the reference splits direct shading
    # from GI composition.

    # -- velocity -------------------------------------------------------------------
    # Motion vector in pixels: current (unjittered) minus previous projection.
    def to_screen(vp, p):
        clip = mx.transform_points_h(vp, p)
        w_c = clip[:, 3]
        inv_w = jnp.where(jnp.abs(w_c) > 1e-8, 1.0 / jnp.where(w_c == 0, 1.0, w_c), 0.0)
        sx = (clip[:, 0] * inv_w * 0.5 + 0.5) * width
        sy = (0.5 - clip[:, 1] * inv_w * 0.5) * height
        return jnp.stack([sx, sy], axis=-1)

    cur_s = to_screen(cam.unjittered_view_proj, world_pos)
    prev_s = to_screen(cam.prev_view_proj, prev_world_pos)
    velocity = cur_s - prev_s

    valid = geom.valid
    vf = valid[:, None]
    return GBuffer(
        color=jnp.where(vf, color, 0.0),
        normal=jnp.where(vf, shading_nrm, 0.0),
        velocity=jnp.where(vf, velocity, 0.0),
        base_color=jnp.where(vf, base_color, 0.0),
        material=jnp.where(
            vf,
            jnp.concatenate(
                [roughness, metallic, occlusion, m.subsurface[mat_id][:, None]],
                axis=-1,
            ),
            0.0,
        ),
        depth=depth_flat,
        valid=valid,
    )


def shade_sky(
    scene: SceneArrays,
    cam: CameraState,
    color: jax.Array,   # (N, 3) shaded geometry color
    valid: jax.Array,   # (N,) coverage
    px: jax.Array,
    py: jax.Array,
    width: int,
    height: int,
):
    """Fill background pixels with the environment map along camera rays
    (SkyViewNode analogue) and return (color, sky_velocity).

    Sky velocity is the camera-rotation-only reprojection delta used by TAA
    for background pixels (cf. sky-view's velocity output).
    """
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    # Unproject at an arbitrary depth on the near plane, ignore translation.
    inv_vp = jnp.linalg.inv(cam.unjittered_view_proj)
    d_h = jnp.stack(
        [ndc_x, ndc_y, jnp.full_like(ndc_x, 0.5), jnp.ones_like(ndc_x)], axis=-1
    )
    world_h = mx.matmul(d_h, inv_vp.T)
    den = world_h[:, 3:4]
    inv = jnp.where(jnp.abs(den) > 1e-10, 1.0 / jnp.where(den == 0, 1.0, den), 0.0)
    dirs = mx.normalize(world_h[:, :3] * inv - cam.position[None, :])
    sky = sample_equirect(scene.env_map, dirs) * scene.env_brightness * cam.exposure

    # Reproject the direction with the previous view-proj for sky velocity.
    far_point = cam.position[None, :] + dirs * 1e4
    prev_clip = mx.transform_points_h(cam.prev_view_proj, far_point)
    pw = prev_clip[:, 3]
    inv_pw = jnp.where(jnp.abs(pw) > 1e-8, 1.0 / jnp.where(pw == 0, 1.0, pw), 0.0)
    prev_sx = (prev_clip[:, 0] * inv_pw * 0.5 + 0.5) * width
    prev_sy = (0.5 - prev_clip[:, 1] * inv_pw * 0.5) * height
    sky_vel = jnp.stack([px - prev_sx, py - prev_sy], axis=-1)

    out = jnp.where(valid[:, None], color, sky)
    return out, sky_vel
