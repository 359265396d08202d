"""Packed-record deferred shading — the fast path.

Same role as ops/shading.shade_visibility_buffer (the reference's
VisibilityBufferShadingNode + shadeVisibilityBuffer.comp:1-278), restructured
for gather latency: a per-pixel random access costs about the same
regardless of row width, and the reference-style shading front-end issues
~25-30 of them (vertex indices, three attribute pools, three matrix tables,
a dozen material fields, texture metadata...).

The fix: fold EVERYTHING a pixel needs into one per-triangle record row at
geometry time (per-triangle work is 30x cheaper than per-pixel), so shading
issues exactly ONE per-pixel row gather for geometry + material + texture
metadata, plus the texel taps themselves (ops/mattex: one row per tap for
ALL material channels) and one prefiltered shadow tap (ops/shadow VSM).

Per-pixel random-access budget of a full PBR frame: 1 record gather +
4-8 packed texel taps + 4 shadow moment taps ~= 9-13 row gathers, versus
~30-60 scalar gathers in the reference-style path. Everything else is
fused elementwise arithmetic.

Record layout (rec_size f32 lanes per raster setup row, PERMUTED per scene
— see RecLayout; full = 88 lanes, static-no-normal-map = 64):
  [0:6)   screen xy of the 3 corners        (raster setup, sub-triangle)
  [6:9)   1/w_clip per corner
  then    3 corners x c_stride lanes: wpos(3) [prev_wpos(3)] wnrm(3)
          [wtan(3) tanw(1)] uv(2) — already corner_bary-folded, i.e. these
          are the SUB-triangle corners, so per-pixel sub-barycentrics apply
          directly (near clipping is invisible here, like ops/interpolate)
  then    material record (MREC, 32 lanes), then pad to a multiple of 8

Material record (built once per scene in Scene.build):
  [0:4) base_color_factor  [4:7) emissive_factor  [7] metallic  [8] roughness
  [9] double_sided  [10] clearcoat  [11] clearcoat_roughness  [12] subsurface
  [13] alpha_cutoff  [14] blend_mode
  [15:32) packed-texture meta: wrap, w0, h0, n_mips, mip_offsets*13
          (ops/mattex.META_LANES)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import brdf
from arkoserenderer.ops import mattex
from arkoserenderer.ops.interpolate import _persp_bary
from arkoserenderer.ops.raster import TriSetup
from arkoserenderer.ops.shading import GBuffer
from arkoserenderer.ops.shadow import sample_shadow_pcf, sample_vsm

MREC_SIZE = 32

# Profiling ablation knobs (perf-attribution scripts only):
# "const_rec"    broadcast record row 0 (kills the per-pixel gather)
# "uniform_rec"  gather row 0 everywhere (keeps the gather, kills divergence)
# "no_tex"       skip texture taps
# "no_shadow"    skip sun-shadow sampling
_ABLATE: set = set()

# Material record lane constants live below; geometry lanes are described
# by RecLayout (permutation-dependent).


class RecLayout(NamedTuple):
    """Compile-time record layout permutation (the DrawKey analogue for the
    shading record): static scenes drop the prev-position lanes (velocity
    reprojects the CURRENT world position through last frame's camera —
    identical result when geometry doesn't move), and scenes without normal
    maps drop the tangent lanes. The per-pixel record gather scales with
    row bytes, so fewer lanes = less shading traffic, chosen per scene at
    construct time like the reference's shader permutations."""

    has_prev: bool
    has_tan: bool
    c_stride: int
    rec_size: int
    # corner-relative lane offsets (prev/tan = -1 when absent)
    o_prev: int
    o_nrm: int
    o_tan: int
    o_uv: int


def record_layout_for(scene_static) -> RecLayout:
    """Layout from SceneStatic flags (single source for all passes)."""
    any_tex = (
        scene_static.uses_base_tex or scene_static.uses_normal_tex
        or scene_static.uses_mr_tex or scene_static.uses_emissive_tex
        or scene_static.uses_occlusion_tex
    )
    return record_layout(scene_static, any_tex)


def record_layout(scene_static=None, any_tex: bool = True) -> RecLayout:
    """Layout for a scene: full 96-lane when everything is on."""
    has_prev = True
    has_tan = True
    if scene_static is not None:
        has_prev = bool(
            getattr(scene_static, "dynamic", True)
            or scene_static.has_skin or scene_static.has_morphs
            or scene_static.has_hair
        )
        has_tan = bool(any_tex and scene_static.uses_normal_tex)
    o = 3                                   # wpos
    o_prev = o if has_prev else -1
    o += 3 if has_prev else 0
    o_nrm = o
    o += 3
    o_tan = o if has_tan else -1
    o += 4 if has_tan else 0
    o_uv = o
    o += 2
    c_stride = o
    base = 9 + 3 * c_stride + MREC_SIZE     # screen(6) + inv_w(3) + corners + mrec
    rec_size = (base + 7) // 8 * 8
    return RecLayout(has_prev, has_tan, c_stride, rec_size,
                     o_prev, o_nrm, o_tan, o_uv)

# Material record lanes
M_BASEF, M_EMIF, M_METAL, M_ROUGH = 0, 4, 7, 8
M_DSIDED, M_CC, M_CCR, M_SSS, M_CUTOFF, M_BLEND = 9, 10, 11, 12, 13, 14
M_TEXMETA = 15  # + mattex.META_LANES = 32


def build_vertex_world(scene, positions, normals, tangents,
                       layout: RecLayout | None = None) -> jax.Array:
    """Per-vertex packed WORLD-space pool (V, c_stride):
    [wpos3, (prev_wpos3), wnrm3, (wtan3, tanw), uv2] per ``layout``
    (full 16-lane layout + pad when None).

    One instance-matrix row gather per vertex (the per-instance matrices are
    packed into a single (D, 33) table first — elementwise), then pure
    einsum. This replaces the reference-style per-PIXEL matrix gathers."""
    if layout is None:
        layout = record_layout()
    d = scene.world.shape[0]
    parts_m = [scene.world[:, :3, :].reshape(d, 12)]
    if layout.has_prev:
        parts_m.append(scene.prev_world[:, :3, :].reshape(d, 12))
    parts_m.append(scene.normal_mat.reshape(d, 9))
    m_pack = jnp.concatenate(parts_m, axis=-1)
    m = m_pack[scene.vertex_instance]  # (V, ...) — ONE row gather at V lanes
    w_rot = m[:, 0:12].reshape(-1, 3, 4)
    off = 12
    if layout.has_prev:
        p_rot = m[:, off:off + 12].reshape(-1, 3, 4)
        off += 12
    n_rot = m[:, off:off + 9].reshape(-1, 3, 3)

    def apply34(rot, p, translate=True):
        # Broadcast mul-adds over the V axis: they fuse, where a batched
        # einsum is a matrix product with a layout of its own.
        return jnp.stack(
            [
                rot[:, r, 0] * p[:, 0] + rot[:, r, 1] * p[:, 1]
                + rot[:, r, 2] * p[:, 2]
                + (rot[:, r, 3] if translate else 0.0)
                for r in range(3)
            ],
            axis=-1,
        )

    wpos = apply34(w_rot, positions)
    wnrm = mx.normalize(apply34(n_rot, normals, translate=False))
    parts = [wpos]
    if layout.has_prev:
        ppos = apply34(p_rot, positions)
        parts.append(ppos)
    parts.append(wnrm)
    if layout.has_tan:
        wtan = mx.normalize(apply34(w_rot, tangents[:, :3], translate=False))
        parts.append(wtan)
        parts.append(tangents[:, 3:4])
    parts.append(scene.uvs)
    return jnp.concatenate(parts, axis=-1)   # (V, layout.c_stride)


def build_records(
    setup: TriSetup,
    vtx_world: jax.Array,    # (V, c_stride)
    indices: jax.Array,      # (Tmax, 3)
    tri_material: jax.Array, # (Tmax,) i32
    mat_records: jax.Array,  # (M, 32)
    layout: RecLayout | None = None,
) -> jax.Array:
    """(T', layout.rec_size) shading records, one per raster setup row.

    Gather chain (at triangle lanes — 30x cheaper than pixel lanes):
    indices[orig] -> vtx_world[corners]; tri_material[orig] ->
    mat_records[mat]. corner_bary is folded in here so the record's corners
    ARE the clipped sub-triangle's corners."""
    if layout is None:
        layout = record_layout()
    cs = vtx_world.shape[-1]
    t = setup.orig_tri.shape[0]
    corners = indices[setup.orig_tri]            # (T', 3)
    vtx = vtx_world[corners]                     # (T', 3, cs)
    cb = setup.corner_bary                       # (T', 3, 3)
    sub = (                                      # fold clipping, elementwise
        cb[:, :, 0:1] * vtx[:, None, 0, :]
        + cb[:, :, 1:2] * vtx[:, None, 1, :]
        + cb[:, :, 2:3] * vtx[:, None, 2, :]
    )
    mrec = mat_records[tri_material[setup.orig_tri]]          # (T', 32)
    base = 9 + 3 * cs + MREC_SIZE
    rec = jnp.concatenate(
        [
            setup.screen_xy.reshape(t, 6),
            setup.inv_w,
            sub.reshape(t, 3 * cs),
            mrec,
            jnp.zeros((t, layout.rec_size - base), jnp.float32),
        ],
        axis=-1,
    )
    return rec


def shade_packed(
    scene,
    cam,
    vis_flat: jax.Array,     # (N,) setup-row ids (VIS_NONE background)
    depth_flat: jax.Array,   # (N,)
    records: jax.Array,      # (T', layout.rec_size)
    px: jax.Array,
    py: jax.Array,
    width: int,
    height: int,
    shadow_moments: jax.Array | None = None,   # (S, S, 2) sun VSM
    sun_shadow_vp: jax.Array | None = None,
    shadow_mask: jax.Array | None = None,      # (N,) RT mask wins
    local_shadow_maps: jax.Array | None = None,
    spot_shadow_flags: tuple | None = None,
    rt_spot_masks: jax.Array | None = None,    # (S, N) RT local masks win
    rt_point_masks: jax.Array | None = None,   # (P, N)
    n_spots: int = 0,
    n_points: int = 0,
    any_tex: bool = True,
    texture_quality: str = "trilinear",
    shadow_filter: str = "bilinear",       # | "stochastic" (1 tap + TAA)
    frame_index: jax.Array | None = None,  # for stochastic filtering noise
    mip_bias: float = 0.0,                 # DLSS-style bias when upscaling
    layout: RecLayout | None = None,
) -> GBuffer:
    if layout is None:
        layout = record_layout()
    cs = layout.c_stride
    valid = vis_flat >= 0
    row = jnp.maximum(vis_flat, 0)
    if "const_rec" in _ABLATE:
        rec = jnp.broadcast_to(records[0], (vis_flat.shape[0], records.shape[1]))
    elif "uniform_rec" in _ABLATE:
        rec = records[row * 0]
    else:
        rec = records[row]     # (N, rec_size) — THE per-pixel gather
    if "no_tex" in _ABLATE:
        any_tex = False
    n = px.shape[0]
    exposure = cam.exposure

    # FLAT-LANE front-end: everything below slices the gathered rows 2-D
    # only, with broadcast mul-adds — no einsum/dot and no (n, 3, k)
    # reshapes, which can become physical copies of the record array. The
    # whole shading front-end fuses into one pass over the gather output.
    ax, ay = rec[:, 0], rec[:, 1]
    bx, by = rec[:, 2], rec[:, 3]
    cx, cy = rec[:, 4], rec[:, 5]
    iw0, iw1, iw2 = rec[:, 6], rec[:, 7], rec[:, 8]

    def edge(px_, py_, ox, oy, ex_, ey_):
        return (ey_ - oy) * (px_ - ox) - (ex_ - ox) * (py_ - oy)

    e0 = edge(px, py, bx, by, cx, cy)
    e1 = edge(px, py, cx, cy, ax, ay)
    e2 = edge(px, py, ax, ay, bx, by)
    # Edge functions are affine in (px, py): +1px deltas are per-triangle
    # constants, so the derivative barycentrics cost 6 adds, not 6 edges.
    d0x, d0y = cy - by, -(cx - bx)
    d1x, d1y = ay - cy, -(ax - cx)
    d2x, d2y = by - ay, -(bx - ax)

    def bary_of(f0, f1, f2):
        p0, p1, p2 = f0 * iw0, f1 * iw1, f2 * iw2
        den = p0 + p1 + p2
        inv = jnp.where(
            jnp.abs(den) > 1e-20, 1.0 / jnp.where(den == 0, 1.0, den), 0.0
        )
        return p0 * inv, p1 * inv, p2 * inv

    b0, b1, b2 = bary_of(e0, e1, e2)
    bx0, bx1, bx2 = bary_of(e0 + d0x, e1 + d1x, e2 + d2x)
    by0, by1, by2 = bary_of(e0 + d0y, e1 + d1y, e2 + d2y)

    def lane(j):  # interpolated attribute lane j (corner stride cs)
        return (
            b0 * rec[:, 9 + j] + b1 * rec[:, 9 + cs + j]
            + b2 * rec[:, 9 + 2 * cs + j]
        )

    def lanes3(j):
        return jnp.stack([lane(j), lane(j + 1), lane(j + 2)], axis=-1)

    mo = 9 + 3 * cs
    mrec = rec[:, mo : mo + MREC_SIZE]

    world_pos = lanes3(0)
    prev_world_pos = (
        lanes3(layout.o_prev) if layout.has_prev
        else world_pos   # static scene: nothing moved
    )
    world_nrm = mx.normalize(lanes3(layout.o_nrm))
    if layout.has_tan:
        world_tan = mx.normalize(lanes3(layout.o_tan))
        tanw = lane(layout.o_tan + 3)[:, None]
    else:
        world_tan = world_nrm   # unused (no normal mapping without tangents)
        tanw = jnp.ones((n, 1))
    ju = layout.o_uv
    u_c0, u_c1, u_c2 = rec[:, 9 + ju], rec[:, 9 + cs + ju], rec[:, 9 + 2 * cs + ju]
    v_c0, v_c1, v_c2 = (
        rec[:, 9 + ju + 1], rec[:, 9 + cs + ju + 1], rec[:, 9 + 2 * cs + ju + 1]
    )
    uv_u = b0 * u_c0 + b1 * u_c1 + b2 * u_c2
    uv_v = b0 * v_c0 + b1 * v_c1 + b2 * v_c2
    uv = jnp.stack([uv_u, uv_v], axis=-1)
    duv_dx = jnp.stack(
        [
            (bx0 - b0) * u_c0 + (bx1 - b1) * u_c1 + (bx2 - b2) * u_c2,
            (bx0 - b0) * v_c0 + (bx1 - b1) * v_c1 + (bx2 - b2) * v_c2,
        ],
        axis=-1,
    )
    duv_dy = jnp.stack(
        [
            (by0 - b0) * u_c0 + (by1 - b1) * u_c1 + (by2 - b2) * u_c2,
            (by0 - b0) * v_c0 + (by1 - b1) * v_c1 + (by2 - b2) * v_c2,
        ],
        axis=-1,
    )

    base_factor = mrec[:, M_BASEF : M_BASEF + 4]
    emissive_factor = mrec[:, M_EMIF : M_EMIF + 3]
    metallic_f = mrec[:, M_METAL : M_METAL + 1]
    roughness_f = mrec[:, M_ROUGH : M_ROUGH + 1]
    double_sided = mrec[:, M_DSIDED] > 0.5
    clearcoat = mrec[:, M_CC : M_CC + 1]
    cc_rough = mrec[:, M_CCR : M_CCR + 1]
    subsurface = mrec[:, M_SSS]

    def pixel_noise(salt: int) -> jax.Array:
        # Per-pixel per-frame blue noise (tiled mask gather — ops/noise.py);
        # TAA averages stochastic single-tap estimators to their filtered
        # value, and the blue spectrum keeps single-frame error fine-grained.
        from arkoserenderer.ops.noise import sample_blue_noise

        return sample_blue_noise(px, py, frame_index, salt)

    if any_tex:
        if texture_quality == "stochastic1":
            noise = jnp.stack(
                [pixel_noise(0), pixel_noise(3), pixel_noise(4)], axis=-1
            )
        elif texture_quality == "stochastic":
            noise = pixel_noise(0)
        else:
            noise = None
        ms = mattex.sample_packed(
            scene.mat_tex.rows,
            mrec[:, M_TEXMETA : M_TEXMETA + mattex.META_LANES],
            uv, duv_dx, duv_dy, quality=texture_quality, noise=noise,
            lod_bias=mip_bias,
        )
        base_color = ms.base[:, :3] * base_factor[:, :3]
        roughness = jnp.clip(ms.rough_metal[:, 0:1] * roughness_f, 0.0, 1.0)
        metallic = jnp.clip(ms.rough_metal[:, 1:2] * metallic_f, 0.0, 1.0)
        emissive = ms.emissive * emissive_factor
        occlusion = ms.occlusion[:, None]
        if layout.has_tan:
            n_ts = ms.normal_ts
            bitan = jnp.cross(world_nrm, world_tan) * tanw
            shading_nrm = mx.normalize(
                n_ts[:, 0:1] * world_tan + n_ts[:, 1:2] * bitan
                + n_ts[:, 2:3] * world_nrm
            )
        else:
            shading_nrm = world_nrm
    else:
        base_color = base_factor[:, :3]
        roughness = jnp.clip(roughness_f, 0.0, 1.0)
        metallic = jnp.clip(metallic_f, 0.0, 1.0)
        emissive = emissive_factor
        occlusion = jnp.ones_like(roughness)
        shading_nrm = world_nrm

    view = mx.normalize(cam.position[None, :] - world_pos)
    facing = jnp.sign(mx.vdot(shading_nrm, view))
    flip = jnp.where(double_sided[:, None], facing, 1.0)
    shading_nrm = shading_nrm * jnp.where(flip == 0.0, 1.0, flip)

    # -- direct lighting (same math as ops/shading, VSM sun shadow) ------------
    color = emissive * exposure

    sun_l = -scene.lights.sun_direction[None, :]
    n_dot_l_geo = jnp.clip(mx.vdot(world_nrm, sun_l, keepdims=False), 0.0, 1.0)
    if shadow_mask is not None:
        shadow = shadow_mask
    elif shadow_moments is not None:
        noise2 = (
            jnp.stack([pixel_noise(1), pixel_noise(2)], axis=-1)
            if shadow_filter == "stochastic"
            else None
        )
        shadow = sample_vsm(
            shadow_moments, sun_shadow_vp, world_pos, n_dot_l_geo,
            taps=shadow_filter, noise2=noise2,
        )
    else:
        shadow = jnp.ones((n,))
    sun_fr = brdf.evaluate(
        jnp.broadcast_to(sun_l, (n, 3)), view, shading_nrm,
        base_color, roughness, metallic, clearcoat, cc_rough,
    )
    sun_radiance = scene.lights.sun_color[None, :] * exposure
    color = color + sun_fr * sun_radiance * shadow[:, None] * scene.lights.sun_valid

    for i in range(n_spots):
        to_l = scene.lights.spot_pos[i][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        l = to_l * jax.lax.rsqrt(dist2)
        cos_dir = -mx.vdot(l, scene.lights.spot_dir[i][None, :], keepdims=False)
        cone = scene.lights.spot_cone[i]
        t = jnp.clip((cos_dir - cone[1]) / jnp.maximum(cone[0] - cone[1], 1e-4), 0.0, 1.0)
        angle_idx = jnp.clip(
            (jnp.arccos(jnp.clip(cos_dir, -1.0, 1.0)) / jnp.pi * 255.0).astype(jnp.int32),
            0, 255,
        )
        ies = scene.lights.spot_ies[i][angle_idx]
        falloff = t * t * ies / dist2[:, 0]
        if rt_spot_masks is not None:
            # Exact RT local shadows (RTLocalShadowNode) replace PCF.
            falloff = falloff * rt_spot_masks[i]
        elif (
            local_shadow_maps is not None
            and spot_shadow_flags is not None
            and i < len(spot_shadow_flags)
            and spot_shadow_flags[i]
        ):
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
        vis_p = rt_point_masks[i][:, None] if rt_point_masks is not None else 1.0
        color = color + fr * (
            scene.lights.point_color[i][None, :] * exposure
        ) / dist2 * vis_p

    # -- velocity ---------------------------------------------------------------
    def to_screen(vp, p):
        # Elementwise transform, z row skipped (see transform_point_lanes).
        cx, cy, w_c = mx.transform_point_lanes(vp, p, rows=(0, 1, 3))
        inv = jnp.where(jnp.abs(w_c) > 1e-8, 1.0 / jnp.where(w_c == 0, 1.0, w_c), 0.0)
        sx = (cx * inv * 0.5 + 0.5) * width
        sy = (0.5 - cy * inv * 0.5) * height
        return jnp.stack([sx, sy], axis=-1)

    cur_s = to_screen(cam.unjittered_view_proj, world_pos)
    prev_s = to_screen(cam.prev_view_proj, prev_world_pos)
    velocity = cur_s - prev_s

    vf = valid[:, None]
    return GBuffer(
        color=jnp.where(vf, color, 0.0),
        normal=jnp.where(vf, shading_nrm, 0.0),
        velocity=jnp.where(vf, velocity, 0.0),
        base_color=jnp.where(vf, base_color, 0.0),
        material=jnp.where(
            vf,
            jnp.concatenate(
                [roughness, metallic, occlusion, subsurface[:, None]], axis=-1
            ),
            0.0,
        ),
        depth=depth_flat,
        valid=valid,
    )
