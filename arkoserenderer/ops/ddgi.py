"""DDGI — dynamic diffuse global illumination probe grid.

Role-equivalent to the reference's DDGINode + shaders
(arkose/rendering/nodes/DDGINode.cpp:37-281, shaders/ddgi/{raygen.rgen,
probeUpdateIrradiance.comp, probeUpdateVisibility.comp, probeSampling.glsl},
consts in shaders/shared/DDGIData.h: 8x8 octahedral irradiance texels and
16x16 visibility (mean/mean^2 depth) texels per probe): a world-space probe
grid is updated a few probes per frame (round-robin amortization,
DDGINode.cpp:138-141) by tracing ray batches through the scene BVH, shading
hits with direct sun light + albedo (plus the previous frame's DDGI sample
for infinite bounces), and blending the octahedral atlases with hysteresis.
Sampling uses trilinear probe interpolation with normal-facing weights and a
Chebyshev visibility (variance shadow) test.

Array mapping: the atlases are persistent (P, R, R, C) arrays; a
probe-update step is one fused program — ray batch (n_update x rays) through
ops/bvh.trace_rays, then dense (texels x rays) cosine-weight matrix products
for the atlas estimates.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.halton import fibonacci_sphere
from arkoserenderer.ops import brdf as brdf_ops
from arkoserenderer.ops.bvh import trace_rays
from arkoserenderer.ops.envmap import sample_equirect

IRRADIANCE_RES = 8   # matches DDGI_IRRADIANCE_RES (DDGIData.h:4)
VISIBILITY_RES = 16  # matches DDGI_VISIBILITY_RES (DDGIData.h:5)
# Precision of the probe update's weighted sums over rays. The texel-ray
# cosines always run in full float32: the visibility weight raises them to
# the 50th power, which multiplies their relative error by 50. The sums
# stay in full float32 too: on an H100 (chip_smoke.py, 1,024 probes x 256
# rays) the default precision (TF32) put the irradiance 1.2e-4 and the
# mean visibility distance 4.2e-4 off float64, HIGHEST 7e-7 and 8e-7, and
# the sums are about 0.4 GFLOP a frame, a few microseconds at float32 rate.
WEIGHT_PRECISION = mx.HIGHEST


@dataclasses.dataclass(frozen=True)
class ProbeGridConfig:
    """Static grid layout (arkcore/scene/ProbeGrid analogue)."""

    dims: tuple[int, int, int] = (8, 4, 8)
    origin: tuple[float, float, float] = (-8.0, 0.0, -8.0)
    spacing: tuple[float, float, float] = (2.0, 2.0, 2.0)
    rays_per_probe: int = 128      # reference slider range 128-512
    probes_per_frame: int = 64     # amortization budget
    hysteresis: float = 0.94
    max_distance: float = 8.0      # visibility depth clamp
    normal_bias: float = 0.15
    energy_conservation: float = 0.95

    @property
    def num_probes(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @classmethod
    def fit_bounds(cls, center, radius, dims=(8, 4, 8), **kw):
        """Fit the grid to a scene bounding sphere (Scene::generateProbeGrid
        analogue)."""
        center = np.asarray(center, np.float32)
        half = radius * 1.05
        size = np.array([2 * half, 2 * half, 2 * half], np.float32)
        spacing = size / np.maximum(np.array(dims) - 1, 1)
        origin = center - size * 0.5
        return cls(
            dims=tuple(dims), origin=tuple(origin.tolist()),
            spacing=tuple(spacing.tolist()),
            max_distance=float(np.max(spacing) * 1.5), **kw,
        )


class DDGIState(NamedTuple):
    irradiance: jax.Array  # (P, 8, 8, 3) pre-exposed radiance estimate
    visibility: jax.Array  # (P, 16, 16, 2) mean / mean^2 ray distance
    offsets: jax.Array     # (P, 3) probe relocation offsets (world units)


def init_state(cfg: ProbeGridConfig) -> DDGIState:
    p = cfg.num_probes
    return DDGIState(
        irradiance=jnp.asarray(np.zeros((p, IRRADIANCE_RES, IRRADIANCE_RES, 3), np.float32)),
        visibility=jnp.asarray(
            np.full((p, VISIBILITY_RES, VISIBILITY_RES, 2), cfg.max_distance, np.float32)
            * np.array([1.0, cfg.max_distance], np.float32)
        ),
        offsets=jnp.asarray(np.zeros((p, 3), np.float32)),
    )


def probe_positions(cfg: ProbeGridConfig) -> np.ndarray:
    gx, gy, gz = cfg.dims
    xs = np.arange(gx) * cfg.spacing[0] + cfg.origin[0]
    ys = np.arange(gy) * cfg.spacing[1] + cfg.origin[1]
    zs = np.arange(gz) * cfg.spacing[2] + cfg.origin[2]
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
    return g.reshape(-1, 3).astype(np.float32)  # probe id = (x * gy + y) * gz + z


# ---------------------------------------------------------------------------
# Octahedral mapping (common/octahedral.glsl analogue)


def octahedral_decode(uv: jax.Array) -> jax.Array:
    """[0,1]^2 texel coords -> unit direction."""
    f = uv * 2.0 - 1.0
    z = 1.0 - jnp.abs(f[..., 0]) - jnp.abs(f[..., 1])
    t = jnp.clip(-z, 0.0, 1.0)
    x = f[..., 0] + jnp.where(f[..., 0] >= 0.0, -t, t)
    y = f[..., 1] + jnp.where(f[..., 1] >= 0.0, -t, t)
    return mx.normalize(jnp.stack([x, y, z], axis=-1))


def octahedral_encode(d: jax.Array) -> jax.Array:
    """Unit direction -> [0,1]^2."""
    n = d / jnp.sum(jnp.abs(d), axis=-1, keepdims=True)
    xy = n[..., :2]
    wrap = (1.0 - jnp.abs(xy[..., ::-1])) * jnp.where(xy >= 0.0, 1.0, -1.0)
    xy = jnp.where(n[..., 2:3] < 0.0, wrap, xy)
    return xy * 0.5 + 0.5


def _texel_dirs(res: int) -> np.ndarray:
    """(res*res, 3) directions at octahedral texel centers."""
    uv = (np.stack(np.meshgrid(np.arange(res), np.arange(res), indexing="xy"), -1)
          .reshape(-1, 2).astype(np.float32) + 0.5) / res
    f = uv * 2.0 - 1.0
    z = 1.0 - np.abs(f[:, 0]) - np.abs(f[:, 1])
    t = np.clip(-z, 0.0, 1.0)
    x = f[:, 0] + np.where(f[:, 0] >= 0.0, -t, t)
    y = f[:, 1] + np.where(f[:, 1] >= 0.0, -t, t)
    d = np.stack([x, y, z], -1)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# Probe update (raygen + probeUpdate* kernels in one fused step)


def probe_estimates(dirs, radiance, dist, precision=WEIGHT_PRECISION):
    """One frame's per-probe estimates from its rays: (R, 3) ray directions,
    (n, R, 3) radiance and (n, R) hit distances -> irradiance (n, 8, 8, 3)
    and visibility moments (n, 16, 16, 2), as (texels x rays) products."""
    n = radiance.shape[0]
    # -- irradiance estimate: cosine-weighted sums --------------------------
    tex_dirs_i = jnp.asarray(_texel_dirs(IRRADIANCE_RES))       # (64, 3)
    w_i = jnp.maximum(mx.matmul(tex_dirs_i, dirs.T), 0.0)       # (64, R)
    irr_num = jnp.einsum("tr,nrc->ntc", w_i, radiance, precision=precision)
    irr_den = jnp.sum(w_i, axis=1)[None, :, None]
    irr = (irr_num / jnp.maximum(irr_den, 1e-4)).reshape(
        n, IRRADIANCE_RES, IRRADIANCE_RES, 3
    )
    # -- visibility (mean / mean^2 distance, sharp weighting) ---------------
    tex_dirs_v = jnp.asarray(_texel_dirs(VISIBILITY_RES))       # (256, 3)
    w_v = jnp.maximum(mx.matmul(tex_dirs_v, dirs.T), 0.0) ** 50.0  # (256, R)
    v_den = jnp.maximum(jnp.sum(w_v, axis=1), 1e-6)[None, :]
    mean = jnp.einsum("tr,nr->nt", w_v, dist, precision=precision) / v_den
    mean2 = jnp.einsum("tr,nr->nt", w_v, dist * dist,
                       precision=precision) / v_den
    vis = jnp.stack([mean, mean2], axis=-1).reshape(
        n, VISIBILITY_RES, VISIBILITY_RES, 2
    )
    return irr, vis


def update_probes(
    scene,                       # SceneArrays (with a real BVH)
    state: DDGIState,
    cfg: ProbeGridConfig,
    frame_index: jax.Array,      # () i32 — drives round-robin + ray rotation
    exposure: jax.Array,
    prev_state: DDGIState | None = None,
    n_spots: int = 0,            # static local-light counts: probe rays see
    n_points: int = 0,           # the same lights the raster frame does
    spot_casters: tuple = (),
    point_casters: tuple = (),
) -> DDGIState:
    p = cfg.num_probes
    n_up = min(cfg.probes_per_frame, p)
    r = cfg.rays_per_probe
    prev = prev_state or state

    base = (frame_index * n_up) % p
    probe_ids = (base + jnp.arange(n_up, dtype=jnp.int32)) % p
    pos = (
        jnp.asarray(probe_positions(cfg))[probe_ids]
        + state.offsets[probe_ids]
    )                                                          # (n_up, 3)

    # Per-frame random rotation of the fibonacci ray set (amortized noise).
    key = jax.random.fold_in(jax.random.PRNGKey(7), frame_index)
    q = jax.random.normal(key, (4,))
    q = q / jnp.linalg.norm(q)
    dirs0 = jnp.asarray(fibonacci_sphere(r))                    # (R, 3)
    dirs = mx.quat_rotate(q[None, :], dirs0)                    # (R, 3)

    origins = jnp.repeat(pos, r, axis=0)                        # (n_up*R, 3)
    ray_dirs = jnp.tile(dirs, (n_up, 1))
    n_rays = origins.shape[0]
    chunk = 1 << 13 if n_rays >= (1 << 15) else None
    hit = trace_rays(scene.bvh, origins, ray_dirs, t_max=1e4,
                     chunk_size=chunk)

    # -- shade hits (ddgi/raygen.rgen analogue, diffuse-only) -----------------
    tri = jnp.maximum(hit.tri, 0)
    corners = scene.indices[tri]
    inst = scene.tri_instance[tri]
    bary = jnp.stack([1.0 - hit.u - hit.v, hit.u, hit.v], axis=-1)
    hi = mx.HIGHEST
    obj_pos = jnp.einsum("rk,rkc->rc", bary, scene.positions[corners],
                         precision=hi)
    w_m = scene.world[inst]
    world_pos = jnp.einsum("rij,rj->ri", w_m[:, :3, :3], obj_pos,
                           precision=hi) + w_m[:, :3, 3]
    obj_nrm = jnp.einsum("rk,rkc->rc", bary, scene.normals[corners],
                         precision=hi)
    nrm = mx.normalize(jnp.einsum("rij,rj->ri", scene.normal_mat[inst], obj_nrm,
                                  precision=hi))
    backface = hit.hit & (mx.vdot(nrm, -ray_dirs, keepdims=False) < 0.0)
    nrm = nrm * jnp.where(mx.vdot(nrm, -ray_dirs) < 0.0, -1.0, 1.0)

    mat_id = scene.inst_material[inst]
    albedo = scene.materials.base_color_factor[mat_id][:, :3]

    sun_l = -scene.lights.sun_direction
    # Missed probe rays need no sun-occlusion ray: park them outside the
    # scene (capped t_max exits their slab test in one step).
    shadow = trace_rays(
        scene.bvh, jnp.where(hit.hit[:, None], world_pos + nrm * 1e-2, -1e7),
        jnp.broadcast_to(sun_l, world_pos.shape), any_hit=True, t_max=1e4,
        chunk_size=chunk,
    )
    n_dot_l = jnp.clip(mx.vdot(nrm, sun_l[None, :], keepdims=False), 0.0, 1.0)
    direct = (
        albedo / jnp.pi
        * (scene.lights.sun_color * exposure)[None, :]
        * (n_dot_l * (~shadow.hit))[:, None]
        * scene.lights.sun_valid
    )
    # Local lights at probe-ray hits (diffuse-only, same cone/IES/1-over-d2
    # radiometry as the raster loop): spot/point-lit interiors bounce their
    # light through DDGI like sun-lit ones. Occlusion rays for casters;
    # primary misses stay parked.
    shadow_org = jnp.where(hit.hit[:, None], world_pos + nrm * 1e-2, -1e7)
    for li in range(n_spots):
        to_l = scene.lights.spot_pos[li][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        dist_l = jnp.sqrt(dist2)
        l_dir = to_l / dist_l
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
                scene.bvh, shadow_org, l_dir,
                t_max=jnp.maximum(dist_l[:, 0] - 6e-2, 1e-3),
                any_hit=True, chunk_size=chunk,
            )
            falloff = falloff * (~occ_l.hit)
        nl = jnp.clip(mx.vdot(nrm, l_dir, keepdims=False), 0.0, 1.0)
        direct = direct + albedo / jnp.pi * (
            scene.lights.spot_color[li][None, :] * exposure
        ) * (nl * falloff)[:, None]
    for li in range(n_points):
        to_l = scene.lights.point_pos[li][None, :] - world_pos
        dist2 = jnp.maximum(mx.vdot(to_l, to_l), 1e-6)
        dist_l = jnp.sqrt(dist2)
        l_dir = to_l / dist_l
        vis_l = 1.0
        if li < len(point_casters) and point_casters[li]:
            occ_l = trace_rays(
                scene.bvh, shadow_org, l_dir,
                t_max=jnp.maximum(dist_l[:, 0] - 6e-2, 1e-3),
                any_hit=True, chunk_size=chunk,
            )
            vis_l = (~occ_l.hit).astype(jnp.float32)
        nl = jnp.clip(mx.vdot(nrm, l_dir, keepdims=False), 0.0, 1.0)
        direct = direct + albedo / jnp.pi * (
            scene.lights.point_color[li][None, :] * exposure
        ) * (nl * vis_l)[:, None] / dist2

    # Infinite bounces: sample last frame's DDGI at the hit point.
    bounce = sample_irradiance(prev, cfg, world_pos, nrm) * albedo / jnp.pi
    radiance = direct + bounce * cfg.energy_conservation

    env = sample_equirect(scene.env_map, ray_dirs) * scene.env_brightness * exposure
    radiance = jnp.where(hit.hit[:, None], radiance, env)      # (n_up*R, 3)
    radiance = radiance.reshape(n_up, r, 3)

    dist = jnp.where(hit.hit, hit.t, cfg.max_distance)
    dist = jnp.clip(dist, 0.0, cfg.max_distance).reshape(n_up, r)

    irr_new, vis_new = probe_estimates(dirs, radiance, dist)

    # -- hysteresis blend into the atlases (scatter on probe rows) --------------
    h = cfg.hysteresis
    old_irr = state.irradiance[probe_ids]
    old_vis = state.visibility[probe_ids]
    first = jnp.all(old_irr == 0.0)  # cold start: take the new estimate
    alpha = jnp.where(first, 1.0, 1.0 - h)
    irr = state.irradiance.at[probe_ids].set(old_irr + (irr_new - old_irr) * alpha)
    vis = state.visibility.at[probe_ids].set(old_vis + (vis_new - old_vis) * alpha)

    # -- probe relocation (RTXGI-style, the reference's DDGI probe-offset
    # pass): a probe seeing many backfaces sits inside geometry — push it
    # along its closest backface ray to just past that surface. Offsets are
    # clamped to a fraction of the grid spacing so sampling weights stay
    # meaningful.
    bf = backface.reshape(n_up, r)
    bf_frac = bf.mean(axis=1)                                      # (n_up,)
    t_all = jnp.where(bf, hit.t.reshape(n_up, r), cfg.max_distance)
    closest = jnp.argmin(t_all, axis=1)                            # (n_up,)
    t_min = jnp.take_along_axis(t_all, closest[:, None], axis=1)[:, 0]
    esc_dir = dirs[closest]                                        # (n_up, 3)
    spacing = jnp.asarray(np.array(cfg.spacing, np.float32))
    min_space = float(np.min(cfg.spacing))
    delta = esc_dir * (t_min + 0.15 * min_space)[:, None]
    old_off = state.offsets[probe_ids]
    new_off = jnp.where((bf_frac > 0.25)[:, None], old_off + delta, old_off)
    new_off = jnp.clip(new_off, -0.45 * spacing, 0.45 * spacing)
    offsets = state.offsets.at[probe_ids].set(new_off)
    return DDGIState(irradiance=irr, visibility=vis, offsets=offsets)


# ---------------------------------------------------------------------------
# Sampling (probeSampling.glsl analogue)


def _oct_wrap(xi: jax.Array, yi: jax.Array, res: int):
    """Octahedral seam wrap for tap indices one texel out of [0, res).

    The square's edges are glued to themselves by the octahedral fold
    (edge point (u<0, v) == (-u, 1-v), etc.), so an out-of-bounds tap
    reflects across its edge AND flips the other axis; a corner tap lands
    on the diagonally opposite corner. This is the filtering-correct
    equivalent of the reference's DDGI border-texel duplication
    (updateProbeBorders in the DDGI compute, gutter texels copied with
    exactly this mapping) — we wrap at sample time instead of storing a
    gutter."""
    out_l = xi < 0
    out_r = xi >= res
    yi = jnp.where(out_l | out_r, res - 1 - yi, yi)
    xi = jnp.where(out_l, -1 - xi, jnp.where(out_r, 2 * res - 1 - xi, xi))
    out_b = yi < 0
    out_t = yi >= res
    xi = jnp.where(out_b | out_t, res - 1 - xi, xi)
    yi = jnp.where(out_b, -1 - yi, jnp.where(out_t, 2 * res - 1 - yi, yi))
    return xi, yi


def _bilinear_atlas(atlas: jax.Array, probe: jax.Array, uv: jax.Array) -> jax.Array:
    """(P, R, R, C) atlas, (N,) probe ids, (N,2) octahedral uv -> (N,C),
    bilinear with octahedral seam wrap across tile edges."""
    res = atlas.shape[1]
    c = atlas.shape[-1]
    x = uv[:, 0] * res - 0.5
    y = uv[:, 1] * res - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    flat = atlas.reshape(-1, c)
    base = probe * res * res

    def tap(xi, yi):
        xw, yw = _oct_wrap(xi, yi, res)
        return flat[base + yw * res + xw]

    c00 = tap(x0i, y0i)
    c10 = tap(x0i + 1, y0i)
    c01 = tap(x0i, y0i + 1)
    c11 = tap(x0i + 1, y0i + 1)
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def sample_irradiance(
    state: DDGIState,
    cfg: ProbeGridConfig,
    world_pos: jax.Array,   # (N, 3)
    normal: jax.Array,      # (N, 3)
) -> jax.Array:
    """Trilinear 8-probe blend with normal-facing + Chebyshev weights."""
    gx, gy, gz = cfg.dims
    origin = jnp.asarray(np.array(cfg.origin, np.float32))
    spacing = jnp.asarray(np.array(cfg.spacing, np.float32))
    biased = world_pos + normal * cfg.normal_bias

    g = (biased - origin) / spacing
    g = jnp.clip(g, 0.0, jnp.asarray(np.array(cfg.dims, np.float32) - 1.0 - 1e-4))
    g0 = jnp.floor(g).astype(jnp.int32)
    f = g - g0

    uv = octahedral_encode(normal)
    total = jnp.zeros((world_pos.shape[0], 3))
    total_w = jnp.zeros((world_pos.shape[0], 1))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cx = jnp.minimum(g0[:, 0] + dx, gx - 1)
                cy = jnp.minimum(g0[:, 1] + dy, gy - 1)
                cz = jnp.minimum(g0[:, 2] + dz, gz - 1)
                probe = (cx * gy + cy) * gz + cz
                probe_pos = (
                    origin + jnp.stack([cx, cy, cz], -1) * spacing
                    + state.offsets[probe]
                )
                to_probe = probe_pos - world_pos
                dist = jnp.linalg.norm(to_probe, axis=-1)
                dir_p = to_probe / jnp.maximum(dist, 1e-6)[:, None]

                tw = (
                    (dx * f[:, 0] + (1 - dx) * (1 - f[:, 0]))
                    * (dy * f[:, 1] + (1 - dy) * (1 - f[:, 1]))
                    * (dz * f[:, 2] + (1 - dz) * (1 - f[:, 2]))
                )
                # Back-face probe rejection (smooth).
                facing = jnp.clip(
                    mx.vdot(dir_p, normal, keepdims=False) * 0.5 + 0.5, 0.0, 1.0
                ) ** 2 + 0.05
                # Chebyshev visibility from the probe's depth statistics.
                vuv = octahedral_encode(-dir_p)
                mv = _bilinear_atlas(state.visibility, probe, vuv)
                mean, mean2 = mv[:, 0], mv[:, 1]
                var = jnp.maximum(mean2 - mean * mean, 1e-4)
                d = jnp.maximum(dist - mean, 0.0)
                cheb = var / (var + d * d)
                vis_w = jnp.where(dist <= mean, 1.0, jnp.clip(cheb ** 3, 0.05, 1.0))

                w = (tw * facing * vis_w)[:, None]
                irr = _bilinear_atlas(state.irradiance, probe, uv)
                total = total + irr * w
                total_w = total_w + w
    return total / jnp.maximum(total_w, 1e-4)
