"""Channel-packed per-material textures — the fast texture path.

Motivation: a random gather over 2M pixel lanes is paid per gather more
than per value fetched, so the classic bindless pool (one gather per texel
per texture slot — up to 32 gathers for trilinear x 4 slots) is replaced by
ONE multi-channel texel row per tap:

    row = [ base RGBA8 | nx ny rough metal | em.r em.g em.b occl ]  (3 x u32)

All of a material's texture slots (MaterialAsset inputs: baseColor, normal,
metallicRoughness, emissive, occlusion — arkcore/asset/MaterialAsset.h:74+)
are resampled host-side to one power-of-two resolution and packed per texel,
so a bilinear material sample costs 4 row gathers TOTAL (8 for trilinear)
instead of 4 (8) PER SLOT. This is the bindless-texture analogue of the
reference's single material binding set (GpuScene bindless material set,
arkose/rendering/GpuScene.h:259-282) re-shaped for a gather-latency-bound
machine.

Materials sharing the same texture-id tuple share one packed entry (the
dedupe keeps glTF atlases from being duplicated per material).

Per-material metadata (mip offsets, base size, wrap) is NOT looked up per
pixel — it travels in the per-triangle shading record (ops/packed_shading)
so the only per-pixel random accesses are the texel taps themselves.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_MIPS = 13  # up to 4096^2 per packed material texture

# Packed-material metadata lanes (stored in the material record, see
# ops/packed_shading.MREC_* for the record layout).
META_LANES = 4 + MAX_MIPS  # wrap, w0, h0, n_mips, offsets[13]


class PackedTexturePool(NamedTuple):
    rows: jax.Array  # (capacity, 3) uint32 texel rows [base, nrm_mr, em_occ]


def _np_resize_bilinear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Host bilinear resize of (H0, W0, C) float/uint8 -> (h, w, C) float32."""
    img = img.astype(np.float32)
    h0, w0 = img.shape[:2]
    if (h0, w0) == (h, w):
        return img
    x = (np.arange(w) + 0.5) * (w0 / w) - 0.5
    y = (np.arange(h) + 0.5) * (h0 / h) - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w0 - 1)
    x1 = np.clip(x0 + 1, 0, w0 - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h0 - 1)
    y1 = np.clip(y0 + 1, 0, h0 - 1)
    fx = np.clip(x - x0, 0.0, 1.0)[None, :, None]
    fy = np.clip(y - y0, 0.0, 1.0)[:, None, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def _pow2_dims(w: int, h: int, cap: int = 2048) -> tuple[int, int]:
    def up(v):
        p = 1
        while p < v:
            p <<= 1
        return min(p, cap)

    return up(max(w, 1)), up(max(h, 1))


def _mip_chain(planes: np.ndarray) -> list[np.ndarray]:
    """(H, W, C) float32 -> list of mips (box filter, like ImageAsset
    generateMipmaps)."""
    mips = [planes]
    cur = planes
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(cur.shape[0] // 2, 1)
        w = max(cur.shape[1] // 2, 1)
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = cur.reshape(h, 2, w, 2, cur.shape[2]).mean(axis=(1, 3))
        elif cur.shape[0] > 1:
            cur = cur.reshape(h, 2, 1, cur.shape[2]).mean(axis=1)
        else:
            cur = cur.reshape(1, w, 2, cur.shape[2]).mean(axis=2)
        mips.append(cur)
    return mips[:MAX_MIPS]


def _pack_rows(p12: np.ndarray) -> np.ndarray:
    """(H, W, 12) float [0,255] -> (H*W, 3) uint32."""
    b = np.clip(p12 + 0.5, 0, 255).astype(np.uint32).reshape(-1, 3, 4)
    return (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24))


def pack_material_chain(m, images, cursor: int, wrap_default: int = 0):
    """Pack ONE material's texture chain starting at texel-row ``cursor``.

    Returns (rows (R, 3) uint32, meta_row (META_LANES,) f32, new_cursor).
    Shared by the build-time packer below and by TEXTURE STREAMING
    (Scene.stage_material): a streamed material's chain appends into the
    texel pool's capacity padding, so new textures reach the device through
    the same budgeted row uploads as geometry (GpuScene.cpp:483-553's
    async-texture finalization under an upload budget).
    """
    key = (
        int(m.base_color_tex), int(m.normal_tex), int(m.mr_tex),
        int(m.emissive_tex), int(m.occlusion_tex),
    )

    def img_of(tid, default_rgba):
        if 0 <= tid < len(images) and tid not in (0, 1, 2, 3):
            return images[tid][0]
        return np.array([[default_rgba]], np.uint8)

    base = img_of(key[0], [255, 255, 255, 255])
    nrm = img_of(key[1], [128, 128, 255, 255])
    mr = img_of(key[2], [255, 255, 255, 255])
    em = img_of(key[3], [255, 255, 255, 255])
    occ = img_of(key[4], [255, 255, 255, 255])

    w = max(i.shape[1] for i in (base, nrm, mr, em, occ))
    h = max(i.shape[0] for i in (base, nrm, mr, em, occ))
    w, h = _pow2_dims(w, h)
    wrap = (
        images[key[0]][2]
        if 0 <= key[0] < len(images) and key[0] > 3
        else wrap_default
    )

    b = _np_resize_bilinear(base, w, h)
    n = _np_resize_bilinear(nrm, w, h)
    r = _np_resize_bilinear(mr, w, h)
    e = _np_resize_bilinear(em, w, h)
    o = _np_resize_bilinear(occ, w, h)
    # 12 channels: base rgba | nx ny rough metal | em rgb + occl.
    p12 = np.concatenate(
        [
            b[..., :4],
            n[..., 0:1], n[..., 1:2], r[..., 1:2], r[..., 2:3],
            e[..., 0:1], e[..., 1:2], e[..., 2:3], o[..., 0:1],
        ],
        axis=-1,
    )
    mips = _mip_chain(p12)
    offsets = np.zeros((MAX_MIPS,), np.int64)
    rows_list = []
    for li, mp in enumerate(mips):
        offsets[li] = cursor
        rows_list.append(_pack_rows(mp))
        cursor += mp.shape[0] * mp.shape[1]
    for li in range(len(mips), MAX_MIPS):
        offsets[li] = offsets[len(mips) - 1]
    meta_row = np.zeros((META_LANES,), np.float32)
    meta_row[0] = wrap
    meta_row[1] = w
    meta_row[2] = h
    meta_row[3] = len(mips)
    meta_row[4:] = offsets.astype(np.float32)
    return np.concatenate(rows_list, axis=0), meta_row, cursor


def build_packed_materials(materials, images, wrap_default: int = 0):
    """Host-side packing of every material's texture slots.

    ``materials``: list of scene.Material; ``images``: TexturePoolBuilder's
    (img_rgba8, srgb, wrap) list indexed by bindless texture id.
    Default ids (0 white / 2 flat-normal) mean "slot unused".

    Returns (rows (R, 3) uint32, meta (M, META_LANES) float32) where meta =
    [wrap, w0, h0, n_mips, mip_offset*13] per material. Offsets are exact in
    f32 (asserted < 2^24).
    """
    rows_list: list[np.ndarray] = []
    cursor = 0
    cache: dict[tuple, tuple] = {}  # texture-id tuple -> (meta_row sans offsets)
    meta = np.zeros((len(materials), META_LANES), np.float32)

    for mi, m in enumerate(materials):
        key = (
            int(m.base_color_tex), int(m.normal_tex), int(m.mr_tex),
            int(m.emissive_tex), int(m.occlusion_tex),
        )
        if key not in cache:
            rows, meta_row, cursor = pack_material_chain(
                m, images, cursor, wrap_default
            )
            rows_list.append(rows)
            cache[key] = meta_row
        meta[mi] = cache[key]

    assert cursor < (1 << 24), "packed texel pool exceeds exact-f32 addressing"
    rows = (
        np.concatenate(rows_list, axis=0)
        if rows_list
        else np.zeros((1, 3), np.uint32)
    )
    # Pad to a lane-friendly multiple.
    pad = (-rows.shape[0]) % 8
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, 3), np.uint32)], axis=0)
    return rows, meta


# ---------------------------------------------------------------------------
# Device-side sampling


def _srgb_to_linear(c):
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _select13(vals: jax.Array, level: jax.Array) -> jax.Array:
    """vals (N, 13) lanes, level (N,) int -> (N,) selected lane.

    A 13-way jnp.where chain fuses into the elementwise path — unlike
    take_along_axis, which is another gather."""
    out = vals[:, 0]
    for l in range(1, MAX_MIPS):
        out = jnp.where(level == l, vals[:, l], out)
    return out


def _mip_dim(base: jax.Array, level: jax.Array) -> jax.Array:
    """max(base >> level, 1) as an elementwise select chain."""
    out = base
    for l in range(1, MAX_MIPS):
        out = jnp.where(level == l, jnp.maximum(base >> l, 1), out)
    return out


def _unpack12(rows: jax.Array) -> jax.Array:
    """(N, 3) u32 -> (N, 12) f32 [0,1], material-channel decoded to linear:
    base.rgb and emissive.rgb sRGB-decoded; everything else linear.

    Flat-lane unpack (no (N, 3, 4) intermediate — see ops/packed_shading)."""
    lanes = [
        ((rows[:, c] >> s) & 0xFF).astype(jnp.float32) * (1.0 / 255.0)
        for c in range(3)
        for s in (0, 8, 16, 24)
    ]
    b = jnp.stack(lanes, axis=-1)
    srgb_mask = jnp.array([1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0], bool)
    lin = _srgb_to_linear(b)
    return jnp.where(srgb_mask[None, :], lin, b)


class MaterialSample(NamedTuple):
    base: jax.Array       # (N, 4) linear base color + alpha
    normal_ts: jax.Array  # (N, 3) tangent-space normal (z reconstructed)
    rough_metal: jax.Array  # (N, 2)
    emissive: jax.Array   # (N, 3) linear
    occlusion: jax.Array  # (N,)


def _fetch_level(rows, off, wrap, wl, hl, uv):
    """One bilinear fetch at a single mip: 4 row gathers. All metadata is
    per-pixel lanes (no lookups)."""
    w_f = wl.astype(jnp.float32)
    h_f = hl.astype(jnp.float32)
    x = uv[:, 0] * w_f - 0.5
    y = uv[:, 1] * h_f - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def addr(c, extent):
        rep = c & (extent - 1)  # pool dims are power-of-two by construction
        clp = jnp.clip(c, 0, extent - 1)
        return jnp.where(wrap == 0, rep, clp)

    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi = addr(x0i + dx, wl)
            yi = addr(y0i + dy, hl)
            t = rows[off + yi * wl + xi]      # (N, 3) u32 — ONE row gather
            c = _unpack12(t)
            wgt = jnp.where(dx, fx, 1 - fx) * jnp.where(dy, fy, 1 - fy)
            out = out + c * wgt
    return out


def sample_packed(
    rows: jax.Array,       # (R, 3) u32 pool
    meta: jax.Array,       # (N, META_LANES) per-pixel material texture meta
    uv: jax.Array,         # (N, 2)
    duv_dx: jax.Array,
    duv_dy: jax.Array,
    quality: str = "trilinear",
    noise: jax.Array | None = None,   # (N,) in [0,1) for "stochastic"
    lod_bias: float = 0.0,            # negative when rendering below display
                                      # res (the DLSS mip-bias drive,
                                      # DLSSNode.cpp's global mip bias)
) -> MaterialSample:
    """Gradient-correct packed material sample: 4 row gathers (bilinear
    nearest-mip / stochastic trilinear) or 8 (trilinear). meta lanes: [wrap,
    w0, h0, n_mips, offsets*13] — comes from the shading record, zero
    per-pixel lookups.

    quality="stochastic": the mip lerp is replaced by a per-pixel jittered
    mip pick (lod + noise - 0.5, rounded) — half the taps of trilinear with
    the same EXPECTED value; TAA converges the variance away within a few
    frames (stochastic texture filtering). Falls back to nearest-mip when no
    noise is provided."""
    if quality == "auto":
        quality = "trilinear"
    wrap = meta[:, 0].astype(jnp.int32)
    w0 = meta[:, 1].astype(jnp.int32)
    h0 = meta[:, 2].astype(jnp.int32)
    n_mips = meta[:, 3]
    offs = meta[:, 4:]

    size0 = jnp.stack([meta[:, 1], meta[:, 2]], axis=-1)
    dx = duv_dx * size0
    dy = duv_dy * size0
    rho2 = jnp.maximum(jnp.sum(dx * dx, -1), jnp.sum(dy * dy, -1))
    lod = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-12)) + lod_bias
    max_lod = n_mips - 1.0
    lod = jnp.clip(lod, 0.0, max_lod)

    def level_fetch(level):
        off = _select13(offs, level).astype(jnp.int32)
        wl = _mip_dim(w0, level)
        hl = _mip_dim(h0, level)
        return _fetch_level(rows, off, wrap, wl, hl, uv)

    if quality.startswith("aniso"):
        # Anisotropic filtering (the reference enables 16x aniso on EVERY
        # sampler, backend/vulkan/VulkanSampler.cpp:66-67): N bilinear taps
        # marched along the MAJOR gradient axis, each at the mip of the
        # (clamped) minor axis — grazing surfaces keep detail the isotropic
        # max-axis rho blurs away. quality = "aniso2" | "aniso4" | ...
        n_taps = max(int(quality[5:] or "4"), 1)
        lx2 = jnp.sum(dx * dx, -1)
        ly2 = jnp.sum(dy * dy, -1)
        major_is_x = lx2 >= ly2
        rho_maj2 = jnp.maximum(jnp.where(major_is_x, lx2, ly2), 1e-12)
        rho_min2 = jnp.maximum(jnp.where(major_is_x, ly2, lx2), 1e-12)
        rho_eff2 = jnp.maximum(rho_min2, rho_maj2 / float(n_taps * n_taps))
        lod_a = jnp.clip(
            0.5 * jnp.log2(rho_eff2) + lod_bias, 0.0, max_lod
        )
        l0 = jnp.floor(lod_a).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, max_lod.astype(jnp.int32))
        f = (lod_a - l0.astype(jnp.float32))[:, None]
        maj_uv = jnp.where(major_is_x[:, None], duv_dx, duv_dy)

        def tap(uv_q):
            def level_fetch_at(level):
                off = _select13(offs, level).astype(jnp.int32)
                wl = _mip_dim(w0, level)
                hl = _mip_dim(h0, level)
                return _fetch_level(rows, off, wrap, wl, hl, uv_q)

            return level_fetch_at(l0) * (1 - f) + level_fetch_at(l1) * f

        c = 0.0
        for k in range(n_taps):
            t = (k + 0.5) / n_taps - 0.5
            c = c + tap(uv + maj_uv * t)
        c = c / n_taps
    elif quality == "trilinear":
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, max_lod.astype(jnp.int32))
        f = (lod - l0.astype(jnp.float32))[:, None]
        c = level_fetch(l0) * (1 - f) + level_fetch(l1) * f
    elif quality == "stochastic1" and noise is not None and noise.ndim == 2:
        # ONE texel tap whose EXPECTATION equals trilinear: jittered mip
        # pick (lane 0) + jittered nearest within the bilinear footprint
        # (lanes 1-2; round(x + u - 0.5), u~U[0,1) has bilinear-weight
        # expectation per axis — same estimator as the stochastic VSM tap).
        # TAA converges the variance. Gather cost is paid per tap more
        # than per row width, so 1 tap vs trilinear's 8 is most of the
        # texture bill.
        lod_j = jnp.clip(lod + (noise[:, 0] - 0.5), 0.0, max_lod)
        level = jnp.round(lod_j).astype(jnp.int32)
        off = _select13(offs, level).astype(jnp.int32)
        wl = _mip_dim(w0, level)
        hl = _mip_dim(h0, level)
        w_f = wl.astype(jnp.float32)
        h_f = hl.astype(jnp.float32)
        x = uv[:, 0] * w_f - 0.5 + (noise[:, 1] - 0.5)
        y = uv[:, 1] * h_f - 0.5 + (noise[:, 2] - 0.5)
        xi = jnp.round(x).astype(jnp.int32)
        yi = jnp.round(y).astype(jnp.int32)
        xi = jnp.where(wrap == 0, xi & (wl - 1), jnp.clip(xi, 0, wl - 1))
        yi = jnp.where(wrap == 0, yi & (hl - 1), jnp.clip(yi, 0, hl - 1))
        c = _unpack12(rows[off + yi * wl + xi])
    elif quality == "stochastic" and noise is not None:
        mip_noise = noise[:, 0] if noise.ndim == 2 else noise
        lod_j = jnp.clip(lod + (mip_noise - 0.5), 0.0, max_lod)
        c = level_fetch(jnp.round(lod_j).astype(jnp.int32))
    else:  # bilinear nearest mip
        c = level_fetch(jnp.clip(jnp.round(lod), 0.0, max_lod).astype(jnp.int32))

    n_xy = c[:, 4:6] * 2.0 - 1.0
    n_z = jnp.sqrt(jnp.maximum(1.0 - jnp.sum(n_xy * n_xy, -1, keepdims=True), 0.0))
    return MaterialSample(
        base=c[:, 0:4],
        normal_ts=jnp.concatenate([n_xy, n_z], axis=-1),
        rough_metal=c[:, 6:8],
        emissive=c[:, 8:11],
        occlusion=c[:, 11],
    )
