"""Bindless texture pool + filtered sampling.

Array-program replacement for the reference's bindless sampled-texture arrays
(arkose/rendering/backend/base/BindingSet.h:33-34, GpuScene material set with
4,096 bindless textures): every mip of every texture lives in ONE flat
device-resident ``uint32`` texel pool (RGBA8 packed), addressed as

    texel_index = mip_offset[texture, level] + y * mip_width + x

so a single dynamic gather serves any texture/mip — the "bindless" part is
just integer math. Filtering (bilinear within a mip, trilinear across mips,
wrap/clamp addressing, sRGB decode before filtering) is done in shader code,
exactly like a GPU sampler would, using analytic UV gradients for LOD since
there are no implicit derivatives outside fragment shaders (cf.
shadeVisibilityBuffer.comp's gradient-correct sampling).

Host-side building is NumPy; sampling is jit-traceable jnp.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_MIPS = 13  # up to 4096x4096


class TexturePool(NamedTuple):
    """Device-side pool (a pytree; all arrays fixed-capacity)."""

    texels: jax.Array       # (pool_size,) uint32 RGBA8 packed (r | g<<8 | b<<16 | a<<24)
    mip_offset: jax.Array   # (max_tex, MAX_MIPS) i32 texel offset of each mip
    mip_size: jax.Array     # (max_tex, MAX_MIPS, 2) i32 (width, height), >= 1
    n_mips: jax.Array       # (max_tex,) i32
    srgb: jax.Array         # (max_tex,) bool — decode to linear when sampling
    wrap: jax.Array         # (max_tex,) i32 — 0 = repeat, 1 = clamp


WRAP_REPEAT = 0
WRAP_CLAMP = 1


# ---------------------------------------------------------------------------
# Host-side pool building


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF on [0, 1] float arrays."""
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.maximum(c, 0.0) ** (1 / 2.4) - 0.055)


def generate_mip_chain(img: np.ndarray, *, srgb: bool = False) -> list[np.ndarray]:
    """2x2 box-filter mip chain; img is (H, W, 4) uint8.

    (Reference counterpart: ImageAsset::generateMipmaps, and the runtime
    mipgen in CommandList::generateMipmaps.) For sRGB-encoded color textures
    the RGB channels are decoded to linear before averaging and re-encoded
    after (averaging gamma-encoded values darkens mips: a 0/255 checkerboard
    must downsample to linear 0.5 ~= sRGB 188, not 128); alpha is always
    linear. Non-color data (normals, metallic/roughness) filters raw.
    """
    mips = [img]
    cur = img.astype(np.float32)
    if srgb:
        cur[..., :3] = _srgb_to_linear(cur[..., :3] / 255.0)
        cur[..., 3] /= 255.0
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        h = max(cur.shape[0] // 2, 1)
        w = max(cur.shape[1] // 2, 1)
        if cur.shape[0] > 1 and cur.shape[1] > 1:
            cur = cur.reshape(h, 2, w, 2, 4).mean(axis=(1, 3))
        elif cur.shape[0] > 1:
            cur = cur.reshape(h, 2, 1, 4).mean(axis=1)
        else:
            cur = cur.reshape(1, w, 2, 4).mean(axis=2)
        if srgb:
            enc = np.concatenate(
                [_linear_to_srgb(cur[..., :3]), cur[..., 3:]], axis=-1) * 255.0
        else:
            enc = cur
        mips.append(np.clip(enc + 0.5, 0, 255).astype(np.uint8))
    return mips


def pack_rgba8(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H*W,) uint32."""
    img = img.astype(np.uint32)
    return (
        img[..., 0] | (img[..., 1] << 8) | (img[..., 2] << 16) | (img[..., 3] << 24)
    ).reshape(-1)


@dataclasses.dataclass
class TexturePoolBuilder:
    """Accumulates textures host-side, then freezes to a device TexturePool."""

    max_textures: int
    pool_capacity: int

    def __post_init__(self):
        self._texels: list[np.ndarray] = []
        self._offset = np.zeros((self.max_textures, MAX_MIPS), np.int32)
        self._size = np.ones((self.max_textures, MAX_MIPS, 2), np.int32)
        self._n_mips = np.zeros((self.max_textures,), np.int32)
        self._srgb = np.zeros((self.max_textures,), bool)
        self._wrap = np.zeros((self.max_textures,), np.int32)
        self._cursor = 0
        self._count = 0
        self.all_pow2 = True  # every added texture has power-of-two dims
        # Default textures, mirroring GpuScene's defaults (GpuScene.cpp:45-115):
        # 0 = white, 1 = black, 2 = flat normal, 3 = mid-gray.
        for rgba in ([255, 255, 255, 255], [0, 0, 0, 255], [128, 128, 255, 255], [128, 128, 128, 255]):
            self.add(np.full((1, 1, 4), rgba, np.uint8), srgb=False, mipmapped=False)

    def add(
        self,
        img: np.ndarray,
        *,
        srgb: bool,
        wrap: int = WRAP_REPEAT,
        mipmapped: bool = True,
    ) -> int:
        """Add an (H, W, C<=4) uint8 image; returns its bindless texture id."""
        assert self._count < self.max_textures, "texture pool id capacity exceeded"
        if img.ndim == 2:
            img = img[..., None]
        if not hasattr(self, "images"):
            self.images: list[tuple[np.ndarray, bool, int]] = []
        if img.shape[2] < 4:
            pad = np.zeros(img.shape[:2] + (4 - img.shape[2],), np.uint8)
            if img.shape[2] < 4:
                pad[..., -1] = 255  # alpha defaults to opaque
            img = np.concatenate([img, pad], axis=-1)
        tid = self._count
        mips = generate_mip_chain(img, srgb=srgb) if mipmapped else [img]
        mips = mips[:MAX_MIPS]
        for level, m in enumerate(mips):
            n = m.shape[0] * m.shape[1]
            assert self._cursor + n <= self.pool_capacity, "texel pool capacity exceeded"
            self._offset[tid, level] = self._cursor
            self._size[tid, level] = (m.shape[1], m.shape[0])
            self._texels.append(pack_rgba8(m))
            self._cursor += n
        # Pad unused mip slots with the last mip so clamped LODs stay in-bounds.
        for level in range(len(mips), MAX_MIPS):
            self._offset[tid, level] = self._offset[tid, len(mips) - 1]
            self._size[tid, level] = self._size[tid, len(mips) - 1]
        self._n_mips[tid] = len(mips)
        self._srgb[tid] = srgb
        self._wrap[tid] = wrap
        self.images.append((img, srgb, wrap))
        self._count += 1
        if (img.shape[0] & (img.shape[0] - 1)) or (img.shape[1] & (img.shape[1] - 1)):
            self.all_pow2 = False
        return tid

    def finalize(self) -> TexturePool:
        texels = np.zeros((self.pool_capacity,), np.uint32)
        if self._texels:
            data = np.concatenate(self._texels)
            texels[: data.shape[0]] = data
        return TexturePool(
            texels=jnp.asarray(texels),
            mip_offset=jnp.asarray(self._offset),
            mip_size=jnp.asarray(self._size),
            n_mips=jnp.asarray(self._n_mips),
            srgb=jnp.asarray(self._srgb),
            wrap=jnp.asarray(self._wrap),
        )


# ---------------------------------------------------------------------------
# Device-side sampling


def unpack_rgba8(texel: jax.Array) -> jax.Array:
    """(...,) uint32 -> (..., 4) f32 in [0, 1]."""
    r = (texel & 0xFF).astype(jnp.float32)
    g = ((texel >> 8) & 0xFF).astype(jnp.float32)
    b = ((texel >> 16) & 0xFF).astype(jnp.float32)
    a = ((texel >> 24) & 0xFF).astype(jnp.float32)
    return jnp.stack([r, g, b, a], axis=-1) * (1.0 / 255.0)


def srgb_to_linear(c: jax.Array) -> jax.Array:
    """Exact IEC 61966-2-1 EOTF (matches the reference's color/srgb.glsl role)."""
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: jax.Array) -> jax.Array:
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _fetch_bilinear(pool: TexturePool, tex_id, level, uv, decode_srgb,
                    pow2: bool = False):
    """Bilinear fetch at integer mip ``level``; tex_id/level/uv are (N,)/(N,)/(N,2).

    ``pow2`` (static): every texture dimension in the pool is a power of
    two, so REPEAT addressing is a bitmask instead of jnp.mod (an integer
    division by a dynamic extent, 8 per sample). The builder detects eligibility (TexturePoolBuilder.all_pow2)
    and SceneStatic carries it to the shading permutation."""
    off = pool.mip_offset[tex_id, level]          # (N,)
    size = pool.mip_size[tex_id, level]           # (N, 2)
    w = size[:, 0].astype(jnp.float32)
    h = size[:, 1].astype(jnp.float32)
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    wrap = pool.wrap[tex_id]  # (N,)

    def addr(c, extent):
        rep = (c & (extent - 1)) if pow2 else jnp.mod(c, extent)
        clp = jnp.clip(c, 0, extent - 1)
        return jnp.where(wrap == WRAP_REPEAT, rep, clp).astype(jnp.int32)

    wi = size[:, 0]
    hi = size[:, 1]
    x0i, x1i = addr(x0.astype(jnp.int32), wi), addr(x0.astype(jnp.int32) + 1, wi)
    y0i, y1i = addr(y0.astype(jnp.int32), hi), addr(y0.astype(jnp.int32) + 1, hi)

    def texel(xi, yi):
        t = pool.texels[off + yi * wi + xi]
        c = unpack_rgba8(t)
        if decode_srgb:
            srgb = pool.srgb[tex_id][:, None]
            rgb = jnp.where(srgb, srgb_to_linear(c[:, :3]), c[:, :3])
            c = jnp.concatenate([rgb, c[:, 3:4]], axis=-1)
        return c

    c00 = texel(x0i, y0i)
    c10 = texel(x1i, y0i)
    c01 = texel(x0i, y1i)
    c11 = texel(x1i, y1i)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def compute_lod(pool: TexturePool, tex_id, duv_dx, duv_dy) -> jax.Array:
    """Isotropic mip LOD from analytic UV gradients (per pixel)."""
    size0 = pool.mip_size[tex_id, 0].astype(jnp.float32)  # (N, 2)
    dx = duv_dx * size0
    dy = duv_dy * size0
    rho2 = jnp.maximum(jnp.sum(dx * dx, axis=-1), jnp.sum(dy * dy, axis=-1))
    return 0.5 * jnp.log2(jnp.maximum(rho2, 1e-12))


def sample_trilinear(
    pool: TexturePool,
    tex_id: jax.Array,
    uv: jax.Array,
    lod: jax.Array | None = None,
    decode_srgb: bool = True,
    pow2: bool = False,
) -> jax.Array:
    """(N,) tex ids + (N,2) uv [+ (N,) lod] -> (N,4) linear-space RGBA."""
    if lod is None:
        lod = jnp.zeros(tex_id.shape, jnp.float32)
    max_lod = (pool.n_mips[tex_id] - 1).astype(jnp.float32)
    lod = jnp.clip(lod, 0.0, max_lod)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_lod.astype(jnp.int32))
    f = (lod - l0.astype(jnp.float32))[:, None]
    c0 = _fetch_bilinear(pool, tex_id, l0, uv, decode_srgb, pow2=pow2)
    c1 = _fetch_bilinear(pool, tex_id, l1, uv, decode_srgb, pow2=pow2)
    return c0 * (1 - f) + c1 * f


def sample_bilinear_nearest_mip(
    pool: TexturePool,
    tex_id: jax.Array,
    uv: jax.Array,
    lod: jax.Array,
    decode_srgb: bool = True,
    pow2: bool = False,
) -> jax.Array:
    """4-tap bilinear at the rounded mip (half the taps of trilinear; mip
    transitions pop slightly — TAA hides it; the performance-quality knob
    analogous to the reference's sampler filter settings)."""
    max_lod = (pool.n_mips[tex_id] - 1).astype(jnp.float32)
    l0 = jnp.clip(jnp.round(lod), 0.0, max_lod).astype(jnp.int32)
    return _fetch_bilinear(pool, tex_id, l0, uv, decode_srgb, pow2=pow2)


def sample_grad(
    pool: TexturePool,
    tex_id: jax.Array,
    uv: jax.Array,
    duv_dx: jax.Array,
    duv_dy: jax.Array,
    decode_srgb: bool = True,
    quality: str = "trilinear",
    pow2: bool = False,
) -> jax.Array:
    """Gradient-correct sample (the standard material-texture path)."""
    if quality in ("auto", "stochastic"):
        quality = "trilinear"  # reference path has no stochastic filter
    if quality not in ("trilinear", "bilinear"):
        raise ValueError(
            f"unknown texture quality {quality!r} (trilinear|bilinear)"
        )
    lod = compute_lod(pool, tex_id, duv_dx, duv_dy)
    if quality == "bilinear":
        return sample_bilinear_nearest_mip(pool, tex_id, uv, lod, decode_srgb,
                                           pow2=pow2)
    return sample_trilinear(pool, tex_id, uv, lod, decode_srgb=decode_srgb,
                            pow2=pow2)
