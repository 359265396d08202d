"""Framework-wide constants and fixed capacities.

XLA requires static shapes: everything dynamic in the reference is a
fixed-capacity pool here, mirroring the reference's own pool sizes
(reference: arkose/rendering/GpuScene.h:241-284, VertexManager.h:89-99).
Capacities are configurable per-Scene; these are the defaults used by the
showcase-scale configuration. Tests use much smaller ones.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# Compute dtypes. Geometry math stays f32 (positions/depth need the range);
# shading color math can run bf16 where precision allows.
F32 = jnp.float32
BF16 = jnp.bfloat16
I32 = jnp.int32
U32 = jnp.uint32
U8 = jnp.uint8

# Sentinel for "no triangle" in the visibility buffer (reference encodes
# drawable+triangle IDs in an R32Uint target; 0 is reserved for background —
# arkose/shaders/common/visibilityBuffer.glsl).
VIS_NONE = -1


@dataclasses.dataclass(frozen=True)
class SceneLimits:
    """Fixed-capacity pool sizes for a scene (static shapes under jit).

    Defaults follow the reference's capacities (GpuScene.h:241-284,
    VertexManager.h:89-99).
    """

    max_vertices: int = 12 << 20       # 12M — reference parity (VertexManager.h:89)
    max_indices: int = 48 << 20        # 48M — reference parity
    max_drawables: int = 65536         # reference parity (GpuScene.h:241)
    max_materials: int = 10000         # reference parity (GpuScene.h:259)
    max_textures: int = 4096           # reference parity (GpuScene.h:274)
    max_dir_lights: int = 1
    max_spot_lights: int = 16          # local lights (shadow atlas consumers)
    max_point_lights: int = 16
    texture_pool_texels: int = 1 << 24  # flat bindless texel pool (uint32 RGBA8)

    @property
    def max_triangles(self) -> int:
        return self.max_indices // 3


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Tile rasterizer configuration.

    The tile is the raster kernel's block: ``tile_h`` × ``tile_w`` pixels
    shaded together by one program (a power of two for the GPU kernel); ``max_tris_per_tile`` is the per-tile bin capacity (overflow is
    dropped — same spirit as the reference's fixed meshlet/task budgets,
    arkose/rendering/meshlet/MeshletVisibilityBufferRenderNode.cpp:88-90).
    """

    tile_h: int = 8
    tile_w: int = 128
    max_tris_per_tile: int = 512
    bin_chunk: int = 2048  # triangles binned per scan step (legacy scan path)
    max_tiles_per_tri: int = 16  # pair-emission cap; bigger spans go global
    max_global_tris: int = 256   # capacity of the every-tile "big triangle" list
    max_mid_tris: int = 0        # span-3..C compaction budget (0 = pool/8)


DEFAULT_LIMITS = SceneLimits()
DEFAULT_RASTER = RasterConfig()
