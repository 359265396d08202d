"""Lights with photometric units.

Role-equivalent to arkose/scene/lights/*: a directional "sun" specified in
lux (illuminance), spot lights in candela (luminous intensity) with inner /
outer cone falloff, and point lights. Shadow modes follow the reference
(ShadowMapped for the sun via an ortho light camera fit to the scene bounds,
RayTraced or mapped for locals — RT comes with the BVH milestone).

Light *pre-exposure* — multiplying light intensity by the camera exposure on
upload so shading math stays in a sane f32/bf16 range — mirrors
GpuScene.cpp:811-859.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx


@dataclasses.dataclass
class DirectionalLight:
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.3, -1.0, 0.2], np.float32)
    )
    color: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32)
    )
    illuminance_lux: float = 90000.0  # bright sun
    cast_shadows: bool = True
    shadow_constant_bias: float = 1e-3   # in reverse-Z depth units
    shadow_slope_bias: float = 3.0       # in shadow texels
    # Angular radius of the disk (degrees; real sun ~0.265). > 0 turns RT
    # sun shadows into cone-sampled stochastic soft shadows with the sigma
    # denoiser (the reference's NRD ExternalFeature slot,
    # features/nrd/VulkanNRD.cpp); 0 keeps hard single-ray masks.
    angular_radius_deg: float = 0.0

    def normalized_direction(self) -> np.ndarray:
        d = np.asarray(self.direction, np.float32)
        return d / np.linalg.norm(d)

    def shadow_view_proj(
        self, scene_center: np.ndarray, scene_radius: float
    ) -> np.ndarray:
        """Ortho light camera enclosing the scene bounds
        (cf. DirectionalLight's ortho projection around the scene)."""
        d = self.normalized_direction()
        eye = scene_center - d * (scene_radius * 2.0)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        if abs(np.dot(d, up)) > 0.98:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        view = mx.look_at(eye, scene_center, up, xp=np)
        r = float(scene_radius)
        proj = mx.orthographic_reverse_z(
            -r, r, -r, r, scene_radius * 0.5, scene_radius * 4.0, xp=np
        )
        return proj @ view


@dataclasses.dataclass
class SpotLight:
    position: np.ndarray
    direction: np.ndarray
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    luminous_intensity_cd: float = 1000.0
    inner_cone_angle: float = np.radians(20.0)
    outer_cone_angle: float = np.radians(30.0)
    cast_shadows: bool = True
    ies_lut: np.ndarray | None = None  # (256,) polar intensity (assets/external.IESProfile.to_lut)
    # Physical source radius (world units) for soft RT shadows (disk-
    # jittered occlusion rays); 0 = point source (hard masks).
    source_radius: float = 0.0

    def shadow_view_proj(self, far: float, near: float = 0.05) -> np.ndarray:
        """Perspective light camera covering the outer cone (the reference's
        per-local-light shadow matrix, SpotLight.cpp viewProjection)."""
        d = np.asarray(self.direction, np.float32)
        d = d / np.linalg.norm(d)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        if abs(np.dot(d, up)) > 0.98:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        view = mx.look_at(
            np.asarray(self.position, np.float32),
            np.asarray(self.position, np.float32) + d, up, xp=np,
        )
        fov = min(2.0 * float(self.outer_cone_angle) * 1.05, np.pi * 0.95)
        proj = mx.perspective_reverse_z(fov, 1.0, near, far=far, xp=np)
        return proj @ view


@dataclasses.dataclass
class PointLight:
    position: np.ndarray
    color: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3, np.float32))
    luminous_intensity_cd: float = 1000.0
    # RT-only shadows (RTLocalShadowPass); there is no point-shadow atlas,
    # matching the reference's spot-only shadow maps.
    cast_shadows: bool = False
    source_radius: float = 0.0  # world units; > 0 = soft RT shadows


class LightArrays(NamedTuple):
    """Device-side light data (the LightData SSBO analogue,
    arkose/shaders/shared/LightData.h). Intensities are PRE-EXPOSED."""

    sun_direction: jax.Array      # (3,)
    sun_color: jax.Array          # (3,) color * lux * exposure
    sun_valid: jax.Array          # () bool
    sun_view_proj: jax.Array      # (4,4) shadow matrix
    sun_cos_radius: jax.Array     # () cos(angular radius); 1.0 = hard sun
    # Fixed-capacity local lights; count in *_count.
    spot_pos: jax.Array           # (S,3)
    spot_dir: jax.Array           # (S,3)
    spot_color: jax.Array         # (S,3) color * cd * exposure
    spot_cone: jax.Array          # (S,2) cos(inner), cos(outer)
    spot_count: jax.Array         # () i32
    point_pos: jax.Array          # (P,3)
    point_color: jax.Array        # (P,3)
    point_count: jax.Array        # () i32
    ambient_lx: jax.Array         # () pre-exposed flat ambient (until DDGI)
    spot_ies: jax.Array           # (S, 256) per-spot polar intensity LUT (row of
                                  # ones = no profile); IESProfile analogue
    spot_view_proj: jax.Array     # (S, 4, 4) per-spot shadow matrices
    spot_casts_shadow: jax.Array  # (S,) f32 1.0 where the light shadows


def build_light_arrays(
    sun: DirectionalLight | None,
    spots: list[SpotLight],
    points: list[PointLight],
    exposure: float,
    scene_center: np.ndarray,
    scene_radius: float,
    max_spots: int = 16,
    max_points: int = 16,
    ambient_lx: float = 0.0,
) -> LightArrays:
    assert len(spots) <= max_spots and len(points) <= max_points
    if sun is not None:
        sun_dir = sun.normalized_direction()
        sun_color = sun.color * sun.illuminance_lux * exposure
        sun_vp = sun.shadow_view_proj(scene_center, scene_radius)
        sun_cos_r = np.cos(np.radians(sun.angular_radius_deg))
    else:
        sun_dir = np.array([0, -1, 0], np.float32)
        sun_color = np.zeros(3, np.float32)
        sun_vp = np.eye(4, dtype=np.float32)
        sun_cos_r = 1.0

    spot_pos = np.zeros((max_spots, 3), np.float32)
    spot_dir = np.tile(np.array([0, -1, 0], np.float32), (max_spots, 1))
    spot_color = np.zeros((max_spots, 3), np.float32)
    spot_cone = np.ones((max_spots, 2), np.float32)
    spot_ies = np.ones((max_spots, 256), np.float32)
    spot_vp = np.tile(np.eye(4, dtype=np.float32), (max_spots, 1, 1))
    spot_casts = np.zeros((max_spots,), np.float32)
    for i, s in enumerate(spots):
        spot_pos[i] = s.position
        d = np.asarray(s.direction, np.float32)
        spot_dir[i] = d / np.linalg.norm(d)
        spot_color[i] = s.color * s.luminous_intensity_cd * exposure
        spot_cone[i] = (np.cos(s.inner_cone_angle), np.cos(s.outer_cone_angle))
        if s.ies_lut is not None:
            spot_ies[i] = np.asarray(s.ies_lut, np.float32)
        spot_vp[i] = s.shadow_view_proj(far=max(scene_radius * 4.0, 1.0))
        spot_casts[i] = 1.0 if s.cast_shadows else 0.0

    point_pos = np.zeros((max_points, 3), np.float32)
    point_color = np.zeros((max_points, 3), np.float32)
    for i, p in enumerate(points):
        point_pos[i] = p.position
        point_color[i] = p.color * p.luminous_intensity_cd * exposure

    return LightArrays(
        sun_direction=jnp.asarray(sun_dir),
        sun_color=jnp.asarray(sun_color.astype(np.float32)),
        sun_valid=jnp.asarray(sun is not None),
        sun_view_proj=jnp.asarray(sun_vp),
        sun_cos_radius=jnp.asarray(sun_cos_r, jnp.float32),
        spot_pos=jnp.asarray(spot_pos),
        spot_dir=jnp.asarray(spot_dir),
        spot_color=jnp.asarray(spot_color),
        spot_cone=jnp.asarray(spot_cone),
        spot_count=jnp.asarray(len(spots), jnp.int32),
        point_pos=jnp.asarray(point_pos),
        point_color=jnp.asarray(point_color),
        point_count=jnp.asarray(len(points), jnp.int32),
        ambient_lx=jnp.asarray(ambient_lx * exposure, jnp.float32),
        spot_ies=jnp.asarray(spot_ies),
        spot_view_proj=jnp.asarray(spot_vp),
        spot_casts_shadow=jnp.asarray(spot_casts),
    )
