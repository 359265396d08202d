"""Photographic camera model.

Role-equivalent to the reference's Camera (arkose/scene/camera/Camera.h:15-241,
Camera.cpp): physically-based exposure from focal length / sensor size /
f-number / shutter / ISO (EV100), manual + auto exposure modes, focus depth
and circle-of-confusion math for depth of field, Halton-jittered projection
for TAA/upscaling, previous-frame matrices for motion vectors, and a culling
frustum.

The camera is a host-side object; ``state()`` freezes it into a CameraState
pytree of device arrays — the analogue of the reference's CameraState UBO
(arkose/shaders/shared/CameraState.h) uploaded by GpuScene each frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.core.halton import camera_jitter_sequence


class CameraState(NamedTuple):
    """Per-frame camera data as device arrays (the CameraState UBO analogue)."""

    view_from_world: jax.Array        # (4,4)
    proj_from_view: jax.Array         # (4,4) jittered
    unjittered_proj: jax.Array        # (4,4)
    prev_view_from_world: jax.Array   # (4,4)
    prev_proj_from_view: jax.Array    # (4,4) unjittered previous projection
    position: jax.Array               # (3,)
    exposure: jax.Array               # () scalar — pre-exposure multiplier
    jitter_px: jax.Array              # (2,) this frame's subpixel jitter
    near: jax.Array                   # ()
    focus_depth: jax.Array            # () meters
    aperture_px: jax.Array            # () CoC scale factor in pixels (see DoF)

    @property
    def view_proj(self):
        return mx.matmul(self.proj_from_view, self.view_from_world)

    @property
    def unjittered_view_proj(self):
        return mx.matmul(self.unjittered_proj, self.view_from_world)

    @property
    def prev_view_proj(self):
        return mx.matmul(self.prev_proj_from_view, self.prev_view_from_world)


def calculate_ev100(f_number: float, shutter_speed: float, iso: float) -> float:
    """EV at ISO 100 (standard photographic definition)."""
    return float(np.log2((f_number * f_number) / shutter_speed * 100.0 / iso))


def exposure_from_ev100(ev100: float) -> float:
    """Photometric exposure normalization: H = 1 / (1.2 * 2^EV100).

    The 1.2 factor is the standard reflected-light meter calibration
    (q = 0.65, K = 12.5) used by Filament and the reference alike.
    """
    return 1.0 / (1.2 * (2.0 ** ev100))


@dataclasses.dataclass
class Camera:
    """Host camera; mutate freely between frames, call ``state()`` per frame."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    orientation: np.ndarray = dataclasses.field(  # quaternion (x,y,z,w)
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32)
    )
    viewport: tuple[int, int] = (1920, 1080)  # (width, height)

    # Photographic parameters (reference defaults: 30mm lens on a 36x24mm
    # "full-frame" sensor, f/16, 1/400s, ISO 400 — Camera.h:136-150 region).
    focal_length_mm: float = 30.0
    sensor_size_mm: tuple[float, float] = (36.0, 24.0)
    f_number: float = 16.0
    shutter_speed: float = 1.0 / 400.0
    iso: float = 400.0
    exposure_compensation: float = 0.0
    adaption_rate: float = 0.0018  # auto-exposure eye adaption per-frame rate

    focus_depth: float = 5.0  # meters
    near: float = 0.25
    far: float | None = None  # None = infinite far (reverse-Z)

    jitter_enabled: bool = True
    jitter_period: int = 16

    def __post_init__(self):
        self._jitter_seq = camera_jitter_sequence(self.jitter_period)
        self._prev_view: np.ndarray | None = None
        self._prev_proj: np.ndarray | None = None
        self._auto_exposure: float | None = None
        # Device-state cache (see state()): a static camera skips the 11
        # small H2D transfers of a CameraState. Keyed by a full fingerprint
        # of everything state() reads, so any mutation is a clean miss.
        self._state_cache: dict = {}

    # -- orientation helpers ------------------------------------------------

    def look_at(self, position, target, up=(0.0, 1.0, 0.0)):
        self.position = np.asarray(position, np.float32)
        view = mx.look_at(self.position, np.asarray(target, np.float32), up, xp=np)
        # Orientation from the view rotation (rows are camera axes).
        self.orientation = mx.quat_from_mat3(view[:3, :3].T)

    # -- projection / fov ----------------------------------------------------

    @property
    def aspect_ratio(self) -> float:
        return self.viewport[0] / self.viewport[1]

    def field_of_view_x(self) -> float:
        """Horizontal FOV in radians, from focal length + sensor width
        (Camera.h's fieldOfView is horizontal)."""
        return 2.0 * np.arctan(self.sensor_size_mm[0] / (2.0 * self.focal_length_mm))

    def set_field_of_view_x(self, fov_x: float):
        self.focal_length_mm = self.sensor_size_mm[0] / (2.0 * np.tan(fov_x / 2.0))

    def field_of_view_y(self) -> float:
        """Vertical FOV derived from horizontal FOV and the *viewport* aspect,
        so the horizontal framing matches the lens regardless of aspect."""
        half_x = np.tan(self.field_of_view_x() / 2.0)
        return 2.0 * np.arctan(half_x / self.aspect_ratio)

    def view_matrix(self) -> np.ndarray:
        rot = mx.quat_to_mat3(self.orientation.astype(np.float32), xp=np).T
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot
        m[:3, 3] = -rot @ self.position
        return m

    def projection_matrix(self, jitter: tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
        proj = mx.perspective_reverse_z(
            self.field_of_view_y(), self.aspect_ratio, self.near, self.far, xp=np
        )
        if jitter != (0.0, 0.0):
            proj = mx.apply_jitter(proj, jitter[0], jitter[1], *self.viewport, xp=np)
        return proj

    # -- exposure --------------------------------------------------------------

    def ev100(self) -> float:
        return calculate_ev100(self.f_number, self.shutter_speed, self.iso)

    def exposure(self) -> float:
        return exposure_from_ev100(self.ev100() - self.exposure_compensation)

    def update_auto_exposure(self, avg_luminance: float, delta_time: float) -> float:
        """Eye-adaption auto exposure: move EV100 toward the metered scene
        luminance (Camera.cpp auto mode). Returns the new exposure."""
        target_ev = float(np.log2(max(avg_luminance, 1e-4) * 100.0 / 12.5))
        cur = self._auto_exposure if self._auto_exposure is not None else target_ev
        rate = 1.0 - np.exp(-delta_time * self.adaption_rate * 60.0)
        self._auto_exposure = cur + (target_ev - cur) * rate
        return exposure_from_ev100(self._auto_exposure - self.exposure_compensation)

    def film_grain_gain(self) -> float:
        """ISO-scaled grain amount (higher ISO = more grain)."""
        return 0.012 * float(np.sqrt(self.iso / 100.0))

    # -- depth of field ---------------------------------------------------------

    def coc_mm_to_px(self) -> float:
        """Circle-of-confusion mm (on sensor) -> render pixels
        (Camera::circleOfConfusionMmToPxFactor)."""
        return self.viewport[0] / self.sensor_size_mm[0]

    def aperture_diameter_mm(self) -> float:
        return self.focal_length_mm / self.f_number

    # -- per-frame state ---------------------------------------------------------

    def state(self, frame_index: int = 0) -> CameraState:
        # Fingerprint of everything this method reads: a static camera hits
        # the cache after one jitter period (zero per-frame H2D transfers;
        # the reference re-uploads its CameraState UBO every frame).
        slot = (frame_index % self.jitter_period) if self.jitter_enabled else -1
        key = (
            self.position.tobytes(), self.orientation.tobytes(),
            tuple(self.viewport), self.focal_length_mm,
            tuple(self.sensor_size_mm),
            self.f_number, self.shutter_speed, self.iso,
            self.exposure_compensation, self.focus_depth, self.near,
            self.far, self.jitter_period, slot,
            None if self._prev_view is None else self._prev_view.tobytes(),
            None if self._prev_proj is None else self._prev_proj.tobytes(),
        )
        cached = self._state_cache.get(key)
        if cached is not None:
            return cached
        if self.jitter_enabled:
            j = self._jitter_seq[frame_index % self.jitter_period]
            jitter = (float(j[0]), float(j[1]))
        else:
            jitter = (0.0, 0.0)
        view = self.view_matrix()
        proj = self.projection_matrix(jitter)
        unjittered = self.projection_matrix()
        prev_view = self._prev_view if self._prev_view is not None else view
        prev_proj = self._prev_proj if self._prev_proj is not None else unjittered
        # CoC scale: coc_px = aperture_px * f * |d - focus| / (d * (focus - f))
        f_m = self.focal_length_mm / 1000.0
        aperture_px = (
            self.aperture_diameter_mm() * self.coc_mm_to_px() * f_m
            / max(self.focus_depth - f_m, 1e-4)
        )
        # ONE batched transfer for all 11 leaves (vs 11 eager jnp.asarray
        # round trips — a moving camera misses the cache every frame, so the
        # miss path matters too).
        st = jax.device_put(CameraState(
            view_from_world=np.asarray(view, np.float32),
            proj_from_view=np.asarray(proj, np.float32),
            unjittered_proj=np.asarray(unjittered, np.float32),
            prev_view_from_world=np.asarray(prev_view, np.float32),
            prev_proj_from_view=np.asarray(prev_proj, np.float32),
            position=np.asarray(self.position, np.float32),
            exposure=np.float32(self.exposure()),
            jitter_px=np.array(jitter, np.float32),
            near=np.float32(self.near),
            focus_depth=np.float32(self.focus_depth),
            aperture_px=np.float32(aperture_px),
        ))
        if len(self._state_cache) >= 4 * self.jitter_period:
            self._state_cache.clear()  # moving camera: bound the cache
        self._state_cache[key] = st
        return st

    def post_render(self):
        """Record previous-frame matrices (Camera::postRender analogue)."""
        self._prev_view = self.view_matrix()
        self._prev_proj = self.projection_matrix()

    def frustum_planes(self) -> np.ndarray:
        vp = self.projection_matrix() @ self.view_matrix()
        return mx.frustum_planes_from_matrix(vp, xp=np)

