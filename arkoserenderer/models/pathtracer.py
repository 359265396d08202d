"""PathTracer driver — the PathTracerApp analogue.

Owns the scene BVH (two-level TLAS/BLAS, ops/bvh.py), a
persistent accumulation buffer, and the progressive sampling loop; the
accumulation resets whenever the host moves the camera, matching
PathTracerNode's reset-on-camera-move behavior (PathTracerNode.cpp:81-103).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.ops import tonemap as tm
from arkoserenderer.ops.pathtrace import trace_path
from arkoserenderer.ops.texture import linear_to_srgb
from arkoserenderer.scene.camera import Camera
from arkoserenderer.scene.scene import Scene, SceneArrays


def world_space_vertices(arrays: SceneArrays) -> np.ndarray:
    """Apply per-instance transforms to the vertex pool (host side)."""
    pos = np.asarray(arrays.positions)
    inst = np.asarray(arrays.vertex_instance)
    w = np.asarray(arrays.world)[inst]
    return np.einsum("vij,vj->vi", w[:, :3, :3], pos) + w[:, :3, 3]


class PathTracer:
    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        width: int,
        height: int,
        max_bounces: int = 3,
        tonemap_mode: str = "agx",
        seed: int = 0,
        aa: bool = True,
    ):
        # aa=False samples exact pixel centers (no sub-pixel jitter): the
        # truth-harness mode where PT and the raster pipeline see the same
        # primary rays, so per-pixel comparison is apples-to-apples
        # (tests/test_truth.py).
        self.scene = scene
        self.camera = camera
        self.width = width
        self.height = height
        self.arrays = scene.build(with_bvh=True)
        self.bvh = self.arrays.bvh  # two-level TLAS/BLAS (ops/bvh.py)
        xs = np.arange(width, dtype=np.float32) + 0.5
        ys = np.arange(height, dtype=np.float32) + 0.5
        pxg, pyg = np.meshgrid(xs, ys)
        # numpy on purpose: the jitted step closes over px/py, and closures
        # become program constants (rendering/pipeline.pixel_centers).
        self._px = pxg.ravel()
        self._py = pyg.ravel()
        self._mode = tm.MODES[tonemap_mode]
        self._seed = seed
        self.accum = jnp.asarray(np.zeros((height * width, 3), np.float32))
        self.sample_count = 0
        self._cam_sig = None

        px, py, w, h = self._px, self._py, width, height

        n_spots = len(scene.spots)
        n_points = len(scene.points)
        spot_casters = tuple(bool(s.cast_shadows) for s in scene.spots)
        point_casters = tuple(
            bool(getattr(p, "cast_shadows", False)) for p in scene.points
        )
        # Soft-shadow statics (truth harness for the raster's sigma-denoised
        # stochastic shadows): sun disk + light source radii.
        sun_cos_radius = float(np.cos(np.radians(
            getattr(scene.sun, "angular_radius_deg", 0.0)
        ))) if scene.sun is not None else 1.0
        spot_radii = tuple(
            float(getattr(s, "source_radius", 0.0)) for s in scene.spots
        )
        point_radii = tuple(
            float(getattr(p, "source_radius", 0.0)) for p in scene.points
        )

        @jax.jit
        def step(accum, arrays, bvh, cam_state, seed, sample_idx):
            # Key derivation inside jit: no eager PRNG ops on the device.
            key = jax.random.fold_in(jax.random.PRNGKey(seed), sample_idx)
            sample = trace_path(arrays, bvh, cam_state, px, py, w, h, key,
                                max_bounces, aa=aa,
                                n_spots=n_spots, n_points=n_points,
                                spot_casters=spot_casters,
                                point_casters=point_casters,
                                sun_cos_radius=sun_cos_radius,
                                spot_source_radius=spot_radii,
                                point_source_radius=point_radii)
            return accum + sample

        self._step = step

    def _camera_signature(self):
        return (
            tuple(np.asarray(self.camera.position).ravel().tolist()),
            tuple(np.asarray(self.camera.orientation).ravel().tolist()),
            self.camera.focal_length_mm,
        )

    def reset(self):
        self.accum = jnp.asarray(np.zeros((self.height * self.width, 3), np.float32))
        self.sample_count = 0

    def render_sample(self, n_samples: int = 1):
        sig = self._camera_signature()
        if sig != self._cam_sig:
            self._cam_sig = sig
            self.reset()
        cam_state = self.camera.state(0)
        for _ in range(n_samples):
            self.accum = self._step(
                self.accum, self.arrays, self.bvh, cam_state,
                self._seed, self.sample_count,
            )
            self.sample_count += 1
        return self.radiance()

    def save_checkpoint(self, path: str):
        """Resumable accumulation (PathTracerNode.cpp:81-103's accumulation
        buffer is the reference's one resumable computation — ours survives
        process restarts)."""
        np.savez_compressed(
            path, accum=np.asarray(self.accum),
            count=np.array([self.sample_count, self._seed], np.int64),
        )

    def load_checkpoint(self, path: str):
        z = np.load(path)
        self.accum = jnp.asarray(z["accum"])
        self.sample_count = int(z["count"][0])
        self._seed = int(z["count"][1])
        self._cam_sig = self._camera_signature()  # don't reset on next sample

    def radiance(self) -> jax.Array:
        """(H, W, 3) mean pre-exposed radiance so far."""
        n = max(self.sample_count, 1)
        return (self.accum / n).reshape(self.height, self.width, 3)

    def ldr(self) -> jax.Array:
        c = tm.tonemap(jnp.maximum(self.radiance(), 0.0), self._mode)
        return jnp.clip(linear_to_srgb(c), 0.0, 1.0)
