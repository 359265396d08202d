"""Multi-chip SPMD rendering: pixel-band sharding over a device mesh.

The reference is a single-GPU renderer; its parallelism inventory maps to
several devices as laid out in SURVEY.md §2.11: the framebuffer is
data-parallel over pixels, so we shard every screen-space tensor by ROWS
over a 1-D ``jax.sharding.Mesh`` axis ("px") with ``shard_map``, replicate
the scene arrays (placed on every device once, at construction), and let
the few cross-band exchanges run as XLA collectives (NCCL over NVLink on a
multi-GPU host, where every card reaches every other at the same rate, so
the mesh stays 1-D):

  * each device rasterizes + shades its own horizontal band (no comm);
  * the sun shadow map is rasterized in bands and ``all_gather``-ed so any
    band can sample anywhere (rendering/passes/shadow.py);
  * post passes run band-local, with halo exchange via ``ppermute`` where a
    kernel's support crosses the band seam (bloom pyramid:
    rendering/passes/bloom.py:44, seam-exact and test-enforced; soft-shadow
    denoiser guides likewise since round 4).

Scaling knobs beyond DP (ray-batch sharding for the RT passes, probe-batch
sharding for DDGI) plug into the same mesh when those passes land.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from arkoserenderer.models.standard import make_forward_pipeline
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.camera import Camera
from arkoserenderer.scene.scene import Scene

AXIS = "px"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (AXIS,))


def band_config(cfg: PipelineConfig, n_devices: int) -> PipelineConfig:
    """Full-frame config -> per-device band config. Each band must be a
    whole number of raster tile rows (1080 rows do not split over 4 devices:
    270 is not a multiple of 8; 1152 do)."""
    band_h, rem = divmod(cfg.height, n_devices)
    if rem or band_h % cfg.raster.tile_h:
        raise ValueError(
            f"{cfg.height} rows do not split into {n_devices} bands of whole "
            f"{cfg.raster.tile_h}-row tiles")
    if cfg.shadow_map_size % (n_devices * cfg.raster.tile_h):
        raise ValueError(
            f"shadow map {cfg.shadow_map_size} does not split into "
            f"{n_devices} bands of whole tiles")
    return dataclasses.replace(
        cfg,
        height=band_h,
        full_height=cfg.height,
        shard_axis=AXIS,
        shard_count=n_devices,
    )


class ShardedRenderer:
    """Renderer running one frame as a shard_map over a pixel-band mesh.

    Persistent state (TAA history, ...) lives row-sharded across devices and
    is donated every frame; the LDR output comes back row-sharded and is
    gathered lazily on host read.
    """

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        cfg: PipelineConfig,
        n_devices: int | None = None,
        **pipeline_kw,
    ):
        self.mesh = make_mesh(n_devices)
        n = self.mesh.devices.size
        cfg = dataclasses.replace(cfg, scene=scene.static_info())
        self.cfg = cfg
        self.band_cfg = band_config(cfg, n)
        if pipeline_kw.get("ddgi") is True:
            from arkoserenderer.ops.ddgi import ProbeGridConfig

            center, radius = scene.bounding_sphere()
            pipeline_kw["ddgi"] = ProbeGridConfig.fit_bounds(center, radius)
        use_rt = bool(
            pipeline_kw.get("rt_shadows")
            or pipeline_kw.get("rt_reflections")
            or pipeline_kw.get("ddgi")
        )
        self.pipeline = make_forward_pipeline(self.band_cfg, **pipeline_kw)
        self.scene = scene
        self.camera = camera
        # Replicated once: every device holds the whole scene from here on,
        # so no frame re-broadcasts it.
        self._replicated = jax.sharding.NamedSharding(self.mesh, P())
        self.scene_arrays = jax.device_put(scene.build(with_bvh=use_rt),
                                           self._replicated)
        self.persistent = list(self.pipeline.registry.persistent_names)

        pipe = self.pipeline

        def step(state, scene_arrays, cam_state, frame_index, delta_time):
            out = pipe.frame_fn(state, scene_arrays, cam_state, frame_index, delta_time)
            keep = {k: out[k] for k in self.persistent}
            keep["LDR"] = out["LDR"]
            return keep

        # Per-resource partition specs: screen tensors (leading dim == the
        # band height) are row-sharded; everything else that persists —
        # scalars (scene/shadow version counters) and full-size shared maps
        # (the cached sun shadow map is all_gather-ed, so every device holds
        # an identical copy) — is replicated.
        band_h = self.band_cfg.height

        def spec_of(desc):
            if len(desc.shape) >= 1 and desc.shape[0] == band_h:
                return P(AXIS)
            return P()

        state_specs = {
            name: spec_of(pipe.registry._resources[name])
            for name in self.persistent
        }
        out_specs = dict(state_specs)
        out_specs["LDR"] = P(AXIS)
        repl = P()
        self._step = jax.jit(
            jax.shard_map(
                step,
                mesh=self.mesh,
                in_specs=(state_specs, repl, repl, repl, repl),
                out_specs=out_specs,
                check_vma=False,
            ),
            donate_argnums=(0,),
        )

        # Initial persistent state: full-frame clears sharded over rows for
        # screen tensors, replicated placement for the rest.
        self.state = {}
        for name in self.persistent:
            desc = pipe.registry._resources[name]
            if state_specs[name] == P(AXIS):
                full_shape = (cfg.height,) + tuple(desc.shape[1:])
            else:
                full_shape = tuple(desc.shape)
            host = np.full(full_shape, desc.clear, desc.dtype)
            self.state[name] = jax.device_put(
                host, jax.sharding.NamedSharding(self.mesh, state_specs[name])
            )
        self.frame_index = 0
        self._ldr = None

    def render_frame(self):
        cam_state = jax.device_put(self.camera.state(self.frame_index),
                                   self._replicated)
        if "scene.version" in self.persistent:
            self.state["scene.version"] = jax.device_put(
                np.int32(getattr(self, "_scene_version", 0)), self._replicated)
        out = self._step(
            self.state,
            self.scene_arrays,
            cam_state,
            *jax.device_put((np.int32(self.frame_index), np.float32(1 / 60)),
                            self._replicated),
        )
        self._ldr = out.pop("LDR")
        self.state = out
        self.camera.post_render()
        self.frame_index += 1
        return self._ldr
