"""RenderPipeline: the pass DAG and its compiled frame function.

Role-equivalent to the reference's RenderPipeline + RenderPipelineNode
(arkose/rendering/RenderPipeline.h:11-78, RenderPipelineNode.h:18-66) with
the two-phase construct/execute split kept intact — because that split *is*
XLA's compile/execute model:

  * ``construct_all()``  — every pass declares resources against the Registry
    and returns its execute callback (the reference's
    ``construct(GpuScene&, Registry&) -> ExecuteCallback``). Reconstruction
    on resize / pass changes = re-trace, exactly like the reference rebuilds
    PSOs (VulkanBackend::reconstructRenderPipelineResources).
  * ``compile()``        — traces all execute callbacks into ONE jitted
    frame function ``(state, scene, camera, frame_index) -> state`` with
    donated persistent buffers. Execution order is declared order
    (forEachNodeInResolvedOrder is declared-order in the reference too,
    RenderPipeline.cpp:60-62); Registry edges validate the declaration.

The FrameContext bundles what every node's ExecuteCallback received in the
reference (AppState + scene + upload budget); here it is the scene arrays,
camera state, and frame index as traced values.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.core.types import RasterConfig, SceneLimits
from arkoserenderer.rendering.registry import Registry
from arkoserenderer.scene.camera import CameraState
from arkoserenderer.scene.scene import SceneArrays, SceneStatic


class FrameContext(NamedTuple):
    scene: SceneArrays
    camera: CameraState
    frame_index: jax.Array  # () i32
    delta_time: jax.Array   # () f32 seconds
    row_offset: jax.Array   # () i32 — first screen row of this device's band
                            # (0 unless running under pixel-band SPMD sharding)


@dataclasses.dataclass
class PipelineConfig:
    """Static configuration shared by all passes (viewport, raster tiles)."""

    width: int = 1920
    height: int = 1080
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    limits: SceneLimits = dataclasses.field(default_factory=SceneLimits)
    shadow_map_size: int = 2048
    local_shadow_map_size: int = 512  # per-spot shadow atlas tile
    tonemap_mode: str = "agx"
    # Texture filter: "auto" resolves to "trilinear" (8 taps). Explicit:
    # trilinear | bilinear | stochastic | stochastic1 | anisoN (N bilinear
    # taps marched along the major gradient axis — the reference's 16x
    # sampler anisotropy, VulkanSampler.cpp:66-67; e.g. "aniso4"/"aniso8").
    texture_quality: str = "auto"
    # Deferred-shading path: "packed" = per-triangle record + channel-packed
    # material textures + VSM sun shadows (ops/packed_shading — the fast
    # path, ~1 per-pixel gather for geometry+material); "reference" = the
    # round-1 per-field gather path kept for cross-checking.
    shading_mode: str = "packed"
    # TAA history filter: "catmull" (16-tap Catmull-Rom, the sharp-history
    # quality default) |
    # "bilinear" (4 gathers + a gather-free sub-pixel fast path).
    taa_filter: str = "catmull"
    # Sun shadow receiver filter: "auto" = stochastic single tap under TAA
    # (expectation equals bilinear; moments are prefiltered), else bilinear.
    shadow_filter: str = "auto"
    # Texture LOD bias; drive negative when rendering below display res
    # (the upscale pass sets this — DLSSNode.cpp's global mip bias drive).
    mip_bias: float = 0.0
    # Sky env-map fetch at 1/k resolution then bilinear-upsampled.
    # 1 = full res (default); >1 for budget mode.
    sky_fetch_scale: int = 1
    # RT passes (sun shadow mask / reflections) trace at 1/rt_scale res and
    # reconstruct with nearest-depth upsampling (half-res RT, the standard
    # real-time reconstruction; traversal cost scales with ray count).
    rt_scale: int = 1
    # DDGI probe-volume sampling at 1/k res with nearest-depth upsample
    # (budget knob; 1 = per-pixel probe sampling, the quality default).
    ddgi_sample_scale: int = 1
    # Pixel-band SPMD sharding (SURVEY.md §2.11): when shard_axis is set, the
    # pipeline renders a HORIZONTAL BAND of a taller frame — ``height`` is
    # the band height, ``full_height`` the whole frame, and each device's
    # band position comes from lax.axis_index(shard_axis). Collectives
    # (shadow-map all_gather etc.) ride the named mesh axis.
    shard_axis: str | None = None
    full_height: int | None = None
    shard_count: int = 1
    # Compile-time scene facts (light counts, skinning) — passes specialize
    # on these at construct, like reference nodes specialize on GpuScene&.
    scene: SceneStatic = dataclasses.field(default_factory=SceneStatic)

    @property
    def frame_height(self) -> int:
        return self.full_height if self.full_height is not None else self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


ExecuteFn = Callable[[dict, FrameContext], dict]
# An execute callback maps (frame-state dict, ctx) -> dict of updates.


class RenderPass(abc.ABC):
    """Base pass (RenderPipelineNode analogue)."""

    name: str = "UnnamedPass"

    @abc.abstractmethod
    def construct(self, cfg: PipelineConfig, reg: Registry) -> ExecuteFn:
        ...


class RenderPipeline:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.passes: list[RenderPass] = []
        self.registry = Registry()
        self._executes: list[tuple[str, ExecuteFn]] | None = None
        self._compiled = None
        self._dt_cache: dict[float, jax.Array] = {}
        # Optional traced scene prologue: fn(scene, frame_index, delta_time)
        # -> scene, fused into the frame program: the home for
        # rigid/procedural animation (the reference ticks animations on the
        # CPU, Scene::update; here it moves INTO the jit, with no per-frame
        # host math or pool re-upload).
        # Closures must follow the numpy-constants rule (pixel_centers doc).
        self.scene_animator: Callable | None = None

    def add_pass(self, p: RenderPass) -> "RenderPipeline":
        self.passes.append(p)
        return self

    def construct_all(self):
        """Run every pass's construct against a fresh Registry."""
        self.registry = Registry()
        self._executes = []
        # Screen pixel centers are shared constants every pass may use.
        for p in self.passes:
            self.registry.set_current_node(p.name)
            self._executes.append((p.name, p.construct(self.cfg, self.registry)))
        self.registry.set_current_node(None)
        self._compiled = None
        return self

    def initial_state(self) -> dict[str, jax.Array]:
        assert self._executes is not None, "call construct_all() first"
        return self.registry.initial_state()

    # -- execution ------------------------------------------------------------------

    def frame_fn(
        self,
        state: dict,
        scene: SceneArrays,
        camera: CameraState,
        frame_index: jax.Array,
        delta_time: jax.Array,
    ) -> dict:
        """The traceable frame body: runs all passes in declared order."""
        assert self._executes is not None, "call construct_all() first"
        if self.scene_animator is not None:
            scene = self.scene_animator(
                scene,
                jnp.asarray(frame_index, jnp.int32),
                jnp.asarray(delta_time, jnp.float32),
            )
        if self.cfg.shard_axis is not None:
            row_offset = jax.lax.axis_index(self.cfg.shard_axis) * self.cfg.height
        else:
            row_offset = jnp.zeros((), jnp.int32)
        ctx = FrameContext(
            scene=scene,
            camera=camera,
            frame_index=jnp.asarray(frame_index, jnp.int32),
            delta_time=jnp.asarray(delta_time, jnp.float32),
            row_offset=row_offset,
        )
        state = dict(state)
        for _name, execute in self._executes:
            # named_scope: pass boundaries stay visible inside the FUSED
            # frame in jax.profiler / XLA HLO dumps (the per-node GPU
            # timestamp-label analogue) — utils/timing's per-pass jit is an
            # upper bound; profiles attribute the real fused cost.
            with jax.named_scope(_name):
                updates = execute(state, ctx)
            if updates:
                state.update(updates)
        return state

    def compile(self, donate_state: bool = True):
        """Jit the frame function (donating persistent buffers so history
        updates are in-place on device — the 2-frames-in-flight analogue).

        The cache is keyed by ``donate_state``: donation changes the
        executable's input/output aliasing, and silently handing a caller
        the other variant is a correctness bug (a donating frame fed the
        same args twice is undefined). Note a second variant is a separate
        XLA compile — prefer the default everywhere.
        """
        key = bool(donate_state)
        if self._compiled is None:
            self._compiled = {}
        if key not in self._compiled:
            self._compiled[key] = jax.jit(
                self.frame_fn, donate_argnums=(0,) if donate_state else ()
            )
        return self._compiled[key]

    def _frame_args(self, state, scene, camera_state, frame_index, delta_time):
        # delta_time is almost always the same value every frame; cache its
        # device scalar (one host-to-device copy fewer per frame).
        dt = self._dt_cache.get(delta_time)
        if dt is None:
            dt = self._dt_cache[delta_time] = jnp.asarray(delta_time, jnp.float32)
            if len(self._dt_cache) > 64:
                self._dt_cache.clear()
        return state, scene, camera_state, jnp.asarray(frame_index, jnp.int32), dt

    def render_frame(self, state, scene, camera_state, frame_index, delta_time=1 / 60):
        return self.compile()(*self._frame_args(
            state, scene, camera_state, frame_index, delta_time))

    def compiled_frame(self, state, scene, camera_state, frame_index,
                       delta_time=1 / 60):
        """The frame program compiled for these inputs, as
        ``jax.stages.Compiled`` (``memory_analysis()``, ``cost_analysis()``).
        After a frame with the same shapes this is the executable that
        frame ran, not a second compile."""
        return self.compile().lower(*self._frame_args(
            state, scene, camera_state, frame_index, delta_time)).compile()

    def describe(self) -> str:
        head = " -> ".join(p.name for p in self.passes)
        return f"pipeline [{head}]\n{self.registry.describe()}"


def pixel_centers(cfg: PipelineConfig):
    """(N,) px / (N,) py flattened pixel-center coordinates.

    Returns NUMPY arrays: pass constructors close over these, and a NumPy
    closure becomes a constant of the compiled frame program."""
    xs = (np.arange(cfg.width, dtype=np.float32) + 0.5)
    ys = (np.arange(cfg.height, dtype=np.float32) + 0.5)
    px, py = np.meshgrid(xs, ys)
    return px.ravel(), py.ravel()


def validate_frame(pipeline: "RenderPipeline", state, scene, camera_state,
                   frame_index: int = 0, delta_time: float = 1 / 60) -> list:
    """Per-pass numerical validation — the Vulkan-validation-layer analogue
    (SURVEY §5.2): run the frame ONE PASS AT A TIME (eagerly jitted per
    pass) and report every non-finite value a pass writes, attributed to
    the pass and resource that produced it. A debugging harness, not a hot
    path; returns a list of findings (empty = clean frame).
    """
    import numpy as np

    assert pipeline._executes is not None, "call construct_all() first"
    ctx = FrameContext(
        scene=scene,
        camera=camera_state,
        frame_index=jnp.asarray(frame_index, jnp.int32),
        delta_time=jnp.asarray(delta_time, jnp.float32),
        row_offset=jnp.zeros((), jnp.int32),
    )
    findings = []
    state = dict(state)
    for name, execute in pipeline._executes:
        updates = jax.jit(execute)(state, ctx) or {}
        for key, value in updates.items():
            # A resource may be a pytree (raster setup records, the BVH):
            # validate every floating leaf.
            for path, leaf in jax.tree_util.tree_flatten_with_path(value)[0]:
                arr = np.asarray(leaf)
                if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
                    sub = "".join(str(k) for k in path)
                    findings.append({
                        "pass": name, "resource": key + sub,
                        "non_finite": int((~np.isfinite(arr)).sum()),
                        "shape": tuple(arr.shape),
                    })
        state.update(updates)
    return findings
