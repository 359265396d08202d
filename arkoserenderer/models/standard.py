"""Standard pipeline assemblies — the framework's "flagship models".

Role-equivalent to the reference's app-defined pipelines (ShowcaseApp's node
list, arkose/application/apps/ShowcaseApp.cpp:129-227 — the canonical pass
order per SURVEY.md §3.2). Round 1 implements the forward slice of that
order; RT / DDGI / meshlet passes slot into the same positions as they land.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from arkoserenderer.rendering.pipeline import PipelineConfig, RenderPipeline
from arkoserenderer.rendering.passes import (
    BloomPass,
    CASPass,
    DepthOfFieldPass,
    FXAAPass,
    FogPass,
    GeometryPass,
    LightingComposePass,
    MotionBlurPass,
    OutputPass,
    ScenePass,
    SkyPass,
    SSAOPass,
    SunShadowPass,
    TAAPass,
    VisibilityShadingPass,
)
from arkoserenderer.scene.camera import Camera
from arkoserenderer.scene.scene import Scene


def make_forward_pipeline(
    cfg: PipelineConfig,
    *,
    taa: bool = True,
    bloom: bool = True,
    shadows: bool = True,
    ssao: bool = False,
    fog: bool = False,
    motion_blur: bool = False,
    depth_of_field: bool = False,
    fxaa: bool = False,
    cas: bool = False,
    rt_shadows: bool = False,
    rt_reflections: bool = False,
    ddgi=None,  # a ddgi.ProbeGridConfig enables probe GI
    ddgi_probe_debug: bool = False,  # splat probes over the final image
    light_icons: bool = False,       # lightbulb billboards at light positions
    ssss: bool = False,
    rt_refit: bool = False,  # per-frame BVH refit for animated geometry
    oit_layers: int = 1,     # translucent depth-peeling layer count
    upscale_to: tuple[int, int] | None = None,  # display res (DLSS slot)
    upscale_mode: str = "temporal",  # "temporal" (TAA-U, the honest DLSS
    #   equivalent: render-res TAA off, jittered frames accumulate straight
    #   into display-res history) | "spatial" (TAA + FSR1-style resample)
    film_grain: float = 0.0,
    vignette: float = 0.18,  # 0 disables (the truth harness compares vs PT)
    debug_draw=None,  # a DebugLineBuffer enables the overlay pass
) -> RenderPipeline:
    """The raster backbone of the Showcase node order
    (ShowcaseApp.cpp:129-227): visibility-buffer raster -> [DDGI] ->
    shadow (mapped or ray-traced) -> deferred shade -> RT reflections ->
    SSAO -> lighting compose -> sky -> fog -> motion blur -> DoF -> bloom ->
    TAA -> tonemap [-> FXAA -> CAS]."""
    if cfg.texture_quality == "auto" or cfg.shadow_filter == "auto":
        import dataclasses

        repl = {}
        if cfg.texture_quality == "auto":
            # Full trilinear filtering by default; stochastic single-tap
            # remains available as a knob.
            repl["texture_quality"] = "trilinear"
        if cfg.shadow_filter == "auto":
            # Deterministic bilinear VSM moments (no TAA dependence).
            repl["shadow_filter"] = "bilinear"
        cfg = dataclasses.replace(cfg, **repl)
    if upscale_to is not None and cfg.mip_bias == 0.0:
        # DLSS-style global mip bias: sharpen texture LOD by the render/
        # display ratio (DLSSNode.cpp mip-bias drive).
        import dataclasses
        import math

        cfg = dataclasses.replace(
            cfg, mip_bias=math.log2(cfg.width / upscale_to[0])
        )
    pipe = RenderPipeline(cfg)
    pipe.add_pass(ScenePass())
    pipe.add_pass(GeometryPass())
    if rt_refit and (rt_shadows or rt_reflections or ddgi is not None):
        from arkoserenderer.rendering.passes.rt import BVHRefitPass

        pipe.add_pass(BVHRefitPass())
    if ddgi is not None:
        from arkoserenderer.rendering.passes.ddgi import DDGIPass

        pipe.add_pass(DDGIPass(ddgi))
    spot_casters = cfg.scene.spot_shadow_casters
    point_casters = cfg.scene.point_shadow_casters
    if rt_shadows:
        from arkoserenderer.rendering.passes.rt import (
            RTLocalShadowPass,
            RTShadowPass,
        )

        pipe.add_pass(RTShadowPass())
        if any(spot_casters) or any(point_casters):
            # Exact per-pixel local-light shadows (RTLocalShadowNode) —
            # replaces the PCF atlas whenever the frame traces rays anyway.
            pipe.add_pass(RTLocalShadowPass(
                spot_casters, point_casters,
                spot_radii=cfg.scene.spot_source_radius,
                point_radii=cfg.scene.point_source_radius,
            ))
    elif shadows:
        pipe.add_pass(SunShadowPass())
    if (shadows and not rt_shadows and any(cfg.scene.spot_shadow_casters)
            and cfg.scene.n_spots > 0):
        from arkoserenderer.rendering.passes.shadow import LocalShadowPass

        pipe.add_pass(LocalShadowPass())
    pipe.add_pass(VisibilityShadingPass())
    if rt_reflections:
        from arkoserenderer.rendering.passes.rt import RTReflectionsPass

        pipe.add_pass(RTReflectionsPass(ddgi_grid=ddgi))
    if ssao:
        pipe.add_pass(SSAOPass())
    pipe.add_pass(LightingComposePass(ddgi_grid=ddgi))
    if ssss:
        from arkoserenderer.rendering.passes.ssss import SSSSPass

        pipe.add_pass(SSSSPass())
    pipe.add_pass(SkyPass())
    if cfg.scene.has_translucent:
        from arkoserenderer.rendering.passes.translucent import TranslucentPass

        pipe.add_pass(TranslucentPass(layers=oit_layers))
    if fog:
        pipe.add_pass(FogPass())
    if motion_blur:
        pipe.add_pass(MotionBlurPass())
    if depth_of_field:
        pipe.add_pass(DepthOfFieldPass())
    if bloom:
        pipe.add_pass(BloomPass())
    temporal_upscale = upscale_to is not None and upscale_mode == "temporal"
    if taa and not temporal_upscale:
        # TSR subsumes TAA: jitter must survive to the accumulator
        # (DLSSNode replaces TAANode in the showcase order).
        pipe.add_pass(TAAPass())
    pipe.add_pass(OutputPass(film_grain_gain=film_grain,
                             vignette_intensity=vignette))
    if fxaa:
        pipe.add_pass(FXAAPass())
    if cas:
        pipe.add_pass(CASPass())
    if upscale_to is not None:
        if temporal_upscale:
            from arkoserenderer.rendering.passes.upscale import (
                TemporalUpscalePass,
            )

            pipe.add_pass(TemporalUpscalePass(*upscale_to))
        else:
            from arkoserenderer.rendering.passes.upscale import UpscalePass

            pipe.add_pass(UpscalePass(*upscale_to))
    if debug_draw is not None:
        from arkoserenderer.rendering.passes.debugdraw import DebugDrawPass

        pipe.add_pass(DebugDrawPass(debug_draw))
    if ddgi_probe_debug and ddgi is not None:
        from arkoserenderer.rendering.passes.ddgi_debug import DDGIProbeDebugPass

        pipe.add_pass(DDGIProbeDebugPass(ddgi))
    if light_icons:
        from arkoserenderer.rendering.passes.icons import IconBillboardPass

        pipe.add_pass(IconBillboardPass())
    pipe.construct_all()
    return pipe


class Renderer:
    """Simple host-side frame loop driver (the Arkose::runArkoseApplication
    analogue, minus windowing): owns the pipeline, persistent frame state,
    and camera prev-frame bookkeeping."""

    @property
    def scene_arrays(self):
        return self._scene_arrays

    @scene_arrays.setter
    def scene_arrays(self, value):
        # Any scene-data swap (streaming, transform updates, physics
        # commits) bumps the version scalar that invalidates cached
        # frame-spanning resources (the static sun shadow map).
        self._scene_arrays = value
        self._scene_version = getattr(self, "_scene_version", -1) + 1

    def __init__(
        self, scene: Scene, camera: Camera, cfg: PipelineConfig,
        debug_draw: bool = False, auto_exposure: bool = False,
        dynamic_transforms: bool = False, scene_animator=None, **pipeline_kw,
    ):
        # scene_animator: traced fn(scene_arrays, frame_index, delta_time)
        # -> scene_arrays fused into the frame program (device-side rigid
        # animation — see RenderPipeline.scene_animator). Implies dynamic
        # geometry (prev-position lanes, per-frame shadow raster) WITHOUT
        # the host update/upload path of dynamic_transforms.
        self.scene_animator = scene_animator
        if scene_animator is not None:
            dynamic_transforms_static = True
        else:
            dynamic_transforms_static = dynamic_transforms
        # dynamic_transforms: re-upload instance matrices/bounds every frame
        # (physics / editor-moved rigid bodies) — an incremental upload, not
        # a scene rebuild; see Scene.update_instance_transforms.
        self.dynamic_transforms = dynamic_transforms
        self.auto_exposure = auto_exposure
        import dataclasses

        self.scene = scene
        self.camera = camera
        static = scene.static_info()
        if dynamic_transforms_static:
            static = dataclasses.replace(static, dynamic=True)
        self.cfg = dataclasses.replace(cfg, scene=static)
        self.debug = None
        if debug_draw:
            from arkoserenderer.rendering.passes.debugdraw import DebugLineBuffer

            self.debug = DebugLineBuffer()
            pipeline_kw["debug_draw"] = self.debug
        if pipeline_kw.get("ddgi") is True:
            # Fit the probe grid to the scene bounds (Scene::generateProbeGrid).
            from arkoserenderer.ops.ddgi import ProbeGridConfig

            center, radius = scene.bounding_sphere()
            pipeline_kw["ddgi"] = ProbeGridConfig.fit_bounds(center, radius)
        use_rt = bool(
            pipeline_kw.get("rt_shadows")
            or pipeline_kw.get("rt_reflections")
            or pipeline_kw.get("ddgi")
        )
        if use_rt and "rt_refit" not in pipeline_kw and (
            self.cfg.scene.has_skin or self.cfg.scene.has_morphs
        ):
            pipeline_kw["rt_refit"] = True  # animated geometry: refit per frame
        self._pipeline_kw = dict(pipeline_kw)   # for hot-reload rebuilds
        self.pipeline = make_forward_pipeline(self.cfg, **pipeline_kw)
        self.pipeline.scene_animator = self.scene_animator
        self.scene_arrays = scene.build(with_bvh=use_rt)
        self.state = self.pipeline.initial_state()
        self.frame_index = 0
        self.time = 0.0

    def render_frame(self, delta_time: float = 1 / 60) -> jax.Array:
        if self.dynamic_transforms:
            self.scene_arrays = self.scene.update_instance_transforms(
                self.scene_arrays
            )
        if self.cfg.scene.has_skin or self.cfg.scene.has_morphs:
            # Host animation -> palette + morph-weight upload
            # (Scene::update analogue).
            palette = self.scene.update_animations(self.time)
            self.scene_arrays = self.scene_arrays._replace(
                palette=jnp.asarray(palette),
                morph_weights=tuple(
                    jnp.asarray(np.asarray(w, np.float32))
                    for w in self.scene._morph_weights_list
                ),
            )
        self.state = self.pipeline.render_frame(*self._frame_inputs())
        self.camera.post_render()
        if self.auto_exposure and "Metering.avgLum" in self.state:
            # Eye-adaption loop: metered pre-exposed luminance -> relative EV
            # nudge (Camera auto-exposure mode, Camera.cpp auto path).
            avg = float(np.asarray(self.state["Metering.avgLum"]))
            self.camera.exposure_compensation += float(
                np.clip(np.log2(0.18 / max(avg, 1e-6)), -4, 4)
            ) * min(self.camera.adaption_rate * 60.0 * delta_time * 20, 1.0)
            self.camera.exposure_compensation = float(
                np.clip(self.camera.exposure_compensation, -8.0, 8.0)
            )
        self.frame_index += 1
        self.time += delta_time
        # NOTE: the returned array's buffer may be recycled by the NEXT
        # render (persistent-state donation). Use np.array(...) to keep a
        # frame across renders; np.asarray views alias device memory.
        if "LDRDisplay" in self.state:  # upscaled pipelines: display res
            return self.state["LDRDisplay"]
        return self.state["LDR"]

    def _frame_inputs(self):
        """(state inputs, scene arrays, camera state, frame index) of the
        next frame."""
        # Feed back ONLY persistent resources: transients are recomputed by
        # their producing passes, and a stable input pytree keeps the pjit
        # cache hot (no per-frame retrace). self.state still holds the full
        # frame output for inspection/tests.
        persistent = self.pipeline.registry.persistent_names
        inputs = {k: self.state[k] for k in persistent if k in self.state}
        if "scene.version" in persistent:
            inputs["scene.version"] = jnp.asarray(self._scene_version, jnp.int32)
        if self.debug is not None:
            inputs["debug.lines"] = self.debug.arrays()
        cam_state = self.camera.state(self.frame_index)
        return inputs, self.scene_arrays, cam_state, self.frame_index

    def compiled_frame(self):
        """The compiled frame program (``jax.stages.Compiled``) for the next
        frame's inputs; free once a frame has run."""
        return self.pipeline.compiled_frame(*self._frame_inputs())

    def render_frame_safe(self, delta_time: float = 1 / 60, retries: int = 2):
        """Frame execution with recovery (the AppBase frame-retry loop +
        swapchain-recreate analogue, AppBase.cpp:27-34 /
        VulkanBackend.cpp:1808-1817): on a device/compile failure the
        pipeline is reconstructed and retraced, persistent state is kept
        (device buffers are re-uploaded from host copies), and the frame is
        retried before giving up."""
        for attempt in range(retries + 1):
            try:
                return self.render_frame(delta_time)
            except Exception:
                if attempt == retries:
                    raise
                self.reconstruct()

    def reconstruct(self, rebuild_passes: bool = False):
        """Rebuild the compiled pipeline and retrace, preserving persistent
        state (the ``reconstructRenderPipelineResources`` analogue,
        VulkanBackend.cpp:2327-2347: new Registry + constructAll, reusing
        matching resources from the previous one). Used by the frame-retry
        recovery loop and by HOT RELOAD (utils/hotreload: changed pass/op
        modules are re-imported, then ``rebuild_passes=True`` re-instantiates
        every pass from the RELOADED classes and re-jits the frame)."""
        host = {k: np.array(v) for k, v in self.state.items()
                if k in self.pipeline.registry.persistent_names}
        if rebuild_passes:
            # Fresh pass instances from the (possibly reloaded) modules.
            import importlib

            import arkoserenderer.models.standard as _std

            _std = importlib.import_module(_std.__name__)
            self.pipeline = _std.make_forward_pipeline(
                self.cfg, **self._pipeline_kw
            )
        self.pipeline.scene_animator = self.scene_animator
        self.pipeline.construct_all()
        fresh = self.pipeline.initial_state()
        fresh.update({
            k: jnp.asarray(v) for k, v in host.items()
            if k in fresh and fresh[k].shape == v.shape
        })
        self.state = fresh

    def save_checkpoint(self, path: str):
        """Persist the resumable frame state (TAA history, DDGI atlases +
        relocation offsets, reflection history, auto-exposure) — the
        renderer-side analogue of the reference's versioned persistent
        assets (SURVEY.md §6.4): a later session resumes temporal
        accumulation instead of restarting it."""
        persist = {
            f"state.{k}": np.asarray(self.state[k])
            for k in self.pipeline.registry.persistent_names
            if k in self.state
        }
        np.savez_compressed(
            path,
            __meta__=np.array([self.frame_index, self.time,
                               self.camera.exposure_compensation], np.float64),
            **persist,
        )

    def load_checkpoint(self, path: str):
        z = np.load(path)
        meta = z["__meta__"]
        self.frame_index = int(meta[0])
        self.time = float(meta[1])
        self.camera.exposure_compensation = float(meta[2])
        for k in self.pipeline.registry.persistent_names:
            key = f"state.{k}"
            if key in z:
                self.state[k] = jnp.asarray(z[key])

    def render_frames(self, n: int) -> jax.Array:
        for _ in range(n):
            out = self.render_frame()
        return out

    def pick(self, x: int, y: int) -> dict:
        """Readback picking (PickingNode analogue, arkose/rendering/nodes/
        PickingNode.cpp): returns the instance / triangle / depth under the
        pixel, plus the focus distance for autofocus."""
        vis = int(np.asarray(self.state["Visibility"])[y, x])
        depth = float(np.asarray(self.state["SceneDepth"])[y, x])
        if vis < 0:
            return {"instance": -1, "triangle": -1, "depth": depth, "distance": None}
        # Visibility stores setup-row ids (near-clipped sub-triangles live
        # past the scene triangle pool); map back to the original triangle.
        tri = int(np.asarray(self.state["vis.setup"].orig_tri)[vis])
        inst = int(np.asarray(self.scene_arrays.tri_instance)[tri])
        distance = self.camera.near / max(depth, 1e-8)
        return {"instance": inst, "triangle": tri, "depth": depth, "distance": distance}

    def benchmark(self, warmup: int = 3, iters: int = 10) -> dict:
        """Steady-state ms/frame with blocking sync (per-pass timing lives in
        utils/timing.py)."""
        for _ in range(warmup):
            jax.block_until_ready(self.render_frame())
        t0 = time.perf_counter()
        for _ in range(iters):
            out = self.render_frame()
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        return {"ms_per_frame": dt * 1e3, "fps": 1.0 / dt}
