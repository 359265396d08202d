"""Post-chain passes: SSAO, LightingCompose, Fog, MotionBlur, DoF, FXAA, CAS.

Each wraps a kernel from ops/ — see ops/ssao.py and ops/postprocess.py for
the reference-node mapping. Pass order in the flagship pipeline mirrors
ShowcaseApp (arkose/application/apps/ShowcaseApp.cpp:129-227).
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.ops import postprocess as pp
from arkoserenderer.ops import ssao as ssao_ops
from arkoserenderer.ops.envmap import average_radiance
from arkoserenderer.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer.rendering.registry import Registry


class SSAOPass(RenderPass):
    name = "SSAO"

    def __init__(self, num_samples: int = 16, radius: float = 0.5,
                 intensity: float = 1.0, temporal: bool | None = None,
                 samples_per_frame: int = 2):
        self.kernel = ssao_ops.make_ssao_kernel(num_samples)
        self.radius = radius
        self.intensity = intensity
        # None = auto: stochastic 2-sample estimator when TAA runs after us
        # (it converges the variance); full kernel otherwise.
        self.temporal = temporal
        self.samples_per_frame = samples_per_frame

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("SceneNormal")
        reg.get("SceneCoverage")
        reg.create("SSAO", (h, w), jnp.float32, clear=1.0)
        px, py = pixel_centers(cfg)
        full_h = cfg.frame_height
        kernel, radius, intensity = self.kernel, self.radius, self.intensity
        temporal = self.temporal
        if temporal is None:
            temporal = cfg.texture_quality in ("stochastic", "stochastic1")
        spf = self.samples_per_frame if temporal else None

        shard_axis = cfg.shard_axis
        n_shards = cfg.shard_count

        def execute(state: dict, ctx: FrameContext) -> dict:
            import jax as _jax

            py_global = py + ctx.row_offset.astype(py.dtype)
            depth = state["SceneDepth"]
            # Pixel-band SPMD: kernel samples can land in neighbor bands, so
            # occlusion fetches read the all_gather-ed full-frame depth (one
            # (full_h, W) f32 exchange over ICI) — band-exact, no clamping.
            sample_depth = (
                _jax.lax.all_gather(depth, shard_axis, axis=0, tiled=True)
                if shard_axis is not None else None
            )
            ao = ssao_ops.ssao(
                depth,
                state["SceneNormal"].reshape(-1, 3),
                state["SceneCoverage"].reshape(-1),
                px, py_global,
                ctx.camera.unjittered_view_proj,
                ctx.camera.near,
                w, full_h,
                kernel, radius=radius, intensity=intensity,
                samples_per_frame=spf, frame_index=ctx.frame_index,
                sample_depth=sample_depth,
            )
            from arkoserenderer.ops.image import band_halo_rows, blur3

            ao_img = ao.reshape(h, w)[..., None]
            halo = (
                band_halo_rows(ao_img, shard_axis, n_shards)
                if shard_axis is not None else None
            )
            return {"SSAO": blur3(ao_img, halo_rows=halo)[..., 0]}

        return execute


class LightingComposePass(RenderPass):
    """Indirect/ambient composition (LightingComposeNode analogue,
    arkose/rendering/lighting/LightingComposeNode.cpp): direct light (already
    in SceneColor) + diffuse GI — DDGI-sampled irradiance when the DDGI pass
    is in the pipeline, flat env ambient otherwise — modulated by material
    occlusion and SSAO. Glossy reflections compose here too when present."""

    name = "LightingCompose"

    def __init__(self, ddgi_grid=None):
        self.ddgi_grid = ddgi_grid

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneBaseColor")
        reg.get("SceneMaterial")
        reg.get("SceneCoverage")
        use_ssao = reg.has("SSAO")
        if use_ssao:
            reg.get("SSAO")
        use_ddgi = self.ddgi_grid is not None and reg.has("DDGI.irradiance")
        use_refl = reg.has("SceneReflections")
        if use_refl:
            reg.get("SceneReflections")
        grid = self.ddgi_grid
        reg.get("SceneNormal")  # DDGI probe lookup or SH env irradiance
        if use_ddgi:
            reg.get("DDGI.irradiance")
            reg.get("DDGI.offsets")
            reg.get("DDGI.visibility")
            reg.get("SceneDepth")
            # Optional half-res probe sampling + nearest-depth upsample
            # (full-res is the quality default; cfg.ddgi_sample_scale=2 is
            # the budget mode).
            ddgi_scale = (
                cfg.ddgi_sample_scale
                if (h % cfg.ddgi_sample_scale == 0 and w % cfg.ddgi_sample_scale == 0)
                else 1
            )
            import numpy as _np

            hs, ws = h // ddgi_scale, w // ddgi_scale
            xs = (_np.arange(ws, dtype=_np.float32) * ddgi_scale + 0.5)
            ys = (_np.arange(hs, dtype=_np.float32) * ddgi_scale + 0.5)
            pxg, pyg = _np.meshgrid(xs, ys)
            px = pxg.ravel()   # numpy: closures become program constants
            py = pyg.ravel()
        full_h = cfg.frame_height

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"]
            base = state["SceneBaseColor"]
            mat = state["SceneMaterial"]  # roughness, metallic, occlusion
            valid = state["SceneCoverage"][..., None]
            exposure = ctx.camera.exposure

            if use_ddgi:
                from arkoserenderer.ops import ddgi as ddgi_ops
                from arkoserenderer.ops.ssao import reconstruct_world_pos

                py_g = py + ctx.row_offset.astype(py.dtype)
                inv_vp = jnp.linalg.inv(ctx.camera.unjittered_view_proj)
                depth_full = state["SceneDepth"]
                depth_s = (depth_full[::ddgi_scale, ::ddgi_scale]
                           if ddgi_scale > 1 else depth_full)
                world = reconstruct_world_pos(
                    depth_s.reshape(-1), px, py_g, inv_vp, w, full_h
                )
                st = ddgi_ops.DDGIState(
                    irradiance=state["DDGI.irradiance"],
                    visibility=state["DDGI.visibility"],
                    offsets=state["DDGI.offsets"],
                )
                nrm_full = state["SceneNormal"]
                nrm = (nrm_full[::ddgi_scale, ::ddgi_scale]
                       if ddgi_scale > 1 else nrm_full).reshape(-1, 3)
                # Sky half-cells carry zero normals; a valid full pixel may
                # still inherit such a cell through the depth-guided
                # upsample, so sanitize (octahedral encode of the zero
                # vector is NaN).
                nrm_ok = jnp.sum(nrm * nrm, -1, keepdims=True) > 0.25
                nrm = jnp.where(nrm_ok, nrm, jnp.array([0.0, 1.0, 0.0]))
                ambient = ddgi_ops.sample_irradiance(st, grid, world, nrm)
                if ddgi_scale > 1:
                    from arkoserenderer.ops.image import upsample_nearest_depth

                    ambient = upsample_nearest_depth(
                        ambient.reshape(hs, ws, 3), depth_s, depth_full
                    )
                else:
                    ambient = ambient.reshape(h, w, 3)
            else:
                # SH-2 env irradiance per normal (Ramamoorthi-Hanrahan) —
                # directional ambient instead of a flat average, so upward
                # surfaces see the (brighter) sky hemisphere. Matches the
                # path tracer's sky term far better than the flat estimate.
                from arkoserenderer.ops.envmap import ambient_of_normal

                nrm = state["SceneNormal"].reshape(-1, 3)
                ambient = ambient_of_normal(
                    ctx.scene.env_map, nrm, ctx.scene.env_brightness
                ).reshape(h, w, 3)
                ambient = (ambient + ctx.scene.lights.ambient_lx / jnp.pi) * exposure

            ao = mat[..., 2:3]
            if use_ssao:
                ao = ao * state["SSAO"][..., None]
            diffuse = base * (1.0 - mat[..., 1:2])
            out = color + jnp.where(valid, diffuse * ambient * ao, 0.0)
            if use_refl:
                out = out + jnp.where(valid, state["SceneReflections"], 0.0)
            return {"SceneColor": out}

        return execute


class FogPass(RenderPass):
    name = "Fog"

    def __init__(self, density: float = 0.02, height_falloff: float = 0.05):
        self.density = density
        self.height_falloff = height_falloff

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneCoverage")
        px, py = pixel_centers(cfg)
        full_h = cfg.frame_height
        density, falloff = self.density, self.height_falloff

        def execute(state: dict, ctx: FrameContext) -> dict:
            py_global = py + ctx.row_offset.astype(py.dtype)
            inv_vp = jnp.linalg.inv(ctx.camera.unjittered_view_proj)
            world = ssao_ops.reconstruct_world_pos(
                state["SceneDepth"].reshape(-1), px, py_global, inv_vp, w, full_h
            ).reshape(h, w, 3)
            env_avg = average_radiance(ctx.scene.env_map) * ctx.scene.env_brightness
            fog_color = env_avg * ctx.camera.exposure
            out = pp.apply_fog(
                state["SceneColor"], world, state["SceneCoverage"],
                ctx.camera.position, fog_color,
                density=density, height_falloff=falloff,
            )
            return {"SceneColor": out}

        return execute


class MotionBlurPass(RenderPass):
    name = "MotionBlur"

    def __init__(self, num_taps: int = 8, shutter_scale: float = 0.5,
                 temporal: bool | None = None, stochastic_taps: int = 2):
        self.num_taps = num_taps
        self.shutter_scale = shutter_scale
        self.temporal = temporal       # None = auto: stochastic under TAA
        self.stochastic_taps = stochastic_taps

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("SceneColor")
        reg.get("SceneVelocity")
        reg.get("SceneDepth")
        shutter = self.shutter_scale
        tile = 16 if cfg.height % 16 == 0 and cfg.width % 16 == 0 else 8
        temporal = self.temporal
        if temporal is None:
            temporal = cfg.texture_quality in ("stochastic", "stochastic1")
        taps = self.stochastic_taps if temporal else self.num_taps

        def execute(state: dict, ctx: FrameContext) -> dict:
            out = pp.motion_blur(
                state["SceneColor"], state["SceneVelocity"], state["SceneDepth"],
                shutter_scale=shutter, num_taps=taps, tile=tile,
                stochastic=temporal, frame_index=ctx.frame_index,
            )
            return {"SceneColor": out}

        return execute


class DepthOfFieldPass(RenderPass):
    name = "DepthOfField"

    def __init__(self, num_taps: int = 24, max_coc: float = 16.0,
                 temporal: bool | None = None, stochastic_taps: int = 4):
        self.num_taps = num_taps
        self.max_coc = max_coc
        self.temporal = temporal       # None = auto: stochastic under TAA
        self.stochastic_taps = stochastic_taps

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneDepth")
        reg.get("SceneCoverage")
        reg.create("SceneCoC", (h, w), jnp.float32)
        taps, max_coc = self.num_taps, self.max_coc
        temporal = self.temporal
        if temporal is None:
            temporal = cfg.texture_quality in ("stochastic", "stochastic1")
        sto = self.stochastic_taps if temporal else None

        def execute(state: dict, ctx: FrameContext) -> dict:
            coc = pp.compute_coc(
                state["SceneDepth"], state["SceneCoverage"],
                ctx.camera.near, ctx.camera.focus_depth, ctx.camera.aperture_px,
                max_coc=max_coc,
            )
            out = pp.depth_of_field(
                state["SceneColor"], coc, num_taps=taps,
                stochastic_taps=sto, frame_index=ctx.frame_index,
            )
            return {"SceneColor": out, "SceneCoC": coc}

        return execute


class FXAAPass(RenderPass):
    name = "FXAA"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")

        def execute(state: dict, ctx: FrameContext) -> dict:
            return {"LDR": pp.fxaa(state["LDR"])}

        return execute


class CASPass(RenderPass):
    name = "CAS"

    def __init__(self, sharpness: float = 0.5):
        self.sharpness = sharpness

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")
        sharp = self.sharpness

        def execute(state: dict, ctx: FrameContext) -> dict:
            return {"LDR": pp.cas(state["LDR"], sharp)}

        return execute
