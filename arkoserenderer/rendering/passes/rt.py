"""Ray-traced render passes: RT sun shadows and RT reflections.

Role-equivalents:
  * RTShadowPass       — the sun half of the RT shadow story (any-hit
                         raygen off the depth buffer, rt-shadow/raygen.rgen).
  * RTLocalShadowPass  — RTLocalShadowNode
                         (arkose/rendering/shadow/RTLocalShadowNode.cpp:
                         per-local-light any-hit raygen producing R8 masks;
                         the reference does spots only — ours also shadows
                         point lights flagged cast_shadows).
  * RTReflectionsPass  — RTReflectionsNode (arkose/rendering/nodes/
                         RTReflectionsNode.cpp:23-288): roughness-thresholded
                         mirror/glossy rays with VNDF perturbation, denoised
                         FFX-style by a roughness-scaled spatial prefilter +
                         velocity-reprojected, neighborhood-clamped temporal
                         accumulation over a persistent history buffer.

Both reconstruct receiver surfaces from the depth buffer + G-buffer normals,
so they run after Geometry/Shading with no extra geometry pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops import brdf as brdf_ops
from arkoserenderer.ops.bvh import trace_rays
from arkoserenderer.ops.rt import trace_shadow_mask
from arkoserenderer.ops.ssao import reconstruct_world_pos
from arkoserenderer.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer.rendering.registry import Registry


class BVHRefitPass(RenderPass):
    """Per-frame BVH refit for animated geometry (TLAS/BLAS update analogue,
    GpuScene.cpp:872-1011's per-frame rebuild policy for skinned meshes).

    Reads the (possibly skinned/morphed) object-space vertex pool, applies
    per-instance world transforms, and refits the static-topology BVH's
    AABBs in-jit. Downstream RT/DDGI passes pick up ``scene.bvh`` from frame
    state instead of the build-time BVH.
    """

    name = "BVHRefit"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("geom.positions")
        reg.publish("scene.bvh")

        def execute(state: dict, ctx: FrameContext) -> dict:
            from arkoserenderer.ops.bvh import refit_bvh

            p = state["geom.positions"]
            m = ctx.scene.world[ctx.scene.vertex_instance]       # (V, 4, 4)
            wp = jnp.einsum("vij,vj->vi", m[:, :3, :3], p,
                            precision=mx.HIGHEST) + m[:, :3, 3]
            return {"scene.bvh": refit_bvh(ctx.scene.bvh, wp, ctx.scene.indices,
                                           world=ctx.scene.world)}

        return execute


def scene_with_live_bvh(state: dict, ctx: FrameContext):
    """The frame's SceneArrays with the refitted BVH swapped in (if a
    BVHRefitPass ran earlier; otherwise the build-time static BVH)."""
    bvh = state.get("scene.bvh")
    return ctx.scene if bvh is None else ctx.scene._replace(bvh=bvh)


class RTShadowPass(RenderPass):
    """Per-pixel any-hit sun shadow mask (replaces PCF when present).

    When the scene's sun has a non-zero angular radius, the single ray per
    pixel becomes a blue-noise cone sample over the sun disk and the noisy
    visibility runs through the sigma shadow denoiser
    (ops/shadow_denoise.py) — the reference's NRD ExternalFeature slot
    (arkose/rendering/backend/vulkan/features/nrd/VulkanNRD.cpp). Radius 0
    keeps the deterministic hard mask bit-for-bit."""

    name = "RTShadow"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("Visibility")
        if reg.has("scene.bvh"):
            reg.get("scene.bvh")
        soft = cfg.scene.sun_angular_radius_deg > 0.0
        if soft:
            reg.create("RTShadow.history", (h, w, 1), jnp.float32,
                       persistent=True)
            reg.create("RTShadow.moments", (h, w, 3), jnp.float32,
                       persistent=True)
            reg.create("RTShadow.depth", (h, w), jnp.float32,
                       persistent=True)
        reg.create("ShadowMask.sun", (h, w), jnp.float32, clear=1.0)
        # Half-res tracing (rt_scale=2): ray count / 4, nearest-depth
        # reconstruction to full res (no half-res under band sharding).
        scale = cfg.rt_scale if (cfg.shard_axis is None and h % 2 == 0
                                 and w % 2 == 0) else 1
        hs, ws = h // scale, w // scale
        import numpy as _np

        xs = (_np.arange(ws, dtype=_np.float32) * scale + 0.5)
        ys = (_np.arange(hs, dtype=_np.float32) * scale + 0.5)
        pxg, pyg = _np.meshgrid(xs, ys)
        px = pxg.ravel()   # numpy: closures become program constants
        py = pyg.ravel()
        full_h = cfg.frame_height
        shard_axis = cfg.shard_axis
        if soft:
            px_full, py_full = pixel_centers(cfg)
            if shard_axis is not None:
                xs_f = _np.arange(w, dtype=_np.float32) + 0.5
                ys_f = _np.arange(full_h, dtype=_np.float32) + 0.5
                pxf, pyf = _np.meshgrid(xs_f, ys_f)
                px_frame = pxf.ravel()
                py_frame = pyf.ravel()

        def execute(state: dict, ctx: FrameContext) -> dict:
            depth = state["SceneDepth"]
            depth_s = depth[::scale, ::scale] if scale > 1 else depth
            vis_s = (state["Visibility"][::scale, ::scale]
                     if scale > 1 else state["Visibility"])
            py_g = py + ctx.row_offset.astype(py.dtype)
            inv_vp = jnp.linalg.inv(ctx.camera.unjittered_view_proj)
            world = reconstruct_world_pos(
                depth_s.reshape(-1), px, py_g, inv_vp, w, full_h
            )
            covered = vis_s.reshape(-1) >= 0
            # Park uncovered (sky) rays far below the scene: their root-AABB
            # test misses in ONE traversal step, so coherent chunks full of
            # sky terminate almost immediately (the loop runs to the worst
            # ray of each chunk).
            world = jnp.where(covered[:, None], world, -1e7)
            light_dir = -ctx.scene.lights.sun_direction
            if soft:
                from arkoserenderer.ops.noise import sample_blue_noise

                u1 = sample_blue_noise(jnp.asarray(px), py_g,
                                       ctx.frame_index, salt=13)
                u2 = sample_blue_noise(jnp.asarray(px), py_g,
                                       ctx.frame_index, salt=14)
                light_dir = mx.sample_cone(
                    light_dir[None, :], ctx.scene.lights.sun_cos_radius,
                    u1, u2,
                )
            mask = trace_shadow_mask(
                scene_with_live_bvh(state, ctx), world,
                light_dir,
                covered,
                chunk_size=1 << 13 if hs * ws >= (1 << 17) else None,
            )
            if scale > 1:
                from arkoserenderer.ops.image import upsample_nearest_depth

                mask = upsample_nearest_depth(
                    mask.reshape(hs, ws, 1), depth_s, depth
                )[..., 0]
            else:
                mask = mask.reshape(h, w)
            if not soft:
                return {"ShadowMask.sun": mask}

            # -- sigma denoiser over the stochastic sun visibility ----------
            # Edge-stopping guides derived here (this pass runs BEFORE the
            # shading pass that publishes SceneNormal/SceneVelocity): depth-
            # reconstructed normals + camera-reprojection velocity.
            from arkoserenderer.ops import shadow_denoise as sdn

            if shard_axis is None:
                world_full = reconstruct_world_pos(
                    depth.reshape(-1), px_full, py_full, inv_vp, w, full_h
                ).reshape(h, w, 3)
                normal = sdn.normals_from_depth(world_full)
                vel = sdn.camera_velocity(
                    world_full, px_full, py_full, ctx.camera.prev_view_proj,
                    w, full_h,
                )
                resolved, mom = sdn.denoise(
                    mask[..., None], depth, normal, vel,
                    state["RTShadow.history"], state["RTShadow.moments"],
                    state["RTShadow.depth"], px_full, py_full,
                    ctx.frame_index == 0,
                )
                return {
                    "ShadowMask.sun": resolved[..., 0],
                    "RTShadow.history": resolved,
                    "RTShadow.moments": mom,
                    "RTShadow.depth": depth,
                }
            # Pixel-band SPMD: rays were traced band-local; the denoiser's
            # stencil/reprojection stages run REPLICATED over all_gather-ed
            # full-frame planes (seam-exact vs single device), then each
            # device slices its band back out — the RTReflections pattern.
            # GUIDES (normals/velocity) are derived from the GATHERED depth,
            # not per band: their stencils edge-clamp, so band-local
            # computation would differ from single-device at band seams.
            import jax as _jax

            def g(x):
                return _jax.lax.all_gather(x, shard_axis, axis=0, tiled=True)

            def band(x):
                return _jax.lax.dynamic_slice_in_dim(
                    x, _jax.lax.axis_index(shard_axis) * h, h, axis=0
                )

            depth_f = g(depth)
            world_f = reconstruct_world_pos(
                depth_f.reshape(-1), px_frame, py_frame, inv_vp, w, full_h
            ).reshape(full_h, w, 3)
            normal_f = sdn.normals_from_depth(world_f)
            vel_f = sdn.camera_velocity(
                world_f, px_frame, py_frame, ctx.camera.prev_view_proj,
                w, full_h,
            )
            resolved_f, mom_f = sdn.denoise(
                g(mask[..., None]), depth_f, normal_f, vel_f,
                g(state["RTShadow.history"]), g(state["RTShadow.moments"]),
                g(state["RTShadow.depth"]), px_frame, py_frame,
                ctx.frame_index == 0,
            )
            return {
                "ShadowMask.sun": band(resolved_f)[..., 0],
                "RTShadow.history": band(resolved_f),
                "RTShadow.moments": band(mom_f),
                "RTShadow.depth": depth,
            }

        return execute


class RTLocalShadowPass(RenderPass):
    """Per-pixel any-hit shadow masks for LOCAL lights (RTLocalShadowNode):
    one (H, W) visibility plane per spot/point light, traced to the light
    position with t_max just short of the light (no PCF blur, no atlas
    resolution limit). Non-casting lights keep a 1.0 plane so the shading
    loop can index uniformly."""

    name = "RTLocalShadow"

    def __init__(self, spot_casters: tuple, point_casters: tuple,
                 spot_radii: tuple = (), point_radii: tuple = ()):
        self.spot_casters = spot_casters      # tuple[bool] per spot
        self.point_casters = point_casters    # tuple[bool] per point
        # Physical source radii (world units) — a casting light with a
        # non-zero radius gets disk-jittered stochastic rays + the sigma
        # denoiser (soft shadows); radius 0 keeps the hard mask.
        self.spot_radii = spot_radii
        self.point_radii = point_radii

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("Visibility")
        if reg.has("scene.bvh"):
            reg.get("scene.bvh")
        n_s, n_p = len(self.spot_casters), len(self.point_casters)

        def radius_of(radii, i):
            return float(radii[i]) if i < len(radii) else 0.0

        spot_radii = tuple(radius_of(self.spot_radii, i) for i in range(n_s))
        point_radii = tuple(radius_of(self.point_radii, i) for i in range(n_p))
        # Static channel map of the soft (denoised) masks: ("spot"|"point", i).
        soft_channels = (
            [("spot", i) for i, c in enumerate(self.spot_casters)
             if c and spot_radii[i] > 0.0]
            + [("point", i) for i, c in enumerate(self.point_casters)
               if c and point_radii[i] > 0.0]
        )
        n_soft = len(soft_channels)
        if n_soft:
            reg.create("RTLocalShadow.history", (h, w, n_soft), jnp.float32,
                       persistent=True)
            reg.create("RTLocalShadow.moments", (h, w, 2 * n_soft + 1),
                       jnp.float32, persistent=True)
            reg.create("RTLocalShadow.depth", (h, w), jnp.float32,
                       persistent=True)
        reg.create("ShadowMask.locals", (max(n_s, 1), h, w), jnp.float32,
                   clear=1.0)
        reg.create("ShadowMask.points", (max(n_p, 1), h, w), jnp.float32,
                   clear=1.0)
        import numpy as _np

        xs = _np.arange(w, dtype=_np.float32) + 0.5
        ys = _np.arange(h, dtype=_np.float32) + 0.5
        pxg, pyg = _np.meshgrid(xs, ys)
        px = pxg.ravel()   # numpy: closures become program constants
        py = pyg.ravel()
        full_h = cfg.frame_height
        shard_axis = cfg.shard_axis
        spot_casters, point_casters = self.spot_casters, self.point_casters
        if n_soft and shard_axis is not None:
            xs_f = _np.arange(w, dtype=_np.float32) + 0.5
            ys_f = _np.arange(full_h, dtype=_np.float32) + 0.5
            pxf, pyf = _np.meshgrid(xs_f, ys_f)
            px_frame = pxf.ravel()
            py_frame = pyf.ravel()

        def execute(state: dict, ctx: FrameContext) -> dict:
            depth = state["SceneDepth"]
            covered = state["Visibility"].reshape(-1) >= 0
            py_g = py + ctx.row_offset.astype(py.dtype)
            inv_vp = jnp.linalg.inv(ctx.camera.unjittered_view_proj)
            world = reconstruct_world_pos(
                depth.reshape(-1), px, py_g, inv_vp, w, full_h
            )
            # Park sky rays far outside the scene (one-step root miss).
            world = jnp.where(covered[:, None], world, -1e7)
            scn = scene_with_live_bvh(state, ctx)

            def mask_to(light_pos, radius=0.0, salt=0):
                to_l = light_pos[None, :] - world
                dist = jnp.sqrt(jnp.maximum(mx.vdot(to_l, to_l), 1e-12))
                l_dir = to_l / dist
                if radius > 0.0:
                    # Jitter the light POSITION on the disk facing the
                    # receiver (spherical-source occlusion approximation).
                    from arkoserenderer.ops.noise import sample_blue_noise

                    u1 = sample_blue_noise(jnp.asarray(px), py_g,
                                           ctx.frame_index, salt=salt)
                    u2 = sample_blue_noise(jnp.asarray(px), py_g,
                                           ctx.frame_index, salt=salt + 1)
                    off = mx.sample_disk_offset(l_dir, radius, u1, u2)
                    to_l = to_l + off
                    dist = jnp.sqrt(jnp.maximum(mx.vdot(to_l, to_l), 1e-12))
                    l_dir = to_l / dist
                occ = trace_rays(
                    scn.bvh, world + l_dir * 3e-2, l_dir,
                    t_max=jnp.maximum(dist[:, 0] - 6e-2, 1e-3),
                    any_hit=True,
                )
                return jnp.where(
                    covered, (~occ.hit).astype(jnp.float32), 1.0
                ).reshape(h, w)

            ones = jnp.ones((h, w), jnp.float32)
            spots = [
                mask_to(ctx.scene.lights.spot_pos[i],
                        radius=spot_radii[i], salt=20 + 2 * i)
                if cast else ones
                for i, cast in enumerate(spot_casters)
            ] or [ones]
            points = [
                mask_to(ctx.scene.lights.point_pos[i],
                        radius=point_radii[i],
                        salt=40 + 2 * i)
                if cast else ones
                for i, cast in enumerate(point_casters)
            ] or [ones]

            if n_soft:
                # Denoise the soft channels as ONE stacked (H, W, Cs) pass
                # (shared reprojection / confidence), then scatter back.
                from arkoserenderer.ops import shadow_denoise as sdn

                chans = {
                    "spot": spots,
                    "point": points,
                }
                noisy = jnp.stack(
                    [chans[kind][i] for kind, i in soft_channels], axis=-1
                )
                # Guides derived in-pass (SceneNormal/SceneVelocity are
                # published by the LATER shading pass this one feeds) from
                # an UNPARKED depth reconstruction; under band sharding
                # they derive from the GATHERED depth (guide stencils
                # edge-clamp, so band-local computation would diverge from
                # single-device at band seams).
                if shard_axis is None:
                    world_img = reconstruct_world_pos(
                        depth.reshape(-1), px, py_g, inv_vp, w, full_h
                    ).reshape(h, w, 3)
                    normal = sdn.normals_from_depth(world_img)
                    vel = sdn.camera_velocity(
                        world_img, px, py_g, ctx.camera.prev_view_proj,
                        w, full_h,
                    )
                    resolved, mom = sdn.denoise(
                        noisy, depth, normal, vel,
                        state["RTLocalShadow.history"],
                        state["RTLocalShadow.moments"],
                        state["RTLocalShadow.depth"],
                        px, py, ctx.frame_index == 0,
                    )
                    new_depth = depth
                else:
                    import jax as _jax

                    def g(x):
                        return _jax.lax.all_gather(
                            x, shard_axis, axis=0, tiled=True
                        )

                    def band(x):
                        return _jax.lax.dynamic_slice_in_dim(
                            x, _jax.lax.axis_index(shard_axis) * h, h, axis=0
                        )

                    depth_f = g(depth)
                    world_f = reconstruct_world_pos(
                        depth_f.reshape(-1), px_frame, py_frame, inv_vp,
                        w, full_h,
                    ).reshape(full_h, w, 3)
                    normal_f = sdn.normals_from_depth(world_f)
                    vel_f = sdn.camera_velocity(
                        world_f, px_frame, py_frame,
                        ctx.camera.prev_view_proj, w, full_h,
                    )
                    resolved_f, mom_f = sdn.denoise(
                        g(noisy), depth_f, normal_f, vel_f,
                        g(state["RTLocalShadow.history"]),
                        g(state["RTLocalShadow.moments"]),
                        g(state["RTLocalShadow.depth"]),
                        px_frame, py_frame, ctx.frame_index == 0,
                    )
                    resolved, mom = band(resolved_f), band(mom_f)
                    new_depth = depth
                for ci, (kind, i) in enumerate(soft_channels):
                    chans[kind][i] = resolved[..., ci]
                return {
                    "ShadowMask.locals": jnp.stack(spots),
                    "ShadowMask.points": jnp.stack(points),
                    "RTLocalShadow.history": resolved,
                    "RTLocalShadow.moments": mom,
                    "RTLocalShadow.depth": new_depth,
                }
            return {
                "ShadowMask.locals": jnp.stack(spots),
                "ShadowMask.points": jnp.stack(points),
            }

        return execute


class RTReflectionsPass(RenderPass):
    """RT reflections with honest hit shading + the FFX-style denoiser.

    Hits are shaded with the textured material + sun BRDF + shadow ray
    (ops/rt.shade_hits — the closest-hit shader analogue), then denoised by
    the 3-stage chain in ops/reflection_denoise (reproject -> prefilter ->
    resolveTemporal, matching RTReflectionsNode.cpp:23-288's dispatches of
    shaders/rt-reflections/{reproject,prefilter,resolveTemporal}.comp).
    """

    name = "RTReflections"

    def __init__(self, mirror_roughness: float = 0.25, max_roughness: float = 0.6,
                 temporal: bool = True, hysteresis: float = 0.85,
                 ddgi_grid=None):
        # Below mirror_roughness: pure mirror ray; between: VNDF-perturbed;
        # above max: no trace (diffuse GI covers it) — the reference's
        # roughness thresholds (RTReflectionsNode.cpp:78-79).
        self.mirror_roughness = mirror_roughness
        self.max_roughness = max_roughness
        self.temporal = temporal
        self.hysteresis = hysteresis
        self.ddgi_grid = ddgi_grid

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneDepth")
        reg.get("SceneNormal")
        reg.get("SceneMaterial")
        reg.get("SceneBaseColor")
        reg.get("SceneCoverage")
        if reg.has("scene.bvh"):
            reg.get("scene.bvh")
        # DDGI irradiance at reflection HITS (the reference's raygen samples
        # the probe volume for the GI term at hit points — bounce light in
        # mirrors; ddgi/probeSampling.glsl from rt-reflections/raygen.rgen).
        use_ddgi = self.ddgi_grid is not None and reg.has("DDGI.irradiance")
        grid = self.ddgi_grid
        if use_ddgi:
            reg.get("DDGI.irradiance")
            reg.get("DDGI.offsets")
            reg.get("DDGI.visibility")
        reg.create("SceneReflections", (h, w, 3), jnp.float32)
        # Half-res tracing (rt_scale=2): trace + shade at 1/4 the rays,
        # nearest-depth reconstruct, then denoise at FULL res.
        scale = cfg.rt_scale if (cfg.shard_axis is None and h % 2 == 0
                                 and w % 2 == 0) else 1
        hs, ws = h // scale, w // scale
        import numpy as _np

        xs = (_np.arange(ws, dtype=_np.float32) * scale + 0.5)
        ys = (_np.arange(hs, dtype=_np.float32) * scale + 0.5)
        pxg, pyg = _np.meshgrid(xs, ys)
        px = pxg.ravel()   # numpy: closures become program constants
        py = pyg.ravel()
        px_full, py_full = pixel_centers(cfg)   # full res (denoiser stages)
        full_h = cfg.frame_height
        shard_axis = cfg.shard_axis
        if shard_axis is not None:
            # Full-FRAME pixel centers for the replicated denoiser (numpy —
            # closures become program constants, see pipeline.pixel_centers).
            xs_f = _np.arange(w, dtype=_np.float32) + 0.5
            ys_f = _np.arange(full_h, dtype=_np.float32) + 0.5
            pxf, pyf = _np.meshgrid(xs_f, ys_f)
            px_frame = pxf.ravel()
            py_frame = pyf.ravel()
        max_rough = self.max_roughness
        temporal = self.temporal
        # Ray-cone spread ~ one pixel of the vertical FOV.
        cone_spread = scale / max(full_h, 1)
        if temporal:
            reg.get("SceneVelocity")
            reg.create("RTRefl.history", (h, w, 3), jnp.float32, persistent=True)
            reg.create("RTRefl.moments", (h, w, 3), jnp.float32, persistent=True)
            reg.create("RTRefl.depth", (h, w), jnp.float32, persistent=True)

        def execute(state: dict, ctx: FrameContext) -> dict:
            from arkoserenderer.ops import reflection_denoise as dn
            from arkoserenderer.ops.rt import shade_hits

            py_g = py + ctx.row_offset.astype(py.dtype)
            inv_vp = jnp.linalg.inv(ctx.camera.unjittered_view_proj)
            depth = state["SceneDepth"]
            depth_s = depth[::scale, ::scale] if scale > 1 else depth

            def sub(img):
                return img[::scale, ::scale] if scale > 1 else img

            world = reconstruct_world_pos(
                depth_s.reshape(-1), px, py_g, inv_vp, w, full_h
            )
            valid0 = sub(state["SceneCoverage"]).reshape(-1)
            # Sky pixels reconstruct to infinity (reverse-Z depth 0): park
            # them far outside the scene so no NaN enters the ray math AND
            # their traversal exits on the first step (results are masked).
            world = jnp.where(valid0[:, None], world, -1e7)
            nrm = sub(state["SceneNormal"]).reshape(-1, 3)
            mat = sub(state["SceneMaterial"]).reshape(-1, 4)
            base = sub(state["SceneBaseColor"]).reshape(-1, 3)
            rough = mat[:, 0:1]
            metal = mat[:, 1:2]

            view = mx.normalize(ctx.camera.position[None, :] - world)
            r_dir = mx.normalize(mx.reflect(-view, nrm))
            active = valid0 & (rough[:, 0] < max_rough)
            # Park INACTIVE rays (sky + rough-beyond-cutoff surfaces) far
            # outside the scene: they exit traversal in one step instead of
            # bouncing around uselessly (results are masked by `active`).
            world = jnp.where(active[:, None], world, -1e7)

            live = scene_with_live_bvh(state, ctx)
            origins = world + nrm * 2e-2
            chunk = 1 << 13 if hs * ws >= (1 << 17) else None
            if chunk is not None:
                # COMPACT the sparse active set to the front (stable sort):
                # chunks are sequential worst-ray loops, so concentrating
                # the real rays into the first ceil(n_active/chunk) chunks
                # makes every parked tail chunk terminate in one step.
                order = jnp.argsort(~active, stable=True)
                inv = jnp.argsort(order, stable=True)
                hit_s = trace_rays(
                    live.bvh, origins[order], r_dir[order], t_max=1e4,
                    chunk_size=chunk,
                )
                from arkoserenderer.ops.bvh import Hit as _Hit

                hit = _Hit(*(x[inv] for x in hit_s))
            else:
                hit = trace_rays(live.bvh, origins, r_dir, t_max=1e4,
                                 chunk_size=chunk)
            ddgi_sample = None
            if use_ddgi:
                from arkoserenderer.ops import ddgi as ddgi_ops

                st = ddgi_ops.DDGIState(
                    irradiance=state["DDGI.irradiance"],
                    visibility=state["DDGI.visibility"],
                    offsets=state["DDGI.offsets"],
                )

                def ddgi_sample(wp, n):
                    return ddgi_ops.sample_irradiance(st, grid, wp, n)

            radiance = shade_hits(
                live, hit, origins, r_dir, ctx.camera.exposure,
                cone_spread=cone_spread, ddgi_sample=ddgi_sample,
                chunk_size=chunk,
                n_spots=cfg.scene.n_spots, n_points=cfg.scene.n_points,
                spot_casters=cfg.scene.spot_shadow_casters,
                point_casters=cfg.scene.point_shadow_casters,
            )

            f0 = brdf_ops.base_f0(base, metal)
            n_dot_v = jnp.clip(mx.vdot(nrm, view), 0.0, 1.0)
            fresnel = brdf_ops.env_fresnel_roughness(n_dot_v, f0, rough)
            # Fade only in a band NEAR the roughness cutoff (mirrors keep
            # full energy); diffuse GI takes over past the cutoff.
            fade = jnp.clip((max_rough - rough) / (0.25 * max_rough), 0.0, 1.0)
            refl = jnp.where(active[:, None], radiance * fresnel * fade, 0.0)
            if scale > 1:
                from arkoserenderer.ops.image import upsample_nearest_depth

                refl_img = upsample_nearest_depth(
                    refl.reshape(hs, ws, 3), depth_s, depth
                )
                rr = state["SceneMaterial"][..., 0:1]
                nrm_img = state["SceneNormal"]
            else:
                refl_img = refl.reshape(h, w, 3)
                rr = rough.reshape(h, w, 1)
                nrm_img = nrm.reshape(h, w, 3)

            if shard_axis is None:
                # -- prefilter (edge-aware, roughness-scaled) ------------------
                filtered = dn.prefilter(refl_img, rr, nrm_img, depth)
                if not temporal:
                    return {"SceneReflections": filtered}

                # -- reproject + resolve-temporal -----------------------------
                hist, mom, conf = dn.reproject(
                    state["RTRefl.history"], state["RTRefl.moments"],
                    state["RTRefl.depth"], depth,
                    state["SceneVelocity"], px_full, py_full,
                )
                resolved, moments = dn.resolve_temporal(
                    filtered, hist, mom, conf, ctx.frame_index == 0,
                )
                return {
                    "SceneReflections": resolved,
                    "RTRefl.history": resolved,
                    "RTRefl.moments": moments,
                    "RTRefl.depth": depth,
                }

            # Pixel-band SPMD: rays were traced band-local above (the part
            # that scales); the stencil/reprojection denoiser stages run
            # REPLICATED over all_gather-ed full-frame planes so band edges
            # see true neighbor rows (seam-exact vs single device), then
            # each device slices its band back out. Denoiser cost is a few
            # tenths of a ms at 1080p — replicating it buys exactness for
            # one ICI gather of a handful of screen-size planes.
            import jax as _jax

            def g(x):
                return _jax.lax.all_gather(x, shard_axis, axis=0, tiled=True)

            def band(x):
                return _jax.lax.dynamic_slice_in_dim(
                    x, _jax.lax.axis_index(shard_axis) * h, h, axis=0
                )

            refl_f = g(refl_img)
            filtered_f = dn.prefilter(refl_f, g(rr), g(nrm_img), g(depth))
            if not temporal:
                return {"SceneReflections": band(filtered_f)}
            depth_f = g(depth)
            hist, mom, conf = dn.reproject(
                g(state["RTRefl.history"]), g(state["RTRefl.moments"]),
                g(state["RTRefl.depth"]), depth_f,
                g(state["SceneVelocity"]), px_frame, py_frame,
            )
            resolved_f, moments_f = dn.resolve_temporal(
                filtered_f, hist, mom, conf, ctx.frame_index == 0,
            )
            return {
                "SceneReflections": band(resolved_f),
                "RTRefl.history": band(resolved_f),
                "RTRefl.moments": band(moments_f),
                "RTRefl.depth": depth,
            }

        return execute
