"""Sky pass: environment map where no geometry covered the pixel.

Role-equivalent to SkyViewNode (arkose/rendering/nodes/SkyViewNode.cpp):
fills background with the equirect env map along camera rays and writes the
camera-reprojection sky velocity TAA needs.

Budget mode: with cfg.sky_fetch_scale = k > 1 the equirect FETCH (4
per-pixel gathers) runs at 1/k resolution and is bilinearly upsampled with
elementwise slices; the sky is low-frequency so the quality loss is
invisible. Sky VELOCITY stays full-res (pure matrix math). The default,
k = 1, is the full-res fetch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from arkoserenderer.core import mathx as mx
from arkoserenderer.ops.envmap import sample_equirect
from arkoserenderer.ops.image import upsample_bilinear_k
from arkoserenderer.ops.shading import shade_sky
from arkoserenderer.rendering.pipeline import (
    FrameContext,
    PipelineConfig,
    RenderPass,
    pixel_centers,
)
from arkoserenderer.rendering.registry import Registry


def _directions(cam, px, py, width, height):
    """Camera-ray directions through pixel centers (unjittered)."""
    ndc_x = px / width * 2.0 - 1.0
    ndc_y = (0.5 - py / height) * 2.0
    inv_vp = jnp.linalg.inv(cam.unjittered_view_proj)
    # Elementwise homogeneous transform (no per-pixel dot — layout copies).
    lanes = [
        ndc_x * inv_vp[r, 0] + ndc_y * inv_vp[r, 1]
        + 0.5 * inv_vp[r, 2] + inv_vp[r, 3]
        for r in range(4)
    ]
    den = lanes[3]
    inv = jnp.where(jnp.abs(den) > 1e-10, 1.0 / jnp.where(den == 0, 1.0, den), 0.0)
    world = jnp.stack(lanes[:3], axis=-1)
    return mx.normalize(world * inv[:, None] - cam.position[None, :])


class SkyPass(RenderPass):
    name = "SkyView"

    def construct(self, cfg: PipelineConfig, reg: Registry):
        h, w = cfg.height, cfg.width
        reg.get("SceneColor")
        reg.get("SceneCoverage")
        reg.get("SceneVelocity")
        px, py = pixel_centers(cfg)
        full_h = cfg.frame_height

        k = cfg.sky_fetch_scale
        lowres = k > 1 and h % k == 0 and w % k == 0
        shard_axis = cfg.shard_axis
        n_shards = cfg.shard_count
        if lowres:
            xs = (np.arange(w // k, dtype=np.float32) + 0.5) * k
            ys = (np.arange(h // k, dtype=np.float32) + 0.5) * k
            lx, ly = np.meshgrid(xs, ys)
            px_lo = lx.ravel()   # numpy: closures become program constants
            py_lo = ly.ravel()

        def execute(state: dict, ctx: FrameContext) -> dict:
            color = state["SceneColor"].reshape(-1, 3)
            valid = state["SceneCoverage"].reshape(-1)
            py_global = py + ctx.row_offset.astype(py.dtype)
            if lowres:
                off = ctx.row_offset.astype(py_lo.dtype)
                dirs = _directions(ctx.camera, px_lo, py_lo + off, w, full_h)
                sky_lo = (
                    sample_equirect(ctx.scene.env_map, dirs)
                    * ctx.scene.env_brightness * ctx.camera.exposure
                ).reshape(h // k, w // k, 3)
                halo = None
                if shard_axis is not None:
                    from arkoserenderer.ops.image import band_halo_rows

                    halo = band_halo_rows(sky_lo, shard_axis, n_shards)
                sky = upsample_bilinear_k(sky_lo, k, halo_rows=halo).reshape(-1, 3)
                # Velocity (full res, elementwise).
                dirs_full = _directions(ctx.camera, px, py_global, w, full_h)
                far_point = ctx.camera.position[None, :] + dirs_full * 1e4
                pcx, pcy, pw = mx.transform_point_lanes(
                    ctx.camera.prev_view_proj, far_point, rows=(0, 1, 3)
                )
                inv_pw = jnp.where(
                    jnp.abs(pw) > 1e-8, 1.0 / jnp.where(pw == 0, 1.0, pw), 0.0
                )
                prev_sx = (pcx * inv_pw * 0.5 + 0.5) * w
                prev_sy = (0.5 - pcy * inv_pw * 0.5) * full_h
                sky_vel = jnp.stack([px - prev_sx, py_global - prev_sy], axis=-1)
                out = jnp.where(valid[:, None], color, sky)
            else:
                out, sky_vel = shade_sky(
                    ctx.scene, ctx.camera, color, valid, px, py_global, w, full_h
                )
            vel = state["SceneVelocity"].reshape(-1, 2)
            vel = jnp.where(valid[:, None], vel, sky_vel)
            return {
                "SceneColor": out.reshape(h, w, 3),
                "SceneVelocity": vel.reshape(h, w, 2),
            }

        return execute
