"""Debug visualization pass: inspect any G-buffer channel as the output.

Role-equivalent to the reference's debug nodes — MeshletDebugNode /
VisibilityBufferDebugNode (id-hash colors), RTVisualisationNode (RT output
modes), plus the per-node texture visualizer GUI (RenderPipelineNode.h:41):
one pass that overrides LDR with a chosen channel visualization.
"""

from __future__ import annotations

import jax.numpy as jnp

from arkoserenderer.rendering.pipeline import FrameContext, PipelineConfig, RenderPass
from arkoserenderer.rendering.registry import Registry

MODES = (
    "visibility",   # triangle-id hash colors (VisibilityBufferDebugNode)
    "instance",     # instance-id hash colors (MeshletDebugNode spirit)
    "depth",        # linearized depth grayscale
    "normal",       # world normal * 0.5 + 0.5
    "velocity",     # motion vectors (r,g = xy)
    "base_color",
    "roughness",
    "metallic",
    "occlusion",
    "ssao",
    "shadow_mask",
)


def _hash_color(ids: jnp.ndarray) -> jnp.ndarray:
    """Integer id -> stable pseudo-random color (id visualization shaders)."""
    h = ids.astype(jnp.uint32) * jnp.uint32(2654435761)
    r = ((h >> 0) & 255).astype(jnp.float32) / 255.0
    g = ((h >> 8) & 255).astype(jnp.float32) / 255.0
    b = ((h >> 16) & 255).astype(jnp.float32) / 255.0
    return jnp.stack([r, g, b], axis=-1)


class DebugVisualizePass(RenderPass):
    name = "DebugVisualize"

    def __init__(self, mode: str = "visibility"):
        assert mode in MODES, f"unknown debug mode {mode}; pick from {MODES}"
        self.mode = mode

    def construct(self, cfg: PipelineConfig, reg: Registry):
        reg.get("LDR")
        mode = self.mode

        def execute(state: dict, ctx: FrameContext) -> dict:
            if mode == "visibility":
                vis = state["Visibility"]
                out = jnp.where((vis >= 0)[..., None], _hash_color(vis), 0.0)
            elif mode == "instance":
                vis = state["Visibility"]
                setup = state["vis.setup"]
                inst = ctx.scene.tri_instance[setup.orig_tri[jnp.maximum(vis, 0)]]
                out = jnp.where((vis >= 0)[..., None], _hash_color(inst), 0.0)
            elif mode == "depth":
                d = state["SceneDepth"]
                out = jnp.repeat((d / jnp.maximum(d.max(), 1e-6))[..., None], 3, -1)
            elif mode == "normal":
                out = state["SceneNormal"] * 0.5 + 0.5
            elif mode == "velocity":
                v = state["SceneVelocity"]
                out = jnp.concatenate(
                    [jnp.abs(v) / 8.0, jnp.zeros_like(v[..., :1])], axis=-1
                )
            elif mode == "base_color":
                out = state["SceneBaseColor"]
            elif mode == "roughness":
                out = jnp.repeat(state["SceneMaterial"][..., 0:1], 3, -1)
            elif mode == "metallic":
                out = jnp.repeat(state["SceneMaterial"][..., 1:2], 3, -1)
            elif mode == "occlusion":
                out = jnp.repeat(state["SceneMaterial"][..., 2:3], 3, -1)
            elif mode == "ssao":
                out = jnp.repeat(state["SSAO"][..., None], 3, -1)
            elif mode == "shadow_mask":
                out = jnp.repeat(state["ShadowMask.sun"][..., None], 3, -1)
            return {"LDR": jnp.clip(out, 0.0, 1.0)}

        return execute
