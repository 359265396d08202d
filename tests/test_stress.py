"""Culling stress scene (ShowcaseApp.cpp:381-412 analogue) — instanced
rendering, per-frame transform streaming, and RT over the instanced TLAS.

CPU-sized here (256 instances); bench.py --config stress runs the full
4,096 on the GPU.
"""

import numpy as np

from arkoserenderer.assets.procedural import (
    animate_stress_scene,
    build_stress_scene,
)
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

CFG = PipelineConfig(
    width=128, height=128,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256, bin_chunk=1024),
    shadow_map_size=256,
)


def test_stress_scene_renders_and_animates():
    scene, cam = build_stress_scene(n_instances=256, viewport=(128, 128))
    r = Renderer(scene, cam, CFG, taa=False, bloom=False, dynamic_transforms=True)
    img0 = np.array(r.render_frame())
    assert np.isfinite(img0).all()
    assert 0.05 < img0.mean() < 0.95
    animate_stress_scene(scene, 0.7)
    img1 = np.array(r.render_frame())
    assert np.abs(img1 - img0).max() > 0.1      # instances moved
    # Transform streaming must not retrace.
    assert r.pipeline._compiled is not None


def test_stress_scene_instanced_tlas_rt():
    """RT shadows over the stress scene: the two-level BVH holds ONE shared
    BLAS + N TLAS instance leaves (no world-space geometry duplication)."""
    scene, cam = build_stress_scene(n_instances=256, viewport=(96, 96))
    cfg = PipelineConfig(
        width=96, height=96,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256, bin_chunk=1024),
        shadow_map_size=256,
    )
    r = Renderer(scene, cam, cfg, rt_shadows=True, taa=False, bloom=False)
    from arkoserenderer.ops.bvh import TwoLevelBVH

    bvh = r.scene_arrays.bvh
    assert isinstance(bvh, TwoLevelBVH)
    # One BLAS for the sphere + one for the floor — shared by all instances.
    n_unique_roots = len(np.unique(np.asarray(bvh.blas_root)))
    assert n_unique_roots == 2
    # floor + 256 spheres LIVE; the build may reserve extra PARKED slots
    # for streaming capacity (ops/bvh.build_two_level inst_cap).
    assert int(np.asarray(bvh.inst_active).sum()) == 257
    assert bvh.inst_id.shape[0] >= 257
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()
    mask = np.asarray(r.state["ShadowMask.sun"])
    assert mask.min() == 0.0 and mask.max() == 1.0   # shadows + lit areas


def test_stress_scene_frustum_culls():
    """Most of the grid is outside the frustum; the visible-triangle count
    after culling must be far below the scene total."""
    scene, cam = build_stress_scene(n_instances=256, viewport=(128, 128))
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.render_frame()
    vis = np.asarray(r.state["Visibility"])
    covered = (vis >= 0).mean()
    assert covered > 0.2   # plenty of geometry on screen


def test_reference_capacity_pools_allocate():
    """Reference-parity capacities (VertexManager.h:89-99 / GpuScene.h:241-
    284): the SceneLimits DEFAULTS now match the reference (12M vertices /
    48M indices / 65,536 drawables / 10,000 materials / 4,096 textures) and
    a scene builds its fixed-shape pools at that scale. (The full render at
    these pool sizes runs in the slow marker / on the GPU via bench —
    per-triangle masks over a 16M-row pool take minutes on XLA:CPU.)"""
    from arkoserenderer.core.types import SceneLimits

    lim = SceneLimits()
    assert lim.max_vertices == 12 << 20
    assert lim.max_indices == 48 << 20
    assert lim.max_drawables == 65536
    assert lim.max_materials == 10000
    assert lim.max_textures == 4096

    from arkoserenderer.assets.procedural import build_stress_scene

    scene, cam = build_stress_scene(
        n_instances=512, viewport=(96, 96),
        limits=SceneLimits(
            max_materials=64, max_textures=32, texture_pool_texels=1 << 19,
        ),
    )
    assert scene.limits.max_vertices == 12 << 20
    arrays = scene.build()
    assert arrays.positions.shape == (12 << 20, 3)
    assert arrays.indices.shape == ((48 << 20) // 3, 3)
    assert arrays.world.shape[0] == 65536
    import numpy as np

    # floor + 512 grid cells x 2 LOD levels per cell
    assert int(np.asarray(arrays.inst_valid).sum()) == 1025


def test_device_animator_matches_host_path():
    """The traced scene_animator (bench's device-side bob+spin) must produce
    the same frame as the host animate + update_instance_transforms path at
    the same time value."""
    from arkoserenderer.assets.procedural import make_stress_animator

    dt = 1 / 60
    # Host path: animate to t = k*dt before frame k, so the final frame has
    # the same frame_index (same camera Halton jitter) AND the same t as
    # the device path.
    scene_h, cam_h = build_stress_scene(n_instances=64, viewport=(128, 128))
    rh = Renderer(scene_h, cam_h, CFG, taa=False, bloom=False,
                  dynamic_transforms=True)
    for k in range(2):
        animate_stress_scene(scene_h, k * dt)
        rh.render_frame()
    animate_stress_scene(scene_h, 2 * dt)
    img_h = np.array(rh.render_frame())

    # Device path: frame_index * delta_time = 2*dt at frame 2.
    scene_d, cam_d = build_stress_scene(n_instances=64, viewport=(128, 128))
    rd = Renderer(scene_d, cam_d, CFG, taa=False, bloom=False,
                  scene_animator=make_stress_animator(scene_d))
    for _ in range(2):
        rd.render_frame()
    img_d = np.array(rd.render_frame())

    assert np.isfinite(img_d).all()
    # Transforms match to ~1e-7 (verified directly), so images agree except
    # isolated edge pixels whose triangle coverage flips under fp
    # associativity differences between the two transform paths.
    diff = np.abs(img_d - img_h)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.005
