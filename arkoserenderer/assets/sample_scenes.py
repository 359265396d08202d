"""Real-asset sample scenes — the reference's "asset zoo" showcase scenes
(arkose/application/apps/ShowcaseApp.cpp:86-118) rebuilt from the sample
assets that ship with the reference.

The DamagedHelmet glTF sample (Khronos glTF-Sample-Models, CC-BY "Battle
Damaged Sci-fi Helmet" by theblueturtle_) is vendored under
``<repo>/assets/sample/DamagedHelmet`` so the real-asset bench lane is
hermetic; we fall back to the reference checkout's copy when present.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from arkoserenderer.assets.gltf import load_gltf
from arkoserenderer.assets.procedural import gradient_env_map, make_plane
from arkoserenderer.core.types import SceneLimits
from arkoserenderer.scene.camera import Camera
from arkoserenderer.scene.lights import DirectionalLight
from arkoserenderer.scene.scene import Material, Scene

REPO_SAMPLES = Path(__file__).resolve().parents[2] / "assets" / "sample"
REFERENCE_SAMPLES = Path("/root/reference/assets/assets/sample/models")


def find_sample(name: str) -> Path:
    """Locate a sample asset directory: vendored copy first, then the
    read-only reference checkout."""
    for root in (REPO_SAMPLES, REFERENCE_SAMPLES):
        p = root / name
        if p.is_dir():
            return p
    raise FileNotFoundError(
        f"sample asset '{name}' not found under {REPO_SAMPLES} or "
        f"{REFERENCE_SAMPLES}"
    )


def build_helmet_scene(
    n_grid: int = 6,
    viewport: tuple[int, int] = (1920, 1080),
    max_texture_size: int = 1024,
) -> tuple[Scene, Camera]:
    """A grid of n_grid x n_grid instanced DamagedHelmets over a ground
    plane — the real-asset analogue of the reference's showcase asset zoo
    (ShowcaseApp.cpp:86-118). At 6x6 this draws ~556K real triangles
    (36 x 15,452) with the helmet's full texture set (albedo, normal,
    metallic-roughness, emissive, AO) — the scale asked for by the
    BASELINE "helmet" lane (>=500K tris, real textures).
    """
    n_inst = n_grid * n_grid
    # The pool flattens geometry per instance (like VertexManager's
    # per-instance skeletal copies): 36 helmets = ~524K verts / 1.67M
    # indices / 556K triangles of real geometry in the pool.
    lim = SceneLimits(
        max_vertices=(n_inst * 14556 + 4096 + 0xFFF) & ~0xFFF,
        max_indices=(n_inst * 46356 + 4096 + 0xFFF) & ~0xFFF,
        max_drawables=max(64, n_inst + 8),
        max_materials=32, max_textures=32,
        # 5 real textures at <=1024^2 + mips ~= 7M texels.
        texture_pool_texels=1 << 23,
    )
    scene = Scene(limits=lim)

    floor_mat = scene.add_material(Material(
        base_color_factor=np.array([0.45, 0.45, 0.48, 1.0], np.float32),
        roughness_factor=0.65,
    ))
    spacing = 2.6
    extent = n_grid * spacing
    floor = make_plane(size=extent * 1.6, uv_scale=extent / 4)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    helmet = find_sample("DamagedHelmet") / "DamagedHelmet.gltf"
    load_gltf(scene, helmet, max_texture_size=max_texture_size)

    # The import placed instance(s) at the origin with the glTF node's own
    # transform (the helmet node carries the Z-up -> Y-up rotation). Re-home
    # the imported instances onto grid cell (0, 0), then instance the shared
    # vertex-pool segments across the rest of the grid — one pool copy,
    # n_inst drawables, the reference's instanced asset-zoo shape.
    half = (n_grid - 1) * spacing * 0.5

    def cell_world(gx: int, gz: int) -> np.ndarray:
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (gx * spacing - half, 1.0, gz * spacing - half)
        return w

    cells = [(gx, gz) for gx in range(n_grid) for gz in range(n_grid)]
    n_imported = len(scene.instances) - 1  # everything after the floor
    imported = [scene.instances[1 + i] for i in range(n_imported)]
    for i, (sid, world, prev, clip, lod) in enumerate(imported):
        scene.instances[1 + i] = (
            sid, (cell_world(*cells[0]) @ world).astype(np.float32),
            prev, clip, lod,
        )
    for gx, gz in cells[1:]:
        for sid, world, _prev, _clip, _lod in imported:
            scene.add_instance(
                sid, (cell_world(gx, gz) @ world).astype(np.float32))

    scene.sun = DirectionalLight(
        direction=np.array([-0.45, -1.0, -0.35], np.float32),
        illuminance_lux=95000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 4000.0

    cam = Camera(viewport=viewport)
    cam.look_at((half + 5.5, 4.5, half + 7.0), (0.0, 0.9, 0.0))
    cam.focus_depth = float(np.linalg.norm([half + 5.5, 3.6, half + 7.0]))
    return scene, cam
