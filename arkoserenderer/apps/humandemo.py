"""HumanDemo app: the skin / subsurface-scattering showcase.

Role-equivalent to the reference's HumanDemo
(arkose/application/apps/HumanDemo.cpp, 185 LoC: loads a human bust with a
skin material + hair and runs the pipeline with SSSS enabled). Without the
reference's licensed human asset, this builds a procedural bust — a head
with a skin-tone gradient texture and ``subsurface`` material weight (which
stencils the SSSS pass, passes/ssss.py = SSSSNode.cpp's Burley diffusion),
hair strands rooted on the scalp (scene hair ribbons = HairMesh), and a
key/rim light setup — and renders headless frames. Any glTF bust can be


Usage:
  python -m arkoserenderer.apps.humandemo --frames 8 --out /tmp/human.png
  python -m arkoserenderer.apps.humandemo --no-ssss   # A/B the kernel
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def skin_texture(size: int = 128) -> np.ndarray:
    """Procedural skin-tone albedo with subtle blotches (RGBA8)."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.array([225, 168, 144], np.float32)
    shade = np.array([188, 126, 110], np.float32)
    t = 0.5 + 0.5 * np.sin(6.28 * (yy * 1.3 + 0.2 * np.sin(6.28 * xx)))
    blotch = rng.normal(0, 1, (size // 8, size // 8))
    blotch = np.kron(blotch, np.ones((8, 8)))[:size, :size]
    t = np.clip(t + 0.08 * blotch, 0.0, 1.0)[..., None]
    rgb = base * (1 - t * 0.35) + shade * (t * 0.35)
    a = np.full((size, size, 1), 255.0)
    return np.clip(np.concatenate([rgb, a], -1), 0, 255).astype(np.uint8)


def build_human_scene(viewport, with_hair: bool = True):
    from arkoserenderer.assets.procedural import (
        make_box,
        make_plane,
        make_uv_sphere,
    )
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight, SpotLight
    from arkoserenderer.scene.scene import Material, Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 16, max_indices=3 << 16, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 20,
    ))

    floor_mat = scene.add_material(Material(
        base_color_factor=np.array([0.22, 0.22, 0.24, 1.0], np.float32),
        roughness_factor=0.9,
    ))
    floor = make_plane(size=8.0)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    skin_tex = scene.add_texture(skin_texture(), srgb=True)
    skin = scene.add_material(Material(
        base_color_tex=skin_tex,
        roughness_factor=0.55,
        subsurface=1.0,          # stencils the SSSS pass (SSSSNode analogue)
    ))

    # Bust: head + neck + shoulders.
    head = make_uv_sphere(0.5, rings=24, sectors=48)
    head.material = skin
    hid = scene.add_segment(head)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (0.0, 1.55, 0.0)
    scene.add_instance(hid, w)

    neck = make_box((0.24, 0.3, 0.24))
    neck.material = skin
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (0.0, 1.15, 0.0)
    scene.add_instance(scene.add_segment(neck), w)

    shirt = scene.add_material(Material(
        base_color_factor=np.array([0.25, 0.33, 0.5, 1.0], np.float32),
        roughness_factor=0.8,
    ))
    torso = make_box((0.9, 0.45, 0.4))
    torso.material = shirt
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (0.0, 0.8, 0.0)
    scene.add_instance(scene.add_segment(torso), w)

    if with_hair:
        # Strands rooted on the upper scalp, combed outward/down.
        rng = np.random.default_rng(3)
        n_strands, pts_per = 160, 6
        points, segs = [], []
        for _ in range(n_strands):
            theta = rng.uniform(0, 0.45 * np.pi)       # polar from +Y
            phi = rng.uniform(0, 2 * np.pi)
            root = np.array([
                0.5 * np.sin(theta) * np.cos(phi),
                1.55 + 0.5 * np.cos(theta),
                0.5 * np.sin(theta) * np.sin(phi),
            ], np.float32)
            d = root - np.array([0.0, 1.55, 0.0], np.float32)
            d /= np.linalg.norm(d)
            p = root
            for k in range(pts_per):
                points.append(p)
                drop = np.array([0, -0.02 * k, 0], np.float32)
                p = p + 0.035 * d + drop
            segs.append(pts_per - 1)
        hair_mat = scene.add_material(Material(
            base_color_factor=np.array([0.12, 0.08, 0.05, 1.0], np.float32),
            roughness_factor=0.45,
        ))
        scene.add_hair(np.array(points, np.float32), np.array(segs, np.int64),
                       material=hair_mat, radius=0.004)

    scene.sun = DirectionalLight(
        direction=np.array([-0.5, -0.7, -0.4], np.float32),
        illuminance_lux=60000.0,
    )
    # Rim spot from behind-left (the reference demo's dramatic key/rim mix).
    scene.spots.append(SpotLight(
        position=np.array([-1.6, 2.2, -1.8], np.float32),
        direction=np.array([0.55, -0.35, 0.75], np.float32),
        luminous_intensity_cd=250000.0,
        outer_cone_angle=np.radians(40.0),
    ))
    from arkoserenderer.assets.procedural import gradient_env_map as _g

    scene.set_env_map(_g(32), brightness=7000.0)
    scene.ambient_lx = 5000.0

    cam = Camera(viewport=viewport)
    cam.look_at((0.9, 1.65, 1.6), (0.0, 1.4, 0.0))
    cam.focus_depth = 2.0
    return scene, cam


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", type=str, default="arkose_human.png")
    p.add_argument("--no-ssss", action="store_true")
    p.add_argument("--no-hair", action="store_true")
    p.add_argument("--orbit", action="store_true", help="orbit the camera")
    args = p.parse_args(argv)

    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.utils.imageio import save_png

    scene, cam = build_human_scene((args.width, args.height),
                                   with_hair=not args.no_hair)
    cfg = PipelineConfig(
        width=args.width, height=args.height,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512,
                            bin_chunk=1024),
        shadow_map_size=1024,
    )
    r = Renderer(scene, cam, cfg, ssss=not args.no_ssss)
    t0 = time.perf_counter()
    img = None
    for i in range(args.frames):
        if args.orbit:
            a = 0.4 * i / max(args.frames - 1, 1)
            cam.look_at((1.8 * np.sin(a + 0.5), 1.65, 1.8 * np.cos(a + 0.5)),
                        (0.0, 1.4, 0.0))
        img = r.render_frame()
    ms = (time.perf_counter() - t0) / max(args.frames, 1) * 1e3
    save_png(args.out, np.asarray(img))
    print(f"{args.frames} frames @ {ms:.2f} ms/frame -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
