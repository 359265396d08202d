"""Geodata app: heightmap terrain / map-region rendering.

Role-equivalent to the reference's GeodataApp
(arkose/application/apps/geodata/GeodataApp.cpp, 453 LoC: builds renderable
terrain meshes from heightmap data for a selected map region). This version
takes either a grayscale heightmap image or a procedural fBm terrain,
crops a region, builds a grid mesh with analytic normals plus a coarser
far-LOD level (the scene's in-jit LOD band selection stands in for the
reference's per-region mesh tiles), bakes an altitude-colored albedo
texture from the same heightmap, and renders headless frames.

Usage:
  python -m arkoserenderer.apps.geodata --frames 4 --out /tmp/terrain.png
  python -m arkoserenderer.apps.geodata --heightmap dem.png --region 0.2 0.2 0.6 0.6
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def fbm_heightmap(size: int = 257, octaves: int = 6, seed: int = 11) -> np.ndarray:
    """Procedural fractal terrain in [0, 1], (size, size) f32."""
    rng = np.random.default_rng(seed)
    h = np.zeros((size, size), np.float32)
    amp, freq = 1.0, 4
    total = 0.0
    for _ in range(octaves):
        coarse = rng.normal(0, 1, (freq + 1, freq + 1)).astype(np.float32)
        # Bilinear upsample the octave to full size.
        yi = np.linspace(0, freq, size)
        xi = np.linspace(0, freq, size)
        y0 = np.clip(yi.astype(int), 0, freq - 1)
        x0 = np.clip(xi.astype(int), 0, freq - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        layer = (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        h += amp * layer
        total += amp
        amp *= 0.5
        freq *= 2
    h /= total
    h = (h - h.min()) / max(h.max() - h.min(), 1e-6)
    return h ** 1.3    # valley-heavy like real DEMs


def load_heightmap(path: str) -> np.ndarray:
    """Grayscale image -> [0, 1] heights."""
    from arkoserenderer.utils.imageio import load_image_rgba as load_image

    img = np.asarray(load_image(path), np.float32)
    if img.ndim == 3:
        img = img[..., :3].mean(-1)
    return img / max(img.max(), 1e-6)


def crop_region(h: np.ndarray, region) -> np.ndarray:
    """Region = (x0, y0, x1, y1) in [0, 1] map fractions — the reference's
    map-region selection (GeodataApp builds meshes per chosen region)."""
    x0, y0, x1, y1 = region
    hh, ww = h.shape
    return h[int(y0 * hh) : max(int(y1 * hh), int(y0 * hh) + 2),
             int(x0 * ww) : max(int(x1 * ww), int(x0 * ww) + 2)]


def terrain_segment(h: np.ndarray, extent: float, height_scale: float,
                    step: int = 1):
    """Heightmap -> grid MeshSegment with analytic normals; ``step`` > 1
    builds a decimated far-LOD level."""
    from arkoserenderer.scene.scene import MeshSegment

    hs = h[::step, ::step]
    n, m = hs.shape
    xs = np.linspace(-extent / 2, extent / 2, m, dtype=np.float32)
    zs = np.linspace(-extent / 2, extent / 2, n, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs)
    yy = hs * height_scale
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)

    # Central-difference normals.
    dx = np.gradient(yy, xs, axis=1)
    dz = np.gradient(yy, zs, axis=0)
    nrm = np.stack([-dx, np.ones_like(yy), -dz], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm.reshape(-1, 3).astype(np.float32)

    uv = np.stack([xx / extent + 0.5, zz / extent + 0.5], axis=-1)
    uv = uv.reshape(-1, 2).astype(np.float32)

    idx = []
    for r in range(n - 1):
        for c in range(m - 1):
            a = r * m + c
            b = a + 1
            cu = a + m
            d = cu + 1
            idx.extend([a, cu, b, b, cu, d])
    return MeshSegment(positions=pos, normals=nrm, uvs=uv,
                       indices=np.array(idx, np.int32))


def altitude_texture(h: np.ndarray, size: int = 256) -> np.ndarray:
    """Bake an altitude/slope-colored albedo from the heightmap (RGBA8):
    water -> grass -> rock -> snow, the classic DEM shading ramp."""
    from arkoserenderer.ops.mattex import _np_resize_bilinear  # reuse

    hh = np.repeat(h[..., None], 4, axis=-1) * 255
    hr = _np_resize_bilinear(hh.astype(np.uint8), size, size)[..., 0] / 255.0
    water = np.array([60, 90, 140], np.float32)
    grass = np.array([70, 110, 55], np.float32)
    rock = np.array([120, 110, 100], np.float32)
    snow = np.array([235, 235, 240], np.float32)

    c = np.zeros((size, size, 3), np.float32)
    t1 = np.clip((hr - 0.12) / 0.05, 0, 1)[..., None]
    t2 = np.clip((hr - 0.45) / 0.2, 0, 1)[..., None]
    t3 = np.clip((hr - 0.8) / 0.1, 0, 1)[..., None]
    c = water * (1 - t1) + grass * t1
    c = c * (1 - t2) + rock * t2
    c = c * (1 - t3) + snow * t3
    a = np.full((size, size, 1), 255.0)
    return np.clip(np.concatenate([c, a], -1), 0, 255).astype(np.uint8)


def build_terrain_scene(heights: np.ndarray, viewport,
                        extent: float = 40.0, height_scale: float = 6.0):
    from arkoserenderer.assets.procedural import gradient_env_map
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight
    from arkoserenderer.scene.scene import Material, Scene

    n_pts = heights.shape[0] * heights.shape[1]
    scene = Scene(limits=SceneLimits(
        max_vertices=max(1 << 16, 2 * n_pts),
        max_indices=max(3 << 16, 12 * n_pts),
        max_drawables=64, max_materials=16, max_textures=16,
        texture_pool_texels=1 << 20,
    ))
    tex = scene.add_texture(altitude_texture(heights), srgb=True)
    mat = scene.add_material(Material(base_color_tex=tex, roughness_factor=0.95))

    fine = terrain_segment(heights, extent, height_scale, step=1)
    fine.material = mat
    coarse = terrain_segment(heights, extent, height_scale, step=4)
    coarse.material = mat
    fid = scene.add_segment(fine)
    cid = scene.add_segment(coarse)
    # Fine mesh near the camera, decimated level beyond (in-jit LOD bands —
    # the analogue of the reference's per-region tile LODs).
    scene.add_instance_lods([fid, cid], np.eye(4, dtype=np.float32),
                            distances=[extent * 0.9])

    scene.sun = DirectionalLight(
        direction=np.array([0.55, -0.65, -0.35], np.float32),
        illuminance_lux=95000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=9000.0)
    scene.ambient_lx = 7000.0

    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.32, height_scale * 1.6, extent * 0.38),
                (0.0, height_scale * 0.35, 0.0))
    return scene, cam


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--out", type=str, default="arkose_terrain.png")
    p.add_argument("--heightmap", type=str, default=None,
                   help="grayscale DEM image (default: procedural fBm)")
    p.add_argument("--region", type=float, nargs=4, default=None,
                   metavar=("X0", "Y0", "X1", "Y1"),
                   help="map-region crop in [0,1] fractions")
    p.add_argument("--grid", type=int, default=257, help="procedural DEM size")
    p.add_argument("--height-scale", type=float, default=6.0)
    args = p.parse_args(argv)

    h = load_heightmap(args.heightmap) if args.heightmap else fbm_heightmap(args.grid)
    if args.region:
        h = crop_region(h, args.region)

    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.utils.imageio import save_png

    scene, cam = build_terrain_scene(h, (args.width, args.height),
                                     height_scale=args.height_scale)
    cfg = PipelineConfig(
        width=args.width, height=args.height,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512,
                            bin_chunk=2048),
        shadow_map_size=1024,
    )
    r = Renderer(scene, cam, cfg)
    t0 = time.perf_counter()
    img = None
    for _ in range(args.frames):
        img = r.render_frame()
    ms = (time.perf_counter() - t0) / max(args.frames, 1) * 1e3
    save_png(args.out, np.asarray(img))
    print(f"{args.frames} frames @ {ms:.2f} ms/frame -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
