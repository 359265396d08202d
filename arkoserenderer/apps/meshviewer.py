"""Mesh viewer: asset inspection, editing, and turntable / debug rendering.

Role-equivalent to MeshViewerApp (arkose/application/apps/MeshViewerApp.cpp
— the 893-LoC asset inspector/editor with LOD/segment UI): prints the
asset's structure (segments, materials, skeletons, animations, meshlet
statistics), inspects individual segments (bounds, UV coverage, meshlet
histogram), renders turntable strips in the lit pipeline OR any G-buffer
debug channel (normals / ids / depth / roughness...), supports simple
MATERIAL EDITS saved back to the baked format (the editing half of the
reference app), and can serve an interactive orbit view over HTTP.

Usage:
  python -m arkoserenderer.apps.meshviewer model.gltf --frames 8
  python -m arkoserenderer.apps.meshviewer a.npz --inspect-segment 0
  python -m arkoserenderer.apps.meshviewer a.npz --view normal
  python -m arkoserenderer.apps.meshviewer a.npz \
      --set-material 1 roughness_factor=0.2 metallic_factor=1 --save b.npz
  python -m arkoserenderer.apps.meshviewer a.npz --interactive --port 8667
"""

from __future__ import annotations

import argparse

import numpy as np


def describe(scene) -> str:
    lines = []
    total_tris = sum(s.num_triangles for s in scene.segments)
    total_verts = sum(len(s.positions) for s in scene.segments)
    lines.append(
        f"segments: {len(scene.segments)}  vertices: {total_verts}  triangles: {total_tris}"
    )
    for i, seg in enumerate(scene.segments):
        skin = f" skeleton={seg.skeleton}" if seg.skeleton >= 0 else ""
        lines.append(
            f"  [{i:3d}] verts={len(seg.positions):7d} tris={seg.num_triangles:7d} "
            f"material={seg.material}{skin}"
        )
    lines.append(f"materials: {len(scene.materials)}")
    for i, m in enumerate(scene.materials):
        lines.append(
            f"  [{i:3d}] base={np.round(m.base_color_factor, 2).tolist()} "
            f"rough={m.roughness_factor:.2f} metal={m.metallic_factor:.2f} "
            f"blend={m.blend_mode} tex(bc/n/mr)={m.base_color_tex}/{m.normal_tex}/{m.mr_tex}"
        )
    if scene.skeletons:
        lines.append(
            f"skeletons: {len(scene.skeletons)} "
            f"({[s.num_joints for s in scene.skeletons]} joints)"
        )
    if scene.animations:
        lines.append(
            "animations: "
            + ", ".join(f"{c.name or '?'} ({c.duration:.2f}s)" for c in scene.animations)
        )
    return "\n".join(lines)


def inspect_segment(scene, idx: int) -> str:
    """Per-segment drill-down (the reference's segment UI panel)."""
    from arkoserenderer.assets.meshopt import build_meshlets

    seg = scene.segments[idx]
    lines = [f"segment [{idx}]"]
    lo = seg.positions.min(0)
    hi = seg.positions.max(0)
    lines.append(f"  bounds min {np.round(lo, 3).tolist()}")
    lines.append(f"  bounds max {np.round(hi, 3).tolist()}")
    lines.append(f"  verts {len(seg.positions)}  tris {seg.num_triangles}"
                 f"  material {seg.material}  skeleton {seg.skeleton}")
    uv = seg.uvs
    lines.append(f"  uv range [{uv.min():.3f}, {uv.max():.3f}]"
                 f"  tangents {'yes' if seg.tangents is not None else 'no'}"
                 f"  morphs {0 if seg.morph_pos is None else len(seg.morph_pos)}")
    ml = build_meshlets(seg.positions, seg.indices)
    if ml.count:
        counts = np.asarray(ml.tri_count[: ml.count])
        lines.append(f"  meshlets {ml.count} (tris/meshlet min {counts.min()}"
                     f" avg {counts.mean():.1f} max {counts.max()})")
    # Which instances reference this segment (LOD band view).
    users = [
        (i, band) for i, (sid, w, pw, clip, band) in enumerate(scene.instances)
        if sid == idx
    ]
    for i, band in users:
        far = "inf" if band[1] > 1e30 else f"{band[1]:.1f}"
        lines.append(f"  instance {i}: lod band [{band[0]:.1f}, {far})")
    return "\n".join(lines)


def apply_material_edits(scene, edits: list) -> None:
    """--set-material IDX key=value...: the editing half of MeshViewerApp."""
    idx = int(edits[0])
    m = scene.materials[idx]
    for kv in edits[1:]:
        key, _, val = kv.partition("=")
        assert hasattr(m, key), f"material has no field {key!r}"
        cur = getattr(m, key)
        if isinstance(cur, np.ndarray):
            vals = np.asarray([float(x) for x in val.split(",")], np.float32)
            assert vals.shape == cur.shape, f"{key} needs {cur.shape}"
            setattr(m, key, vals)
        elif isinstance(cur, bool):
            setattr(m, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(m, key, int(val))
        else:
            setattr(m, key, float(val))
    print(f"edited material {idx}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("asset", help="glTF/GLB or baked .arkscene.npz")
    ap.add_argument("--frames", type=int, default=8, help="turntable frame count")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", type=str, default="/tmp/meshviewer_{frame}.png")
    ap.add_argument("--meshlets", action="store_true")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--inspect-segment", type=int, default=None)
    ap.add_argument("--view", type=str, default=None,
                    help="debug channel render (normal/depth/instance/...)")
    ap.add_argument("--set-material", nargs="+", default=None,
                    metavar="IDX KEY=VAL",
                    help="edit material fields (e.g. 1 roughness_factor=0.3)")
    ap.add_argument("--save", type=str, default=None,
                    help="write the (possibly edited) scene as baked .npz")
    ap.add_argument("--interactive", action="store_true",
                    help="serve an orbit view over HTTP (web viewer)")
    ap.add_argument("--port", type=int, default=8667)
    args = ap.parse_args(argv)

    from arkoserenderer.assets.procedural import gradient_env_map
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.scene import Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 19, max_indices=3 << 19, max_drawables=1024,
        max_materials=256, max_textures=256, texture_pool_texels=1 << 23,
    ))
    if str(args.asset).endswith(".npz"):
        from arkoserenderer.assets.baked import load_baked

        scene = load_baked(args.asset, limits=scene.limits)
    elif str(args.asset).endswith(".arkmsh"):
        # The reference's own serialized mesh format (assets/ark.py).
        import numpy as _np

        from arkoserenderer.assets.ark import load_arkmsh

        for sid in load_arkmsh(scene, args.asset, max_texture_size=256):
            scene.add_instance(sid, _np.eye(4, dtype=_np.float32))
    else:
        from arkoserenderer.assets.gltf import load_gltf

        load_gltf(scene, args.asset, max_texture_size=256)

    print(describe(scene))
    if args.inspect_segment is not None:
        print(inspect_segment(scene, args.inspect_segment))
    if args.set_material:
        apply_material_edits(scene, args.set_material)
    if args.save:
        from arkoserenderer.assets.baked import save_baked

        save_baked(scene, args.save)
        print(f"saved {args.save}")
    if args.meshlets:
        from arkoserenderer.assets.meshopt import build_meshlets

        total = sum(
            build_meshlets(s.positions, s.indices).count for s in scene.segments
        )
        print(f"meshlets: {total}")

    if args.no_render:
        return

    from arkoserenderer.assets.procedural import gradient_env_map
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.camera import Camera
    from arkoserenderer.scene.lights import DirectionalLight
    from arkoserenderer.utils.imageio import save_png

    scene.sun = DirectionalLight(direction=np.array([0.4, -1.0, -0.3], np.float32))
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0
    cam = Camera(viewport=(args.size, args.size))
    center, radius = scene.bounding_sphere()
    cfg = PipelineConfig(
        width=args.size, height=args.size,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512),
        shadow_map_size=512,
    )
    cam.look_at(center + np.array([radius * 2.0, radius * 0.7, 0.0]), center)
    r = Renderer(scene, cam, cfg, taa=False)
    if args.view:
        from arkoserenderer.rendering.passes.debugviz import DebugVisualizePass

        r.pipeline.passes.append(DebugVisualizePass(args.view))
        r.pipeline.construct_all()
        r.state = r.pipeline.initial_state()
    if args.interactive:
        import time

        from arkoserenderer.system.webviewer import WebSystem

        sysb = WebSystem(port=args.port)
        sysb.create_window(args.size, args.size, "meshviewer")
        print(f"meshviewer: http://127.0.0.1:{sysb.port}/  (Ctrl-C to stop)")
        t0 = time.perf_counter()
        n = 0
        try:
            while sysb.new_frame():
                angle = 0.4 * (time.perf_counter() - t0)
                eye = center + radius * 2.0 * np.array(
                    [np.cos(angle), 0.35, np.sin(angle)], np.float32
                )
                cam.look_at(eye, center)
                ts = time.perf_counter()
                sysb.present(np.asarray(r.render_frame()))
                sysb.publish_stats(frame=n, ms=(time.perf_counter() - ts) * 1e3)
                n += 1
                if args.frames and n >= args.frames:
                    break
        except KeyboardInterrupt:
            pass
        finally:
            sysb.stop()
        return
    for f in range(args.frames):
        angle = 2 * np.pi * f / args.frames
        eye = center + radius * 2.0 * np.array(
            [np.cos(angle), 0.35, np.sin(angle)], np.float32
        )
        cam.look_at(eye, center)
        img = np.asarray(r.render_frame())
        save_png(args.out.format(frame=f), img)
    print(f"rendered {args.frames} turntable frames -> {args.out}")


if __name__ == "__main__":
    main()
