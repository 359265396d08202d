"""Interactive live viewer app: fly camera + picking + gizmo + timing UI.

The interactive layer the reference builds with GLFW/ImGui/ImGuizmo
(Arkose.cpp's main loop, RenderPipeline.cpp:76-108 timing plot,
EditorGizmo.h:10-28, PickingNode.cpp, EditorScene.h's outliner) running
against the live renderer through the web System backend
(system/webviewer.py): open the printed URL, fly with WASD+QE, click a
surface (or a hierarchy row) to pick its instance, press 'g' to cycle the
gizmo mode — translate / rotate / scale, the ImGuizmo mode set — and
manipulate with arrows / PgUp / PgDn; watch the per-pass ms table against
the 16.667 ms budget.

Usage:
  python -m arkoserenderer.apps.viewer --port 8666 --frames 0   # 0 = run forever
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=384)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--port", type=int, default=8666)
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = until Ctrl-C / quit)")
    p.add_argument("--timings-every", type=int, default=0,
                   help="refresh the per-pass ms table every N frames (slow)")
    p.add_argument("--hot-reload", action="store_true",
                   help="watch pass/op sources; reload + reconstruct on save")
    args = p.parse_args(argv)

    from arkoserenderer.assets.procedural import build_test_scene
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig
    from arkoserenderer.scene.controllers import FpsCameraController
    from arkoserenderer.scene.editor import EditorScene
    from arkoserenderer.system.webviewer import WebSystem

    scene, cam = build_test_scene(viewport=(args.width, args.height))
    cfg = PipelineConfig(
        width=args.width, height=args.height,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=512,
                            bin_chunk=1024),
        shadow_map_size=512,
    )
    r = Renderer(scene, cam, cfg, dynamic_transforms=True)
    sysb = WebSystem(port=args.port)
    sysb.create_window(args.width, args.height, "arkoserenderer")
    editor = EditorScene(scene)
    controller = FpsCameraController(cam)
    print(f"viewer: http://127.0.0.1:{sysb.port}/  (Ctrl-C to stop)")

    watcher = None
    if args.hot_reload:
        from arkoserenderer.utils.hotreload import ModuleWatcher

        watcher = ModuleWatcher()

    from arkoserenderer.scene.editor import GizmoMode

    def hierarchy_entries():
        rows = []
        for i, (sid, w, *_rest) in enumerate(scene.instances):
            s = sid[0] if isinstance(sid, (list, tuple)) else sid
            seg = scene.segments[s]
            rows.append({
                "instance": i,
                "name": seg.name or f"segment {s}",
                "segment": int(s),
                "material": int(seg.material),
                "position": [round(float(v), 3) for v in w[:3, 3]],
            })
        return rows

    sysb.publish_hierarchy(hierarchy_entries())

    ema_ms = None
    n = 0
    last = time.perf_counter()
    translate_keys = {
        "arrowleft": (-0.1, 0, 0), "arrowright": (0.1, 0, 0),
        "arrowup": (0, 0, -0.1), "arrowdown": (0, 0, 0.1),
        "pageup": (0, 0.1, 0), "pagedown": (0, -0.1, 0),
    }
    # Rotate: arrows = yaw/pitch, PgUp/PgDn = roll (ImGuizmo's three rings).
    rotate_keys = {
        "arrowleft": ((0, 1, 0), 0.05), "arrowright": ((0, 1, 0), -0.05),
        "arrowup": ((1, 0, 0), 0.05), "arrowdown": ((1, 0, 0), -0.05),
        "pageup": ((0, 0, 1), 0.05), "pagedown": ((0, 0, 1), -0.05),
    }
    scale_keys = {"arrowup": 1.03, "pageup": 1.03,
                  "arrowdown": 1 / 1.03, "pagedown": 1 / 1.03}
    mode_order = [GizmoMode.TRANSLATE, GizmoMode.ROTATE, GizmoMode.SCALE]
    try:
        while sysb.new_frame():
            if watcher is not None and watcher.poll():
                r.reconstruct(rebuild_passes=True)
            now = time.perf_counter()
            dt = min(now - last, 0.1)
            last = now
            controller.update(sysb.input, dt)

            if sysb.input.was_pressed("g"):
                editor.gizmo_mode = mode_order[
                    (mode_order.index(editor.gizmo_mode) + 1) % 3
                ]
            moved = False
            if editor.selected is not None:
                if editor.gizmo_mode is GizmoMode.TRANSLATE:
                    for key, delta in translate_keys.items():
                        if sysb.input.is_down(key):
                            editor.translate(np.array(delta, np.float32))
                            moved = True
                elif editor.gizmo_mode is GizmoMode.ROTATE:
                    for key, (axis, ang) in rotate_keys.items():
                        if sysb.input.is_down(key):
                            editor.rotate(axis, ang)
                            moved = True
                else:
                    for key, f in scale_keys.items():
                        if sysb.input.is_down(key):
                            editor.scale(f)
                            moved = True
            if sysb.input.was_pressed("escape"):
                editor.selected = None
            for (x, y) in sysb.clicks:
                editor.select_from_pick(r.pick(x, y))
            sysb.clicks.clear()
            for inst in sysb.selects:
                editor.selected = inst if 0 <= inst < len(scene.instances) else None
            sysb.selects.clear()
            if moved:
                sysb.publish_hierarchy(hierarchy_entries())

            t0 = time.perf_counter()
            img = r.render_frame()
            ms = (time.perf_counter() - t0) * 1e3
            ema_ms = ms if ema_ms is None else 0.9 * ema_ms + 0.1 * ms
            sysb.present(img)

            stats = {
                "frame": n, "ms": ema_ms,
                "selected": -1 if editor.selected is None else int(editor.selected),
                "gizmo": editor.gizmo_mode.value,
            }
            if args.timings_every and n % args.timings_every == 0:
                from arkoserenderer.utils.timing import time_passes

                t = time_passes(r.pipeline, r.state, r.scene_arrays,
                                cam.state(r.frame_index), iters=1)
                stats["timings"] = {k: float(v) for k, v in t.items()}
            sysb.publish_stats(**stats)

            n += 1
            if args.frames and n >= args.frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        sysb.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
