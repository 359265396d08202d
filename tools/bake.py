"""Asset bake tool: glTF -> baked .arkscene.npz.

Role-equivalent to the reference's offline tool chain
(tools/GltfImportTool + ImgAssetBakeTool + ArkAssetBakeTool driven by
AssetCooker rules, tools/bin/rules.toml): imports a glTF, generates mips,
tangents, and meshlets, and writes one baked scene file the runtime loads
without any parsing/processing.

Usage:
  python tools/bake.py input.gltf output.arkscene.npz [--max-texture 512]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="glTF/GLB file")
    ap.add_argument("output", help="baked .arkscene.npz path")
    ap.add_argument("--max-texture", type=int, default=512)
    ap.add_argument("--meshlets", action="store_true",
                    help="also report meshlet statistics")
    args = ap.parse_args(argv)

    from arkoserenderer.assets.baked import save_baked
    from arkoserenderer.assets.gltf import load_gltf
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.scene import Scene

    t0 = time.perf_counter()
    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 20, max_indices=3 << 20, max_drawables=4096,
        max_materials=1024, max_textures=512, texture_pool_texels=1 << 24,
    ))
    res = load_gltf(scene, args.input, max_texture_size=args.max_texture)
    if args.meshlets:
        from arkoserenderer.assets.meshopt import build_meshlets

        total = 0
        for seg in scene.segments:
            m = build_meshlets(seg.positions, seg.indices)
            total += m.count
        print(f"meshlets: {total}")
    save_baked(scene, args.output)
    print(
        f"baked {args.input} -> {args.output}: {res.instance_count} instances, "
        f"{len(scene.materials)} materials in {time.perf_counter() - t0:.2f}s"
    )


if __name__ == "__main__":
    main()
