"""Asset cooker: dependency-tracked offline asset baking.

Role-equivalent to the reference's AssetCooker orchestration
(tools/bin/config.toml + tools/bin/rules.toml:1-60 + RunAssetCooker.bat —
a file-watching build system that maps source assets through per-type bake
tools: glTF -> .ark*, .imgspec -> mips + BC .dds, IES copy, level bake).

This cooker reads a TOML rules file, expands input globs, and runs the
matching built-in bake tool for every OUT-OF-DATE output — staleness is
tracked in a JSON database next to the rules file recording each output's
input content hashes and the tool version, so edits rebuild exactly the
affected outputs (the reference's dependency tracking). Independent bakes
run in parallel on the TaskGraph worker pool.

rules.toml format:
    [[rule]]
    name = "bake scenes"
    tool = "gltf"              # gltf | image | bc7 | ies | hair | copy
    input = "models/*.gltf"    # glob, relative to the rules file
    output = "baked/{stem}.arkscene.npz"
    # optional tool args:
    max_texture = 512

Usage:
    python tools/cooker.py rules.toml [--force] [--dry-run]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOOL_VERSION = 2  # bump to invalidate every cooked output


def _hash_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:24]


# ---------------------------------------------------------------------------
# Built-in bake tools (the GltfImportTool / ImgAssetBakeTool / IESConvertTool
# / HairImportTool equivalents). Each returns a list of EXTRA input files it
# consumed (discovered dependencies — e.g. a glTF's .bin and images), which
# the cooker folds into the dependency record.


def _tool_gltf(inp: Path, out: Path, rule: dict) -> list[Path]:
    from arkoserenderer.assets.baked import save_baked
    from arkoserenderer.assets.gltf import load_gltf
    from arkoserenderer.core.types import SceneLimits
    from arkoserenderer.scene.scene import Scene

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 20, max_indices=3 << 20, max_drawables=4096,
        max_materials=1024, max_textures=512, texture_pool_texels=1 << 24,
    ))
    load_gltf(scene, str(inp), max_texture_size=int(rule.get("max_texture", 512)))
    save_baked(scene, str(out))
    # Sidecar dependencies: .bin buffers + referenced images in the folder.
    deps = sorted(inp.parent.glob("*.bin"))
    for ext in ("*.png", "*.jpg", "*.jpeg"):
        deps += sorted(inp.parent.glob(ext))
    return deps


def _tool_image(inp: Path, out: Path, rule: dict) -> list[Path]:
    """Image -> mip chain .npz (ImgAssetBakeTool's mips half)."""
    import numpy as np

    from arkoserenderer.ops.mattex import _mip_chain
    from arkoserenderer.utils.imageio import load_image_rgba

    img = load_image_rgba(str(inp)).astype(np.float32)
    mips = _mip_chain(img)
    np.savez_compressed(out, **{f"mip{i}": m.astype(np.uint8)
                                for i, m in enumerate(mips)})
    return []


def _tool_bc7(inp: Path, out: Path, rule: dict) -> list[Path]:
    """Image -> BC7 .dds (ImgAssetBakeTool's block-compress half,
    TextureCompressor.cpp:57-79)."""
    import struct

    import numpy as np

    from arkoserenderer.assets.bc7 import compress_bc7
    from arkoserenderer.utils.imageio import load_image_rgba

    img = load_image_rgba(str(inp))
    h = (img.shape[0] + 3) // 4 * 4
    w = (img.shape[1] + 3) // 4 * 4
    padded = np.zeros((h, w, 4), np.uint8)
    padded[: img.shape[0], : img.shape[1]] = img
    # quality: "fast" (mode 6 only) | "balanced" | "thorough" (full profile)
    # rdo_lambda > 0: rate-distortion repeat pass (bc7enc_rdo's -z lambda)
    blocks = compress_bc7(padded, quality=rule.get("quality", "balanced"),
                          rdo_lambda=float(rule.get("rdo_lambda", 0.0)))
    pf = struct.pack("<II4sIIIII", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    hdr = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1)
           + b"\0" * 44 + pf + b"\0" * 20)
    dx10 = struct.pack("<5I", 98, 3, 0, 1, 0)  # DXGI_FORMAT_BC7_UNORM
    out.write_bytes(hdr + dx10 + blocks.tobytes())
    return []


def _tool_ies(inp: Path, out: Path, rule: dict) -> list[Path]:
    import numpy as np

    from arkoserenderer.assets.external import IESProfile

    lut = IESProfile.parse(inp.read_text(errors="replace")).to_lut()
    np.savez_compressed(out, lut=np.asarray(lut, np.float32))
    return []


def _tool_hair(inp: Path, out: Path, rule: dict) -> list[Path]:
    import numpy as np

    from arkoserenderer.assets.external import HairFile

    hf = HairFile.parse(inp.read_bytes())
    np.savez_compressed(
        out, points=hf.points, segments=np.asarray(hf.segments, np.int64)
    )
    return []


def _tool_copy(inp: Path, out: Path, rule: dict) -> list[Path]:
    out.write_bytes(inp.read_bytes())
    return []


TOOLS = {
    "gltf": _tool_gltf,
    "image": _tool_image,
    "bc7": _tool_bc7,
    "ies": _tool_ies,
    "hair": _tool_hair,
    "copy": _tool_copy,
}


# ---------------------------------------------------------------------------


class Cooker:
    def __init__(self, rules_path: Path):
        import tomllib

        self.root = rules_path.parent
        self.rules = tomllib.loads(rules_path.read_text()).get("rule", [])
        self.db_path = self.root / ".cook.db.json"
        try:
            self.db = json.loads(self.db_path.read_text())
        except (OSError, json.JSONDecodeError):
            self.db = {}

    def _record(self, out: Path, inputs: list[Path]) -> dict:
        return {
            "tool_version": TOOL_VERSION,
            "inputs": {str(p): _hash_file(p) for p in inputs if p.exists()},
        }

    def _stale(self, out: Path, inputs: list[Path]) -> bool:
        if not out.exists():
            return True
        rec = self.db.get(str(out))
        if rec is None or rec.get("tool_version") != TOOL_VERSION:
            return True
        old = rec.get("inputs", {})
        cur = {str(p): _hash_file(p) for p in inputs if p.exists()}
        return old != cur

    def plan(self):
        """Yields (rule, input_path, output_path, stale)."""
        for rule in self.rules:
            tool = rule["tool"]
            assert tool in TOOLS, f"unknown tool {tool!r}"
            for inp in sorted(self.root.glob(rule["input"])):
                out = self.root / rule["output"].format(
                    stem=inp.stem, name=inp.name
                )
                known = self.db.get(str(out), {}).get("inputs", {})
                deps = [inp] + [Path(p) for p in known if p != str(inp)]
                yield rule, inp, out, self._stale(out, deps)

    def cook(self, force: bool = False, dry_run: bool = False) -> dict:
        from arkoserenderer.core.taskgraph import schedule_task, wait_for_completion

        built, skipped, futures = [], [], []
        for rule, inp, out, stale in self.plan():
            if not (stale or force):
                skipped.append(str(out))
                continue
            if dry_run:
                built.append(str(out))
                continue

            def job(rule=rule, inp=inp, out=out):
                out.parent.mkdir(parents=True, exist_ok=True)
                extra = TOOLS[rule["tool"]](inp, out, rule)
                return out, [inp] + list(extra)

            futures.append(schedule_task(job))
            built.append(str(out))
        wait_for_completion(futures)
        for f in futures:
            out, inputs = f.result()
            self.db[str(out)] = self._record(out, inputs)
        if not dry_run:
            self.db_path.write_text(json.dumps(self.db, indent=1, sort_keys=True))
        return {"built": built, "skipped": skipped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("rules", help="rules.toml path")
    ap.add_argument("--force", action="store_true", help="rebuild everything")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    cooker = Cooker(Path(args.rules))
    res = cooker.cook(force=args.force, dry_run=args.dry_run)
    dt = time.perf_counter() - t0
    print(f"cooked {len(res['built'])} asset(s), {len(res['skipped'])} "
          f"up-to-date in {dt:.2f}s")
    for b in res["built"]:
        print(f"  built {b}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
