#!/usr/bin/env python
"""arkbake: re-serialize an .ark* asset into the Binary storage flavor.

The analogue of the reference's ArkAssetBakeTool
(tools/ArkAssetBakeTool.cpp): load an asset file of any supported type in
either storage flavor (cereal JSON or Binary, sniffed by magic) and write
it back as AssetStorage::Binary — the compact flavor the reference's
AssetCooker bake rules produce for shipping.

Usage:
    python tools/arkbake.py <SourceArkFile> <TargetArkFile>

Supported: .arkmsh .arkmat .arklvl .arkskel .arkanim .arkset .arkhair
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from arkoserenderer.assets import cereal_binary as cb  # noqa: E402
from arkoserenderer.assets.ark import read_ark_document  # noqa: E402

# extension -> JSON top-level nvp (mirrors the per-type writeToFile nvps,
# e.g. MeshAsset.cpp:910 "mesh")
_KEYS = {ext: cb.MAGICS[m][0] for ext, m in cb._EXT_TO_MAGIC.items()}


def main(argv: list[str]) -> int:
    if len(argv) != 3:
        print("arkbake: must be called as\n"
              "> python tools/arkbake.py <SourceArkFile> <TargetArkFile>",
              file=sys.stderr)
        return 1
    src, dst = Path(argv[1]), Path(argv[2])
    ext = src.suffix
    if ext not in _KEYS:
        print(f"arkbake: unknown arkose asset type '{ext}'", file=sys.stderr)
        return 1
    if dst.suffix != ext:
        print(f"arkbake: source/target extension mismatch ({ext} vs "
              f"{dst.suffix})", file=sys.stderr)
        return 1
    doc = read_ark_document(src, _KEYS[ext])
    cb.write_ark_binary(dst, doc)
    print(f"arkbake: wrote binary {dst} ({dst.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
