"""Baked scene assets: versioned binary serialization + cache.

Role-equivalent to the reference's asset serialization layer
(arkcore/asset/Asset.h:15-99 — cereal binary archives with a 4-char magic +
per-class versioning — and the typed .arkmsh/.arkmat/.arklvl files): a baked
scene is a single ``.arkscene.npz`` holding every imported segment, material,
texture (pre-mipped packed texel pool), light, skeleton and animation, so
runtime load skips glTF parsing / mip generation / tangent generation
entirely (the AssetCooker bake flow). Versioned; unknown versions are
rejected like the reference's asset version checks.

AssetCache mirrors arkcore/asset/AssetCache.h: in-memory, keyed by
(path, mtime).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from arkoserenderer.core.logging import get_logger
from arkoserenderer.scene.animation import AnimationClip, AnimChannel, Skeleton
from arkoserenderer.scene.lights import DirectionalLight, PointLight, SpotLight
from arkoserenderer.scene.scene import LOD_FAR, Material, MeshSegment, Scene

log = get_logger("baked")

MAGIC = "ARKS"
VERSION = 1

_MAT_FIELDS = [f.name for f in dataclasses.fields(Material)]


def save_baked(scene: Scene, path: str | Path) -> None:
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"magic": MAGIC, "version": VERSION}

    meta["num_segments"] = len(scene.segments)
    for i, seg in enumerate(scene.segments):
        arrays[f"seg{i}.positions"] = seg.positions
        arrays[f"seg{i}.normals"] = seg.normals
        arrays[f"seg{i}.uvs"] = seg.uvs
        arrays[f"seg{i}.tangents"] = seg.tangents
        arrays[f"seg{i}.indices"] = seg.indices
        if seg.skin_joints is not None:
            arrays[f"seg{i}.skin_joints"] = seg.skin_joints
            arrays[f"seg{i}.skin_weights"] = seg.skin_weights
    meta["segments"] = [
        {"material": s.material, "skeleton": s.skeleton} for s in scene.segments
    ]

    meta["materials"] = [
        {
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(m).items()
        }
        for m in scene.materials
    ]

    meta["instances"] = []
    for sid, world, prev, clip, lod_band in scene.instances:
        meta["instances"].append({
            "segment": sid, "clip": clip,
            "lod_band": [float(lod_band[0]), float(lod_band[1])],
        })
        arrays[f"inst{len(meta['instances']) - 1}.world"] = world

    # Texture pool builder internals (pre-mipped, packed).
    b = scene.texture_builder
    arrays["tex.texels"] = (
        np.concatenate(b._texels) if b._texels else np.zeros(0, np.uint32)
    )
    arrays["tex.offset"] = b._offset
    arrays["tex.size"] = b._size
    arrays["tex.n_mips"] = b._n_mips
    arrays["tex.srgb"] = b._srgb
    arrays["tex.wrap"] = b._wrap
    meta["tex"] = {"cursor": b._cursor, "count": b._count}

    meta["num_skeletons"] = len(scene.skeletons)
    for i, sk in enumerate(scene.skeletons):
        arrays[f"skel{i}.parents"] = sk.parents
        arrays[f"skel{i}.inverse_bind"] = sk.inverse_bind
        arrays[f"skel{i}.rest_t"] = sk.rest_translation
        arrays[f"skel{i}.rest_r"] = sk.rest_rotation
        arrays[f"skel{i}.rest_s"] = sk.rest_scale

    meta["animations"] = []
    for ai, clip in enumerate(scene.animations):
        chans = []
        for ci, ch in enumerate(clip.channels):
            arrays[f"anim{ai}.ch{ci}.times"] = ch.times
            arrays[f"anim{ai}.ch{ci}.values"] = ch.values
            chans.append(
                {"joint": ch.target_joint, "path": ch.path, "interp": ch.interpolation}
            )
        meta["animations"].append({"name": clip.name, "channels": chans})

    if scene.sun is not None:
        meta["sun"] = {
            "direction": scene.sun.direction.tolist(),
            "color": scene.sun.color.tolist(),
            "illuminance_lux": scene.sun.illuminance_lux,
        }
    meta["spots"] = [
        {
            "position": np.asarray(s.position).tolist(),
            "direction": np.asarray(s.direction).tolist(),
            "color": np.asarray(s.color).tolist(),
            "cd": s.luminous_intensity_cd,
            "inner": float(s.inner_cone_angle),
            "outer": float(s.outer_cone_angle),
        }
        for s in scene.spots
    ]
    meta["points"] = [
        {
            "position": np.asarray(p.position).tolist(),
            "color": np.asarray(p.color).tolist(),
            "cd": p.luminous_intensity_cd,
        }
        for p in scene.points
    ]
    arrays["env_map"] = scene.env_map
    meta["env_brightness"] = scene.env_brightness
    meta["ambient_lx"] = scene.ambient_lx

    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    log.info("baked scene -> %s (%d segments)", path, len(scene.segments))


def load_baked(path: str | Path, limits=None) -> Scene:
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta.get("magic") != MAGIC:
        raise ValueError(f"not an {MAGIC} baked scene: {path}")
    if meta.get("version") != VERSION:
        raise ValueError(
            f"baked scene version {meta.get('version')} != supported {VERSION}"
        )

    from arkoserenderer.core.types import SceneLimits

    scene = Scene(limits=limits or SceneLimits())
    # Restore the texture pool builder wholesale.
    b = scene.texture_builder
    texels = z["tex.texels"]
    b._texels = [texels] if len(texels) else []
    b._offset = z["tex.offset"].copy()
    b._size = z["tex.size"].copy()
    b._n_mips = z["tex.n_mips"].copy()
    b._srgb = z["tex.srgb"].copy()
    b._wrap = z["tex.wrap"].copy()
    b._cursor = meta["tex"]["cursor"]
    b._count = meta["tex"]["count"]

    scene.materials = []
    for md in meta["materials"]:
        kwargs = {}
        for k, v in md.items():
            if k not in _MAT_FIELDS:
                continue
            kwargs[k] = np.array(v, np.float32) if isinstance(v, list) else v
        scene.materials.append(Material(**kwargs))

    for i, sm in enumerate(meta["segments"]):
        seg = MeshSegment(
            positions=z[f"seg{i}.positions"],
            normals=z[f"seg{i}.normals"],
            uvs=z[f"seg{i}.uvs"],
            tangents=z[f"seg{i}.tangents"],
            indices=z[f"seg{i}.indices"],
            material=sm["material"],
        )
        if f"seg{i}.skin_joints" in z:
            seg.skin_joints = z[f"seg{i}.skin_joints"]
            seg.skin_weights = z[f"seg{i}.skin_weights"]
            seg.skeleton = sm["skeleton"]
        scene.segments.append(seg)

    for i in range(meta["num_skeletons"]):
        scene.skeletons.append(
            Skeleton(
                parents=z[f"skel{i}.parents"],
                inverse_bind=z[f"skel{i}.inverse_bind"],
                rest_translation=z[f"skel{i}.rest_t"],
                rest_rotation=z[f"skel{i}.rest_r"],
                rest_scale=z[f"skel{i}.rest_s"],
            )
        )

    for ai, ad in enumerate(meta["animations"]):
        channels = [
            AnimChannel(
                target_joint=cd["joint"], path=cd["path"],
                times=z[f"anim{ai}.ch{ci}.times"], values=z[f"anim{ai}.ch{ci}.values"],
                interpolation=cd["interp"],
            )
            for ci, cd in enumerate(ad["channels"])
        ]
        scene.animations.append(AnimationClip(channels=channels, name=ad["name"]))

    for i, inst in enumerate(meta["instances"]):
        scene.add_instance(
            inst["segment"], z[f"inst{i}.world"], clip=inst["clip"],
            lod_band=tuple(inst.get("lod_band", (0.0, LOD_FAR))),
        )

    if "sun" in meta:
        s = meta["sun"]
        scene.sun = DirectionalLight(
            direction=np.array(s["direction"], np.float32),
            color=np.array(s["color"], np.float32),
            illuminance_lux=s["illuminance_lux"],
        )
    for s in meta["spots"]:
        scene.spots.append(SpotLight(
            position=np.array(s["position"], np.float32),
            direction=np.array(s["direction"], np.float32),
            color=np.array(s["color"], np.float32),
            luminous_intensity_cd=s["cd"],
            inner_cone_angle=s["inner"], outer_cone_angle=s["outer"],
        ))
    for p in meta["points"]:
        scene.points.append(PointLight(
            position=np.array(p["position"], np.float32),
            color=np.array(p["color"], np.float32),
            luminous_intensity_cd=p["cd"],
        ))
    scene.env_map = z["env_map"]
    scene.env_brightness = meta["env_brightness"]
    scene.ambient_lx = meta["ambient_lx"]
    return scene


class AssetCache:
    """In-memory (path, mtime)-keyed cache (arkcore/asset/AssetCache.h)."""

    def __init__(self):
        self._cache: dict[str, tuple[float, object]] = {}

    def load(self, path: str | Path, loader):
        path = str(path)
        mtime = Path(path).stat().st_mtime
        hit = self._cache.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
        obj = loader(path)
        self._cache[path] = (mtime, obj)
        return obj

    def clear(self):
        self._cache.clear()
