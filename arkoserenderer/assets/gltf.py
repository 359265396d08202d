"""glTF 2.0 importer.

Role-equivalent to the reference's GltfLoader / AssetImporter
(arkcore/asset/import/GltfLoader.cpp, AssetImporter.h:29-94): parses .gltf /
.glb, decodes accessors, flattens the node hierarchy into world-space mesh
instances, imports PBR metallic-roughness materials and their textures, and
feeds everything into a Scene. Written from the public glTF 2.0 spec on
NumPy + PIL — no external glTF library.

Supported: embedded/external buffers, data URIs, GLB container, POSITION /
NORMAL / TEXCOORD_0 / TANGENT / JOINTS_0 / WEIGHTS_0 attributes, u8/u16/u32
indices, node TRS + matrix transforms, baseColor / metallicRoughness /
normal / emissive / occlusion textures, alphaMode, doubleSided, sampler wrap
modes, KHR_materials_emissive_strength, KHR_texture_transform (baked into
mesh UVs at import; see _material_uv_transform), skins (JOINTS/WEIGHTS +
skeleton import) and animations (all three TRS channel paths + morph
weights). TODO: Draco (KHR_draco_mesh_compression assets are rejected with
a clear error; the entropy decoder is out of scope for a from-scratch
importer).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
from pathlib import Path

import numpy as np

from arkoserenderer.core.logging import get_logger
from arkoserenderer.ops.texture import WRAP_CLAMP, WRAP_REPEAT
from arkoserenderer.scene.scene import (
    BLEND_MASKED,
    BLEND_OPAQUE,
    BLEND_TRANSLUCENT,
    Material,
    MeshSegment,
    Scene,
    generate_tangents_uv,
)

log = get_logger("gltf")

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclasses.dataclass
class GltfFile:
    doc: dict
    buffers: list[bytes]
    base_dir: Path


def _load_uri(uri: str, base_dir: Path) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    from urllib.parse import unquote

    return (base_dir / unquote(uri)).read_bytes()


def parse_gltf(path: str | Path) -> GltfFile:
    path = Path(path)
    data = path.read_bytes()
    if data[:4] == b"glTF":  # GLB container
        _, _, _ = struct.unpack_from("<III", data, 0)
        offset = 12
        doc = None
        bin_chunk = b""
        while offset < len(data):
            length, kind = struct.unpack_from("<II", data, offset)
            chunk = data[offset + 8 : offset + 8 + length]
            if kind == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif kind == 0x004E4942:  # BIN
                bin_chunk = chunk
            offset += 8 + length
        assert doc is not None, "GLB missing JSON chunk"
        buffers = []
        for i, b in enumerate(doc.get("buffers", [])):
            if "uri" in b:
                buffers.append(_load_uri(b["uri"], path.parent))
            else:
                buffers.append(bin_chunk)
    else:
        doc = json.loads(data)
        buffers = [_load_uri(b["uri"], path.parent) for b in doc.get("buffers", [])]
    return GltfFile(doc=doc, buffers=buffers, base_dir=path.parent)


def read_accessor(g: GltfFile, index: int) -> np.ndarray:
    acc = g.doc["accessors"][index]
    n = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" not in acc:
        out = np.zeros((n, ncomp), dtype)
    else:
        bv = g.doc["bufferViews"][acc["bufferView"]]
        buf = g.buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            out = np.frombuffer(buf, dtype, count=n * ncomp, offset=start).reshape(n, ncomp)
        else:
            raw = np.frombuffer(buf, np.uint8)
            rows = np.lib.stride_tricks.as_strided(
                raw[start:], shape=(n, itemsize), strides=(stride, 1)
            )
            out = rows.reshape(-1).view(dtype).reshape(n, ncomp)
    out = np.array(out)  # own the memory

    if "sparse" in acc:
        sp = acc["sparse"]
        cnt = sp["count"]
        idx_acc = sp["indices"]
        bv = g.doc["bufferViews"][idx_acc["bufferView"]]
        idt = _COMPONENT_DTYPES[idx_acc["componentType"]]
        idx = np.frombuffer(
            g.buffers[bv["buffer"]], idt, count=cnt,
            offset=bv.get("byteOffset", 0) + idx_acc.get("byteOffset", 0),
        ).astype(np.int64)
        val_acc = sp["values"]
        bv = g.doc["bufferViews"][val_acc["bufferView"]]
        vals = np.frombuffer(
            g.buffers[bv["buffer"]], dtype, count=cnt * ncomp,
            offset=bv.get("byteOffset", 0) + val_acc.get("byteOffset", 0),
        ).reshape(cnt, ncomp)
        out[idx] = vals
    if acc.get("normalized") and dtype != np.float32:
        # After sparse substitution, so sparse values normalize too.
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major file
    m = np.eye(4, dtype=np.float32)
    s = np.array(node.get("scale", [1, 1, 1]), np.float32)
    q = np.array(node.get("rotation", [0, 0, 0, 1]), np.float32)  # (x,y,z,w)
    t = np.array(node.get("translation", [0, 0, 0]), np.float32)
    x, y, z, w = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m[:3, :3] = rot * s[None, :]
    m[:3, 3] = t
    return m


def flatten_nodes(g: GltfFile) -> list[tuple[int, np.ndarray, int]]:
    """Returns [(mesh_index, world_transform, node_index)] for scene 0."""
    doc = g.doc
    out = []

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            out.append((node["mesh"], world, node_idx))
        for c in node.get("children", []):
            walk(c, world)

    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
    for root in scene.get("nodes", []):
        walk(root, np.eye(4, dtype=np.float32))
    return out


def _pow2_floor(x: int) -> int:
    return 1 << max(x.bit_length() - 1, 0)


def _load_image(g: GltfFile, image_index: int, max_size: int) -> np.ndarray:
    from PIL import Image
    import io

    img = g.doc["images"][image_index]
    if "uri" in img:
        data = _load_uri(img["uri"], g.base_dir)
    else:
        bv = g.doc["bufferViews"][img["bufferView"]]
        start = bv.get("byteOffset", 0)
        data = g.buffers[bv["buffer"]][start : start + bv["byteLength"]]
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGBA")
        # Mip chains need power-of-two dims; clamp the largest side.
        tw = min(_pow2_floor(im.width), max_size)
        th = min(_pow2_floor(im.height), max_size)
        if (tw, th) != (im.width, im.height):
            im = im.resize((max(tw, 1), max(th, 1)), Image.LANCZOS)
        return np.asarray(im)


_WRAP_MAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_REPEAT}  # mirrored->repeat


@dataclasses.dataclass
class GltfImportResult:
    """Counterpart of the reference's ImportResult (AssetImporter.h:49-66)."""

    segment_ids: list[int]
    instance_count: int
    material_ids: list[int]
    texture_ids: dict[tuple[int, bool], int]


def load_gltf(
    scene: Scene,
    path: str | Path,
    root_transform: np.ndarray | None = None,
    max_texture_size: int = 512,
    import_cameras_and_lights: bool = False,
    play_animation: bool = True,
) -> GltfImportResult:
    """Import a glTF file's default scene into ``scene``: static instances,
    plus skinned instances (skins -> Skeletons, animations -> clips) bound to
    the first animation clip when ``play_animation``."""
    g = parse_gltf(path)
    doc = g.doc
    root = root_transform if root_transform is not None else np.eye(4, dtype=np.float32)

    skins = _import_skins(g, scene)
    clip_ids = _import_animations(g, scene, skins)

    # -- textures (deduped by (source image, srgb)) ------------------------------
    texture_ids: dict[tuple[int, bool], int] = {}

    def get_texture(tex_index: int, srgb: bool) -> int:
        tex = doc["textures"][tex_index]
        src = tex.get("source", 0)
        key = (src, srgb)
        if key not in texture_ids:
            pixels = _load_image(g, src, max_texture_size)
            wrap = WRAP_REPEAT
            if "sampler" in tex:
                smp = doc.get("samplers", [])[tex["sampler"]]
                wrap = _WRAP_MAP.get(smp.get("wrapS", 10497), WRAP_REPEAT)
            texture_ids[key] = scene.add_texture(pixels, srgb=srgb, wrap=wrap)
        return texture_ids[key]

    # -- materials ----------------------------------------------------------------
    material_ids: list[int] = []
    for mat in doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        m = Material()
        m.base_color_factor = np.array(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
        )
        m.metallic_factor = float(pbr.get("metallicFactor", 1.0))
        m.roughness_factor = float(pbr.get("roughnessFactor", 1.0))
        if "baseColorTexture" in pbr:
            m.base_color_tex = get_texture(pbr["baseColorTexture"]["index"], srgb=True)
        if "metallicRoughnessTexture" in pbr:
            m.mr_tex = get_texture(pbr["metallicRoughnessTexture"]["index"], srgb=False)
        if "normalTexture" in mat:
            m.normal_tex = get_texture(mat["normalTexture"]["index"], srgb=False)
        if "emissiveTexture" in mat:
            m.emissive_tex = get_texture(mat["emissiveTexture"]["index"], srgb=True)
        if "occlusionTexture" in mat:
            m.occlusion_tex = get_texture(mat["occlusionTexture"]["index"], srgb=False)
        strength = (
            mat.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength", 1.0)
        )
        m.emissive_factor = (
            np.array(mat.get("emissiveFactor", [0, 0, 0]), np.float32) * strength
        )
        mode = mat.get("alphaMode", "OPAQUE")
        m.blend_mode = {
            "OPAQUE": BLEND_OPAQUE, "MASK": BLEND_MASKED, "BLEND": BLEND_TRANSLUCENT
        }[mode]
        m.alpha_cutoff = float(mat.get("alphaCutoff", 0.5))
        m.double_sided = bool(mat.get("doubleSided", False))
        material_ids.append(scene.add_material(m))

    # -- KHR_texture_transform ----------------------------------------------------
    # Our bindless shading samples every texture of a material with the
    # segment's single UV set, so the transform is BAKED into the mesh UVs
    # at import (exact for the dominant authoring case — one transform per
    # material; per-texture divergence gets the baseColor transform plus a
    # warning). tiny_gltf exposes the same extension to the reference's
    # GltfLoader.cpp.
    def _tex_transform(info: dict):
        """glTF textureInfo -> (3, 3) UV affine or None (spec: T * R * S)."""
        ext = info.get("extensions", {}).get("KHR_texture_transform")
        if ext is None:
            return None, info.get("texCoord", 0)
        ox, oy = ext.get("offset", [0.0, 0.0])
        sx, sy = ext.get("scale", [1.0, 1.0])
        r = float(ext.get("rotation", 0.0))
        c, s = np.cos(r), np.sin(r)
        m = np.array([
            [c * sx, s * sy, ox],
            [-s * sx, c * sy, oy],
            [0.0, 0.0, 1.0],
        ], np.float32)
        return m, ext.get("texCoord", info.get("texCoord", 0))

    def _material_uv_transform(mat_index: int | None):
        """The material's baked UV transform (and UV set) or (None, 0)."""
        if mat_index is None:
            return None, 0
        mat = doc.get("materials", [])[mat_index]
        infos = []
        pbr = mat.get("pbrMetallicRoughness", {})
        for info in (pbr.get("baseColorTexture"),
                     pbr.get("metallicRoughnessTexture"),
                     mat.get("normalTexture"), mat.get("emissiveTexture"),
                     mat.get("occlusionTexture")):
            if info is not None:
                infos.append(_tex_transform(info))
        if not infos:
            return None, 0
        xforms = [x for x, _ in infos if x is not None]
        if not xforms:
            return None, infos[0][1]
        if any(not np.allclose(x, xforms[0]) for x in xforms[1:]):
            log.warning(
                "material %d: differing KHR_texture_transform per texture; "
                "baking the baseColor transform into the UVs", mat_index,
            )
        return xforms[0], infos[0][1]

    # -- meshes -------------------------------------------------------------------
    mesh_segments: dict[tuple[int, int | None], list[int]] = {}

    def get_mesh_segments(mesh_index: int, skin_si: int | None = None) -> list[int]:
        key = (mesh_index, skin_si)
        if key in mesh_segments:
            return mesh_segments[key]
        ids = []
        for prim in doc["meshes"][mesh_index].get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                log.warning("skipping non-triangle primitive in mesh %d", mesh_index)
                continue
            if "KHR_draco_mesh_compression" in prim.get("extensions", {}):
                raise ValueError(
                    "KHR_draco_mesh_compression is not supported; re-export "
                    "the asset without Draco (e.g. gltf-pipeline -d false)"
                )
            attrs = prim["attributes"]
            positions = read_accessor(g, attrs["POSITION"]).astype(np.float32)
            v = positions.shape[0]
            if "indices" in prim:
                indices = read_accessor(g, prim["indices"]).reshape(-1).astype(np.int32)
            else:
                indices = np.arange(v, dtype=np.int32)
            if "NORMAL" in attrs:
                normals = read_accessor(g, attrs["NORMAL"]).astype(np.float32)
            else:
                normals = _face_normals(positions, indices)
            uv_xform, uv_set = _material_uv_transform(prim.get("material"))
            uv_attr = f"TEXCOORD_{uv_set}" if f"TEXCOORD_{uv_set}" in attrs \
                else "TEXCOORD_0"
            uvs = (
                read_accessor(g, attrs[uv_attr]).astype(np.float32)[:, :2]
                if uv_attr in attrs
                else np.zeros((v, 2), np.float32)
            )
            if uv_xform is not None:
                uvs = uvs @ uv_xform[:2, :2].T + uv_xform[:2, 2][None, :]
            if "TANGENT" in attrs:
                tangents = read_accessor(g, attrs["TANGENT"]).astype(np.float32)
            else:
                tangents = generate_tangents_uv(positions, normals, uvs, indices)
            seg = MeshSegment(
                positions=positions, normals=normals, uvs=uvs,
                tangents=tangents, indices=indices,
                material=(
                    material_ids[prim["material"]] if "material" in prim else 0
                ),
            )
            targets = prim.get("targets", [])
            if targets:
                mp, mn = [], []
                for tgt in targets:
                    mp.append(
                        read_accessor(g, tgt["POSITION"]).astype(np.float32)
                        if "POSITION" in tgt else np.zeros((v, 3), np.float32)
                    )
                    mn.append(
                        read_accessor(g, tgt["NORMAL"]).astype(np.float32)
                        if "NORMAL" in tgt else np.zeros((v, 3), np.float32)
                    )
                seg.morph_pos = np.stack(mp)
                seg.morph_nrm = np.stack(mn)
            if skin_si is not None and "JOINTS_0" in attrs and "WEIGHTS_0" in attrs:
                _, remap = skins[skin_si]
                raw_joints = read_accessor(g, attrs["JOINTS_0"]).astype(np.int64)
                weights = read_accessor(g, attrs["WEIGHTS_0"]).astype(np.float32)
                wsum = weights.sum(-1, keepdims=True)
                weights = np.where(wsum > 1e-6, weights / np.maximum(wsum, 1e-6), weights)
                seg.skin_joints = remap[raw_joints].astype(np.int32)
                seg.skin_weights = weights[:, :4]
                seg.skeleton = skins[skin_si][0]
            ids.append(scene.add_segment(seg))
        mesh_segments[key] = ids
        return ids

    count = 0
    segment_ids_all: list[int] = []
    for mesh_index, world, node_idx in flatten_nodes(g):
        skin_si = doc["nodes"][node_idx].get("skin")
        sids = get_mesh_segments(mesh_index, skin_si)
        segment_ids_all.extend(sids)
        has_targets = any(
            prim.get("targets") for prim in doc["meshes"][mesh_index].get("primitives", [])
        )
        clip = (
            clip_ids[0]
            if ((skin_si is not None or has_targets) and clip_ids and play_animation)
            else None
        )
        # glTF: skinned vertices live in skeleton-root space; the node's own
        # transform does not apply.
        world_eff = root if skin_si is not None else root @ world
        scene.add_instance(sids, world_eff, clip=clip)
        count += len(sids)

    log.info(
        "imported %s: %d instances, %d materials, %d textures",
        Path(path).name, count, len(material_ids), len(texture_ids),
    )
    return GltfImportResult(
        segment_ids=segment_ids_all,
        instance_count=count,
        material_ids=material_ids,
        texture_ids=texture_ids,
    )


def _import_skins(g: GltfFile, scene: Scene) -> dict[int, tuple[int, np.ndarray]]:
    """Import glTF skins -> Skeletons. Returns {skin index: (skeleton id,
    joint remap old->topo order)} (GltfLoader's skeleton import analogue)."""
    from arkoserenderer.scene.animation import Skeleton, topo_sort_joints

    doc = g.doc
    out = {}
    for si, skin in enumerate(doc.get("skins", [])):
        joints = skin["joints"]
        node_to_joint = {n: j for j, n in enumerate(joints)}
        j = len(joints)
        parents = np.full(j, -1, np.int32)
        # Parent = nearest ancestor node that is also a joint of this skin.
        node_parent = {}
        for ni, node in enumerate(doc["nodes"]):
            for c in node.get("children", []):
                node_parent[c] = ni
        for ji, ni in enumerate(joints):
            p = node_parent.get(ni)
            while p is not None and p not in node_to_joint:
                p = node_parent.get(p)
            parents[ji] = node_to_joint[p] if p is not None else -1

        if "inverseBindMatrices" in skin:
            ibm = read_accessor(g, skin["inverseBindMatrices"])
            ibm = ibm.reshape(j, 4, 4).transpose(0, 2, 1)  # column-major file
        else:
            ibm = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))

        rest_t = np.zeros((j, 3), np.float32)
        rest_r = np.tile(np.array([0, 0, 0, 1], np.float32), (j, 1))
        rest_s = np.ones((j, 3), np.float32)
        for ji, ni in enumerate(joints):
            node = doc["nodes"][ni]
            if "matrix" in node:
                m = _node_matrix(node)
                rest_t[ji] = m[:3, 3]
                rest_s[ji] = np.linalg.norm(m[:3, :3], axis=0)
                from arkoserenderer.core.mathx import quat_from_mat3

                rest_r[ji] = quat_from_mat3(m[:3, :3] / rest_s[ji][None, :])
            else:
                rest_t[ji] = node.get("translation", [0, 0, 0])
                rest_r[ji] = node.get("rotation", [0, 0, 0, 1])
                rest_s[ji] = node.get("scale", [1, 1, 1])

        order, remap = topo_sort_joints(parents)
        skel = Skeleton(
            parents=np.where(
                parents[order] >= 0, remap[parents[order]], -1
            ).astype(np.int32),
            inverse_bind=ibm[order].astype(np.float32),
            rest_translation=rest_t[order],
            rest_rotation=rest_r[order],
            rest_scale=rest_s[order],
        )
        out[si] = (scene.add_skeleton(skel), remap)
    return out


def _import_animations(g: GltfFile, scene: Scene, skins: dict) -> list[int]:
    """Import animation clips, remapping node targets to joint indices.

    Only joint-targeting channels are imported for now (rigid node animation
    TODO); morph-weight channels use path="weights"."""
    from arkoserenderer.scene.animation import (
        INTERP_CUBICSPLINE,
        INTERP_LINEAR,
        INTERP_STEP,
        AnimationClip,
        AnimChannel,
    )

    doc = g.doc
    interp_map = {
        "STEP": INTERP_STEP, "LINEAR": INTERP_LINEAR, "CUBICSPLINE": INTERP_CUBICSPLINE,
    }
    # node id -> (skin index, joint index) over all skins
    node_joint = {}
    for si, skin in enumerate(doc.get("skins", [])):
        _, remap = skins[si]
        for ji, ni in enumerate(skin["joints"]):
            node_joint[ni] = (si, int(remap[ji]))

    clip_ids = []
    for anim in doc.get("animations", []):
        channels = []
        for ch in anim.get("channels", []):
            target = ch["target"]
            path = target["path"]
            node = target.get("node")
            if path != "weights" and node not in node_joint:
                continue
            smp = anim["samplers"][ch["sampler"]]
            times = read_accessor(g, smp["input"]).reshape(-1).astype(np.float32)
            values = read_accessor(g, smp["output"]).astype(np.float32)
            if path == "weights":
                # Scalar accessor packs keyframes x morph-target count.
                values = values.reshape(len(times), -1)
            joint = node_joint[node][1] if path != "weights" else -1
            channels.append(
                AnimChannel(
                    target_joint=joint,
                    path=path,
                    times=times,
                    values=values,
                    interpolation=interp_map.get(smp.get("interpolation", "LINEAR"), INTERP_LINEAR),
                )
            )
        if channels:
            clip_ids.append(
                scene.add_animation(AnimationClip(channels=channels, name=anim.get("name", "")))
            )
    return clip_ids


def _face_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    tri = indices.reshape(-1, 3)
    e1 = positions[tri[:, 1]] - positions[tri[:, 0]]
    e2 = positions[tri[:, 2]] - positions[tri[:, 0]]
    fn = np.cross(e1, e2)
    acc = np.zeros_like(positions)
    for k in range(3):
        np.add.at(acc, tri[:, k], fn)
    n = np.linalg.norm(acc, axis=-1, keepdims=True)
    return (acc / np.maximum(n, 1e-12)).astype(np.float32)
