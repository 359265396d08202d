"""Procedural geometry + test scenes.

Role-equivalent to the reference's engine test assets
(assets/assets/engine/test/, loaded by ShowcaseApp as living regression
scenes): self-contained scenes used by unit tests, golden-image tests, and
benchmarks without any external asset files.
"""

from __future__ import annotations

import numpy as np

from arkoserenderer.core.types import SceneLimits
from arkoserenderer.scene.camera import Camera
from arkoserenderer.scene.lights import DirectionalLight, SpotLight
from arkoserenderer.scene.scene import Material, MeshSegment, Scene
from arkoserenderer.scene.scene import generate_tangents_uv


def make_plane(size: float = 1.0, uv_scale: float = 1.0) -> MeshSegment:
    """XZ plane centered at origin, +Y normal, CCW winding seen from above."""
    s = size * 0.5
    positions = np.array(
        [[-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]], np.float32
    )
    normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uvs = np.array([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32) * uv_scale
    indices = np.array([0, 1, 2, 0, 2, 3], np.int32)
    tangents = generate_tangents_uv(positions, normals, uvs, indices)
    return MeshSegment(positions, normals, uvs, tangents, indices)


def make_box(extents=(1.0, 1.0, 1.0)) -> MeshSegment:
    """Axis-aligned box with per-face normals/uvs, CCW outward winding."""
    ex, ey, ez = [e * 0.5 for e in extents]
    faces = []
    # (normal, up, right) per face
    axes = [
        ((0, 0, 1), (0, 1, 0), (1, 0, 0)),
        ((0, 0, -1), (0, 1, 0), (-1, 0, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, -1)),
        ((-1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((0, 1, 0), (0, 0, -1), (1, 0, 0)),
        ((0, -1, 0), (0, 0, 1), (1, 0, 0)),
    ]
    half = np.array([ex, ey, ez], np.float32)
    positions, normals, uvs, indices = [], [], [], []
    for i, (n, u, r) in enumerate(axes):
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        r = np.array(r, np.float32)
        c = n * half
        ru = r * half
        uu = u * half
        quad = [c - ru - uu, c + ru - uu, c + ru + uu, c - ru + uu]
        positions.extend(quad)
        normals.extend([n] * 4)
        uvs.extend([[0, 1], [1, 1], [1, 0], [0, 0]])
        b = 4 * i
        indices.extend([b, b + 1, b + 2, b, b + 2, b + 3])
    positions = np.array(positions, np.float32)
    normals = np.array(normals, np.float32)
    uvs = np.array(uvs, np.float32)
    indices = np.array(indices, np.int32)
    tangents = generate_tangents_uv(positions, normals, uvs, indices)
    return MeshSegment(positions, normals, uvs, tangents, indices)


def make_uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> MeshSegment:
    ring = np.linspace(0, np.pi, rings + 1)
    sect = np.linspace(0, 2 * np.pi, sectors + 1)
    rr, ss = np.meshgrid(ring, sect, indexing="ij")
    x = np.sin(rr) * np.cos(ss)
    y = np.cos(rr)
    z = np.sin(rr) * np.sin(ss)
    positions = (radius * np.stack([x, y, z], -1)).reshape(-1, 3).astype(np.float32)
    normals = (positions / radius).astype(np.float32)
    uvs = np.stack([ss / (2 * np.pi), rr / np.pi], -1).reshape(-1, 2).astype(np.float32)
    idx = []
    stride = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * stride + s
            b = a + stride
            idx.extend([a, a + 1, b, b, a + 1, b + 1])
    indices = np.array(idx, np.int32)
    tangents = generate_tangents_uv(positions, normals, uvs, indices)
    return MeshSegment(positions, normals, uvs, tangents, indices)


def checkerboard_texture(size: int = 64, squares: int = 8, c0=200, c1=60) -> np.ndarray:
    img = np.zeros((size, size, 4), np.uint8)
    q = size // squares
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy // q) + (xx // q)) % 2 == 0
    img[..., :3] = np.where(mask[..., None], c0, c1)
    img[..., 3] = 255
    return img


def gradient_env_map(height: int = 64, zenith=(0.35, 0.55, 0.9), horizon=(0.8, 0.85, 0.95), ground=(0.25, 0.22, 0.2)) -> np.ndarray:
    """Simple sky gradient equirect env map (linear radiance, unit scale)."""
    width = height * 2
    v = np.linspace(0.0, 1.0, height)[:, None, None]  # 0 = up
    zen = np.array(zenith, np.float32)
    hor = np.array(horizon, np.float32)
    gnd = np.array(ground, np.float32)
    sky = zen + (hor - zen) * np.clip(v * 2, 0, 1) ** 1.5
    below = hor + (gnd - hor) * np.clip(v * 2 - 1, 0, 1) ** 0.5
    img = np.where(v < 0.5, sky, below)
    return np.broadcast_to(img, (height, width, 3)).astype(np.float32)


def build_test_scene(
    limits: SceneLimits | None = None,
    viewport: tuple[int, int] = (256, 256),
    n_spheres: int = 3,
) -> tuple[Scene, Camera]:
    """The standard small test scene: checkered floor, a few spheres of
    varying roughness/metalness, one textured box, sunlight + sky."""
    lim = limits or SceneLimits(
        max_vertices=1 << 15, max_indices=3 << 15, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 19,
    )
    scene = Scene(limits=lim)

    checker = scene.add_texture(checkerboard_texture(128, 16), srgb=True)
    floor_mat = scene.add_material(
        Material(base_color_tex=checker, roughness_factor=0.8)
    )
    floor = make_plane(size=20.0, uv_scale=10.0)
    floor.material = floor_mat
    fid = scene.add_segment(floor)
    scene.add_instance(fid, np.eye(4, dtype=np.float32))

    for i in range(n_spheres):
        f = i / max(n_spheres - 1, 1)
        mat = scene.add_material(
            Material(
                base_color_factor=np.array([0.8, 0.3 + 0.5 * f, 0.25, 1.0], np.float32),
                roughness_factor=0.15 + 0.7 * f,
                metallic_factor=1.0 if i % 2 else 0.0,
            )
        )
        seg = make_uv_sphere(0.6, rings=12, sectors=24)
        seg.material = mat
        sid = scene.add_segment(seg)
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (-2.0 + 2.0 * i, 0.6, 0.0)
        scene.add_instance(sid, w)

    box_mat = scene.add_material(
        Material(base_color_factor=np.array([0.3, 0.45, 0.8, 1.0], np.float32), roughness_factor=0.4)
    )
    box = make_box((1.0, 1.4, 1.0))
    box.material = box_mat
    bid = scene.add_segment(box)
    wb = np.eye(4, dtype=np.float32)
    wb[:3, 3] = (0.0, 0.7, -2.2)
    scene.add_instance(bid, wb)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0

    cam = Camera(viewport=viewport)
    cam.look_at((4.0, 2.5, 5.0), (0.0, 0.6, -0.5))
    cam.focus_depth = 6.0
    return scene, cam


def build_stress_scene(
    n_instances: int = 4096,
    viewport: tuple[int, int] = (256, 256),
    limits: SceneLimits | None = None,
) -> tuple[Scene, Camera]:
    """Culling stress scene: a grid of N animated instances of ONE shared
    segment — the analogue of ShowcaseApp's 4,096-helmet stress scene
    (arkose/application/apps/ShowcaseApp.cpp:381-412), built to exercise
    per-instance frustum/LOD culling, the instanced TLAS (one BLAS + N
    TLAS leaves, ops/bvh.TwoLevelBVH), and per-frame transform streaming
    (Scene.update_instance_transforms with Renderer(dynamic_transforms=
    True) — call ``animate_stress_scene(scene, t)`` each frame).
    """
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 2.0
    extent = side * spacing
    lim = limits or SceneLimits(
        max_vertices=max(1 << 15, 160 * n_instances + 4096),
        max_indices=max(3 << 15, 3 * (240 * n_instances + 4096)),
        max_drawables=max(64, 2 * n_instances + 8),
        max_materials=32, max_textures=32, texture_pool_texels=1 << 19,
    )
    scene = Scene(limits=lim)

    checker = scene.add_texture(checkerboard_texture(64, 8), srgb=True)
    floor_mat = scene.add_material(
        Material(base_color_tex=checker, roughness_factor=0.85)
    )
    floor = make_plane(size=extent * 1.2, uv_scale=extent / 4)
    floor.material = floor_mat
    fid = scene.add_segment(floor)
    scene.add_instance(fid, np.eye(4, dtype=np.float32))

    body_mat = scene.add_material(Material(
        base_color_factor=np.array([0.75, 0.33, 0.21, 1.0], np.float32),
        roughness_factor=0.35, metallic_factor=1.0,
    ))
    body = make_uv_sphere(0.55, rings=8, sectors=12)   # ~100 verts / ~176 tris
    body.material = body_mat
    sid = scene.add_segment(body)
    # Far LOD: the reference's stress helmets carry mesh LODs (MeshAsset
    # LODs); distant grid cells render a 48-tri sphere via the in-jit
    # distance-band selection.
    body_far = make_uv_sphere(0.55, rings=4, sectors=6)
    body_far.material = body_mat
    sid_far = scene.add_segment(body_far)
    lod_switch = 14.0 * spacing / 2.0

    rng = np.random.default_rng(1234)
    phases = rng.uniform(0, 2 * np.pi, n_instances).astype(np.float32)
    for i in range(n_instances):
        gx, gz = i % side, i // side
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (
            (gx - side / 2 + 0.5) * spacing,
            0.8,
            (gz - side / 2 + 0.5) * spacing,
        )
        scene.add_instance_lods([sid, sid_far], w, distances=[lod_switch])
    scene._stress = ((sid, sid_far), side, spacing, phases)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0

    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.08, 4.0, extent * 0.12), (0.0, 0.5, 0.0))
    return scene, cam


def animate_stress_scene(scene: Scene, t: float) -> None:
    """Per-frame host animation of the stress grid (bobbing + spin), like
    the reference's animated helmets; follow with
    ``renderer.scene_arrays = scene.update_instance_transforms(...)`` or
    construct the Renderer with ``dynamic_transforms=True``.

    Vectorized: all N instances' matrices come from batched numpy trig (one
    pass), not N python iterations — at 4,096 instances the loop itself was
    frame-time-relevant (the host half of ParallelForBatched)."""
    sids, side, spacing, phases = scene._stress
    if not isinstance(sids, tuple):
        sids = (sids,)
    idxs = [i for i, it in enumerate(scene.instances) if it[0] in sids]
    n = len(idxs)
    # LOD chains share the grid cell's phase: instances come in per-cell
    # groups of len(sids).
    ph = phases[(np.arange(n) // max(len(sids), 1)) % len(phases)]
    c = np.cos(t + ph)
    s = np.sin(t + ph)
    bob = 0.8 + 0.35 * np.sin(2.0 * t + ph)
    old_ws = [scene.instances[i][1] for i in idxs]
    W = np.stack(old_ws).astype(np.float32)
    W[:, 0, 0] = c
    W[:, 0, 2] = s
    W[:, 2, 0] = -s
    W[:, 2, 2] = c
    W[:, 1, 3] = bob
    for k, i in enumerate(idxs):
        seg, w, pw, clip, band = scene.instances[i]
        scene.instances[i] = (seg, W[k], w, clip, band)


def make_stress_animator(scene: Scene):
    """Device-side rigid animation for the stress grid — the traced
    ``scene_animator`` counterpart of :func:`animate_stress_scene`.

    The reference ticks its 4,096 animated helmets on the CPU each frame
    (ShowcaseApp.cpp:381-412 + GpuScene's drawable re-upload). Here the
    animation is a closed-form function of time evaluated INSIDE the jitted
    frame, with no per-frame host math or pool upload: spin
    about Y + vertical bob per grid cell, writing world/prev_world/
    normal_mat/inst_sphere rows on device. All captured parameters are
    numpy (HLO literals — see rendering/pipeline.pixel_centers for why
    device-array closures are forbidden).
    """
    import jax
    import jax.numpy as jnp

    sids, side, spacing, phases = scene._stress
    if not isinstance(sids, tuple):
        sids = (sids,)
    idxs = [i for i, it in enumerate(scene.instances) if it[0] in sids]
    n = len(idxs)
    base = int(idxs[0])
    assert idxs == list(range(base, base + n)), "animated instances contiguous"
    ph = phases[(np.arange(n) // max(len(sids), 1)) % len(phases)].astype(np.float32)
    W0 = np.stack(
        [np.asarray(scene.instances[i][1], np.float32) for i in idxs]
    )
    tx = W0[:, 0, 3].copy()
    tz = W0[:, 2, 3].copy()
    # Object-space bounding radius per animated instance (unit rotation, no
    # scale): reuse the per-segment bounds the host update path caches.
    radii = np.zeros((n,), np.float32)
    for k, i in enumerate(idxs):
        seg = scene.segments[scene.instances[i][0]]
        c = 0.5 * (seg.positions.min(0) + seg.positions.max(0))
        radii[k] = float(np.linalg.norm(seg.positions - c, axis=-1).max())

    def rows_at(t):
        a = t + ph
        c, s = jnp.cos(a), jnp.sin(a)
        bob = 0.8 + 0.35 * jnp.sin(2.0 * t + ph)
        zero = jnp.zeros_like(c)
        one = jnp.ones_like(c)
        w = jnp.stack(
            [
                jnp.stack([c, zero, s, tx], -1),
                jnp.stack([zero, one, zero, bob], -1),
                jnp.stack([-s, zero, c, tz], -1),
                jnp.stack([zero, zero, zero, one], -1),
            ],
            axis=1,
        )  # (n, 4, 4)
        return w, bob, c, s

    def animate(arrays, frame_index, delta_time):
        t = frame_index.astype(jnp.float32) * delta_time
        w, bob, c, s = rows_at(t)
        pw, _, _, _ = rows_at(t - delta_time)
        zero = jnp.zeros_like(c)
        one = jnp.ones_like(c)
        nm = jnp.stack(
            [
                jnp.stack([c, zero, s], -1),
                jnp.stack([zero, one, zero], -1),
                jnp.stack([-s, zero, c], -1),
            ],
            axis=1,
        )  # pure rotation: inverse-transpose == itself
        sph = jnp.stack([tx, bob, tz, radii], -1)
        upd = lambda pool, rows: jax.lax.dynamic_update_slice_in_dim(
            pool, rows.astype(pool.dtype), base, axis=0
        )
        return arrays._replace(
            world=upd(arrays.world, w),
            prev_world=upd(arrays.prev_world, pw),
            normal_mat=upd(arrays.normal_mat, nm),
            inst_sphere=upd(arrays.inst_sphere, sph),
        )

    return animate


def _variety_textures(scene: Scene, n_textures: int, rng) -> tuple:
    """n_textures distinct base-color chains (checker/stripes/rings with
    per-texture scale/hue) + MR and emissive chains for every third one.
    Returns (tex_ids, mr_tex_ids, emi_tex_ids)."""
    tex_ids = []
    mr_tex_ids = []
    emi_tex_ids = []
    for i in range(n_textures):
        size = 64
        sq = int(rng.integers(2, 16))
        hue = rng.random(3) * 0.8 + 0.2
        c0 = (hue * 220).astype(np.uint8)
        c1 = (hue * 70).astype(np.uint8)
        img = np.zeros((size, size, 4), np.uint8)
        q = max(size // sq, 1)
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        if i % 3 == 1:   # diagonal stripes
            mask = ((yy + xx) // q) % 2 == 0
        elif i % 3 == 2:  # rings
            r = np.sqrt((yy - size / 2) ** 2 + (xx - size / 2) ** 2)
            mask = (r // q) % 2 == 0
        else:            # checker
            mask = ((yy // q) + (xx // q)) % 2 == 0
        img[..., :3] = np.where(mask[..., None], c0, c1)
        img[..., 3] = 255
        tex_ids.append(scene.add_texture(img, srgb=True))
        if i % 3 == 0:
            mr = np.zeros((32, 32, 4), np.uint8)
            mr[..., 1] = (rng.random((32, 32)) * 255).astype(np.uint8)  # rough
            mr[..., 2] = 255 if i % 6 == 0 else 0                       # metal
            mr[..., 3] = 255
            mr_tex_ids.append(scene.add_texture(mr, srgb=False))
            em = np.zeros((16, 16, 4), np.uint8)
            em[..., :3] = (hue * 255 * (((yy[:16, :16] // 4) % 2) == 0)[..., None]).astype(np.uint8)
            em[..., 3] = 255
            emi_tex_ids.append(scene.add_texture(em, srgb=True))
    return tex_ids, mr_tex_ids, emi_tex_ids


def build_flagship_scene(
    n_instances: int = 4096,
    n_materials: int = 256,
    n_textures: int = 64,
    viewport: tuple[int, int] = (1920, 1080),
) -> tuple[Scene, Camera]:
    """Representative-scale benchmark scene — the Sponza/asset-zoo slot of
    the reference showcase (arkose/application/apps/ShowcaseApp.cpp:86-227):
    ``n_instances`` sphere instances over ``n_materials`` distinct materials
    cycling ``n_textures`` texture chains (the reference's bindless operating
    point in miniature, GpuScene.h:259-282), on a textured floor, lit by the
    sun plus two SHADOW-CASTING spots and a point light. At the 4,096 / 256 /
    64 defaults: ~786K triangles (192 per sphere), ~480K pooled vertices.
    """
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 2.0
    extent = side * spacing
    proto = make_uv_sphere(0.55, rings=8, sectors=12)
    vpp = proto.positions.shape[0]
    tpp = proto.indices.shape[0]
    lim = SceneLimits(
        max_vertices=vpp * n_instances + 8192,
        max_indices=tpp * n_instances + 32768,
        max_drawables=n_instances + 8,
        max_materials=n_materials + 8,
        max_textures=3 * n_textures + 8,
        texture_pool_texels=1 << 22,
    )
    scene = Scene(limits=lim)
    rng = np.random.default_rng(7)
    tex_ids, mr_tex_ids, emi_tex_ids = _variety_textures(scene, n_textures, rng)

    floor_mat = scene.add_material(
        Material(base_color_tex=tex_ids[0], roughness_factor=0.9)
    )
    floor = make_plane(size=extent * 1.2, uv_scale=extent / 2)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    seg_ids = []
    for i in range(n_materials):
        m = Material(
            base_color_factor=np.array(
                [*(0.4 + 0.6 * rng.random(3)), 1.0], np.float32
            ),
            roughness_factor=float(0.15 + 0.8 * rng.random()),
            metallic_factor=float(rng.random() < 0.3),
            base_color_tex=tex_ids[i % n_textures],
        )
        if i % 3 == 0 and mr_tex_ids:
            m.mr_tex = mr_tex_ids[(i // 3) % len(mr_tex_ids)]
            m.emissive_tex = emi_tex_ids[(i // 3) % len(emi_tex_ids)]
            m.emissive_factor = np.full(3, 2000.0, np.float32)
        mid = scene.add_material(m)
        seg = MeshSegment(
            positions=proto.positions, normals=proto.normals,
            uvs=proto.uvs, indices=proto.indices, material=mid,
            tangents=proto.tangents,
        )
        seg_ids.append(scene.add_segment(seg))

    for i in range(n_instances):
        gx, gz = i % side, i // side
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (
            (gx - side / 2 + 0.5) * spacing,
            0.6 + 0.5 * ((gx * 7 + gz * 3) % 5) / 4.0,
            (gz - side / 2 + 0.5) * spacing,
        )
        scene.add_instance(seg_ids[i % n_materials], w)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    from arkoserenderer.scene.lights import PointLight

    scene.spots.append(SpotLight(
        position=np.array([0.0, 10.0, 0.0], np.float32),
        direction=np.array([0.2, -1.0, 0.1], np.float32),
        luminous_intensity_cd=300000.0,
        outer_cone_angle=np.radians(45.0), inner_cone_angle=np.radians(30.0),
        cast_shadows=True,
    ))
    scene.spots.append(SpotLight(
        position=np.array([-extent * 0.2, 8.0, extent * 0.2], np.float32),
        direction=np.array([0.3, -1.0, -0.3], np.float32),
        luminous_intensity_cd=200000.0,
        outer_cone_angle=np.radians(40.0), inner_cone_angle=np.radians(25.0),
        cast_shadows=True,
    ))
    scene.points.append(PointLight(
        position=np.array([extent * 0.15, 4.0, -extent * 0.1], np.float32),
        luminous_intensity_cd=80000.0,
    ))
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0
    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.18, 7.0, extent * 0.26), (0.0, 0.5, 0.0))
    cam.focus_depth = extent * 0.25
    return scene, cam


def build_bindless_scene(
    n_materials: int = 256,
    n_textures: int = 64,
    viewport: tuple[int, int] = (256, 256),
) -> tuple[Scene, Camera]:
    """Bindless-pressure scene: a grid of spheres where EVERY instance has
    its own material and materials cycle through ``n_textures`` distinct
    texture chains — the honest test of the packed-record +
    channel-packed-texture design (ops/packed_shading + ops/mattex) under
    real material/texture divergence, against the reference's operating
    point of 10,000 materials / 4,096 bindless textures
    (arkose/rendering/GpuScene.h:259-282).

    Texture variety: per-texture checkerboard scale, hue, and rotation so
    neighboring pixels routinely fetch from different chains; a third of
    the materials also bind a metallic-roughness texture and an emissive
    texture (distinct per material id).
    """
    side = int(np.ceil(np.sqrt(n_materials)))
    spacing = 1.6
    extent = side * spacing
    lim = SceneLimits(
        max_vertices=max(1 << 16, 160 * n_materials + 8192),
        max_indices=max(3 << 16, 3 * (240 * n_materials + 8192)),
        max_drawables=max(64, n_materials + 8),
        max_materials=max(64, n_materials + 8),
        max_textures=max(64, 3 * n_textures + 8),
        texture_pool_texels=1 << 22,
    )
    scene = Scene(limits=lim)

    rng = np.random.default_rng(99)
    tex_ids, mr_tex_ids, emi_tex_ids = _variety_textures(scene, n_textures, rng)

    floor_mat = scene.add_material(
        Material(base_color_tex=tex_ids[0], roughness_factor=0.9)
    )
    floor = make_plane(size=extent * 1.2, uv_scale=extent / 2)
    floor.material = floor_mat
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))

    proto = make_uv_sphere(0.55, rings=8, sectors=12)
    for i in range(n_materials):
        m = Material(
            base_color_factor=np.array(
                [*(0.4 + 0.6 * rng.random(3)), 1.0], np.float32
            ),
            roughness_factor=float(0.15 + 0.8 * rng.random()),
            metallic_factor=float(rng.random() < 0.3),
            base_color_tex=tex_ids[i % n_textures],
        )
        if i % 3 == 0 and mr_tex_ids:
            m.mr_tex = mr_tex_ids[(i // 3) % len(mr_tex_ids)]
            m.emissive_tex = emi_tex_ids[(i // 3) % len(emi_tex_ids)]
            m.emissive_factor = np.full(3, 2000.0, np.float32)
        mid = scene.add_material(m)
        seg = MeshSegment(
            positions=proto.positions, normals=proto.normals,
            uvs=proto.uvs, indices=proto.indices, material=mid,
            tangents=proto.tangents,
        )
        sid = scene.add_segment(seg)
        gx, gz = i % side, i // side
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (
            (gx - side / 2 + 0.5) * spacing, 0.75,
            (gz - side / 2 + 0.5) * spacing,
        )
        scene.add_instance(sid, w)

    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0,
    )
    scene.set_env_map(gradient_env_map(32), brightness=8000.0)
    scene.ambient_lx = 6000.0
    cam = Camera(viewport=viewport)
    cam.look_at((extent * 0.10, 5.0, extent * 0.16), (0.0, 0.4, 0.0))
    return scene, cam


def build_flat_test_scene(
    viewport: tuple[int, int] = (128, 128),
) -> tuple[Scene, Camera]:
    """Untextured analytic-materials scene for the pixel-level truth harness
    (tests/test_truth.py): sun-only, zero environment, all-diffuse materials.
    With these settings the path tracer's first-bounce NEE is exactly the
    raster pipeline's direct term, so the two renderers must agree PER PIXEL
    — the comparison that actually catches a broken BRDF/shadow/exposure
    term (the role PathTracerNode plays as ground truth in the reference,
    arkose/rendering/pathtracer/PathTracerNode.cpp:27-104)."""
    lim = SceneLimits(
        max_vertices=1 << 15, max_indices=3 << 15, max_drawables=64,
        max_materials=32, max_textures=32, texture_pool_texels=1 << 16,
    )
    scene = Scene(limits=lim)
    floor = make_plane(size=20.0)
    floor.material = scene.add_material(Material(
        base_color_factor=np.array([0.5, 0.5, 0.5, 1.0], np.float32),
        roughness_factor=0.8))
    scene.add_instance(scene.add_segment(floor), np.eye(4, dtype=np.float32))
    for i, rough in enumerate((0.2, 0.5, 0.9)):
        seg = make_uv_sphere(0.6, rings=24, sectors=48)
        seg.material = scene.add_material(Material(
            base_color_factor=np.array([0.8, 0.4, 0.3, 1.0], np.float32),
            roughness_factor=rough, metallic_factor=0.0))
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (-2.0 + 2.0 * i, 0.6, 0.0)
        scene.add_instance(scene.add_segment(seg), w)
    box = make_box((1.0, 1.4, 1.0))
    box.material = scene.add_material(Material(
        base_color_factor=np.array([0.3, 0.45, 0.8, 1.0], np.float32),
        roughness_factor=0.4))
    wb = np.eye(4, dtype=np.float32)
    wb[:3, 3] = (0.0, 0.7, -2.2)
    scene.add_instance(scene.add_segment(box), wb)
    # Clearcoat sphere: the Kelemen lobe must agree between raster and PT.
    cc = make_uv_sphere(0.5, rings=24, sectors=48)
    cc.material = scene.add_material(Material(
        base_color_factor=np.array([0.55, 0.1, 0.1, 1.0], np.float32),
        roughness_factor=0.6, clearcoat=1.0, clearcoat_roughness=0.15))
    wc = np.eye(4, dtype=np.float32)
    wc[:3, 3] = (2.1, 0.5, 1.8)
    scene.add_instance(scene.add_segment(cc), wc)
    scene.sun = DirectionalLight(
        direction=np.array([0.4, -1.0, -0.3], np.float32),
        illuminance_lux=90000.0)
    scene.env_map = np.zeros((1, 2, 3), np.float32)
    scene.env_brightness = 0.0
    scene.ambient_lx = 0.0
    cam = Camera(viewport=viewport)
    cam.look_at((4.0, 2.5, 5.0), (0.0, 0.6, -0.5))
    return scene, cam
