"""RT shadows, RT reflections, and DDGI in the raster pipeline
(BASELINE configs #4 and #5 feature sets)."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

W = H = 96
CFG = PipelineConfig(
    width=W, height=H,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def test_rt_shadows_match_mapped_shadows_roughly():
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    r_rt = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False)
    img_rt = np.asarray(r_rt.render_frame())
    mask = np.asarray(r_rt.state["ShadowMask.sun"])
    vis = np.asarray(r_rt.state["Visibility"])
    covered = vis >= 0
    assert mask[covered].min() == 0.0  # something is in shadow
    assert mask[covered].max() == 1.0  # something is lit

    scene2, cam2 = build_test_scene(viewport=(W, H), n_spheres=1)
    r_map = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    img_map = np.asarray(r_map.render_frame())
    # The two shadow techniques must produce broadly similar images.
    assert np.abs(img_rt - img_map).mean() < 0.06


def test_rt_reflections_on_mirror_sphere():
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    # Make the floor mirror-like to see reflections.
    scene.materials[1].roughness_factor = 0.05
    scene.materials[1].metallic_factor = 1.0
    r = Renderer(scene, cam, CFG, rt_reflections=True, taa=False, bloom=False)
    img = np.array(r.render_frame())
    refl = np.asarray(r.state["SceneReflections"])
    assert np.isfinite(refl).all()
    assert refl.max() > 0.01  # reflections actually contribute
    assert np.isfinite(img).all()


def test_ddgi_probe_update_and_sampling():
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    r = Renderer(scene, cam, CFG, ddgi=True, taa=False, bloom=False)
    img1 = np.array(r.render_frame())
    irr1 = np.asarray(r.state["DDGI.irradiance"])
    for _ in range(4):
        img = np.array(r.render_frame())
    irr2 = np.asarray(r.state["DDGI.irradiance"])
    assert np.isfinite(irr2).all()
    assert irr2.max() > 0.0            # probes received light
    assert (irr2 != irr1).any()        # round-robin updates progress
    assert np.isfinite(img).all()
    assert 0.02 < img.mean() < 0.98


def test_ddgi_grid_fit():
    from arkoserenderer.ops.ddgi import ProbeGridConfig, probe_positions

    cfg = ProbeGridConfig.fit_bounds(np.array([1.0, 2.0, 3.0]), 5.0)
    pos = probe_positions(cfg)
    assert pos.shape == (cfg.num_probes, 3)
    # Probes enclose the bounds.
    assert pos.min(0).max() <= 1.0 + 5.0
    assert pos.max(0).min() >= -5.0


def test_octahedral_roundtrip(rng):
    import jax.numpy as jnp

    from arkoserenderer.ops.ddgi import octahedral_decode, octahedral_encode

    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    uv = octahedral_encode(jnp.asarray(d))
    back = np.asarray(octahedral_decode(uv))
    np.testing.assert_allclose(back, d, atol=1e-5)
    assert float(jnp.min(uv)) >= 0.0 and float(jnp.max(uv)) <= 1.0


@pytest.mark.heavy  # multi-frame convergence: nightly lane
def test_ddgi_probe_debug_overlay():
    from arkoserenderer.ops.ddgi import ProbeGridConfig
    from arkoserenderer.rendering.passes.ddgi_debug import DDGIProbeDebugPass

    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    center, radius = scene.bounding_sphere()
    grid = ProbeGridConfig.fit_bounds(center, radius, dims=(4, 2, 4))
    r = Renderer(scene, cam, CFG, ddgi=grid, taa=False, bloom=False)
    r.pipeline.passes.append(DDGIProbeDebugPass(grid, xray=True))
    r.pipeline.construct_all()
    r.state = r.pipeline.initial_state()
    img_dbg = np.array(r.render_frames(2))
    assert np.isfinite(img_dbg).all()
    # Re-render without the debug pass: the overlay changed some pixels.
    scene2, cam2 = build_test_scene(viewport=(W, H), n_spheres=1)
    r2 = Renderer(scene2, cam2, CFG, ddgi=grid, taa=False, bloom=False)
    img = np.array(r2.render_frames(2))
    assert np.abs(img_dbg - img).max() > 0.02


@pytest.mark.heavy
def test_rt_shadows_track_morphing_geometry_via_refit():
    """A morph target inflates the sphere; with per-frame BVH refit (enabled
    automatically for morphing scenes) the RT shadow footprint must grow.
    With refit forced OFF the occluder stays the build-time BVH, so the
    footprint barely moves (receiver positions still morph via the raster
    depth, so tiny drift is expected) — the growth must come from refit."""

    def shadow_px(rt_refit):
        scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
        seg = scene.segments[1]
        seg.morph_pos = seg.normals[None] * 0.6
        seg.morph_nrm = np.zeros((1, len(seg.normals), 3), np.float32)
        kw = {} if rt_refit is None else {"rt_refit": rt_refit}
        r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False, **kw)
        scene.set_morph_weights(np.array([0.0], np.float32))
        r.render_frame()
        px0 = int((np.asarray(r.state["ShadowMask.sun"]) < 0.5).sum())
        scene.set_morph_weights(np.array([1.0], np.float32))
        r.render_frame()
        px1 = int((np.asarray(r.state["ShadowMask.sun"]) < 0.5).sum())
        return px0, px1

    px0, px1 = shadow_px(None)  # auto: morphing scene -> refit on
    assert px0 > 0
    assert px1 > px0 * 1.3  # inflated sphere casts a bigger shadow

    s0, s1 = shadow_px(False)  # static build-time BVH: occluder frozen
    assert (px1 - px0) > 3 * abs(s1 - s0)


@pytest.mark.heavy
def test_rt_reflections_temporal_accumulation_converges():
    """The FFX-style temporal stage: with a static camera, the resolved
    output is temporally more stable than the raw per-frame reflections
    (the raster stays Halton-jittered, so the raw signal flickers), and the
    sample-count state accumulates."""
    from arkoserenderer.rendering.passes.rt import RTReflectionsPass

    def run(temporal):
        scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
        scene.materials[1].roughness_factor = 0.05
        scene.materials[1].metallic_factor = 1.0
        r = Renderer(scene, cam, CFG, rt_reflections=True, taa=False, bloom=False)
        if not temporal:
            for i, p in enumerate(r.pipeline.passes):
                if isinstance(p, RTReflectionsPass):
                    r.pipeline.passes[i] = RTReflectionsPass(temporal=False)
            r.pipeline.construct_all()
            r.state = r.pipeline.initial_state()
        frames = []
        for _ in range(8):
            r.render_frame()
            frames.append(np.array(np.asarray(r.state["SceneReflections"])))
        deltas = [np.abs(b - a).mean() for a, b in zip(frames, frames[1:])]
        return frames, deltas, r

    frames, dn_deltas, r = run(True)
    _, raw_deltas, _ = run(False)
    assert np.isfinite(frames[-1]).all()
    assert "RTRefl.history" in r.state
    assert "RTRefl.moments" in r.state  # FFX-style variance/sample-count state
    # Damping: resolved output flickers strictly less than the raw signal,
    # every frame, and by a solid margin on average.
    assert all(d <= rr + 1e-6 for d, rr in zip(dn_deltas, raw_deltas))
    assert np.mean(dn_deltas) < 0.75 * np.mean(raw_deltas)
    # Sample count accumulates toward the max (fresh pixels converge fast).
    n = np.asarray(r.state["RTRefl.moments"])[..., 2]
    assert n.max() >= 7.0


@pytest.mark.heavy
def test_mirror_reflections_match_path_tracer_energy():
    """VERDICT round-2 criterion: reflection energy vs the path-traced
    reference under a TIGHT tolerance (round 1 was 3x). Mirror pixels carry
    one Fresnel-weighted bounce with honest hit shading (textures + sun BRDF
    + shadow + SH ambient); the remaining deficit vs the converged path
    tracer is recursive self-reflection (single-bounce limitation, same as
    the reference's RTReflectionsNode)."""
    from arkoserenderer.models.pathtracer import PathTracer

    def mk():
        s, c = build_test_scene(viewport=(W, H), n_spheres=1)
        s.materials[2].roughness_factor = 0.03
        s.materials[2].metallic_factor = 1.0
        s.materials[2].base_color_factor = np.array([1, 1, 1, 1], np.float32)
        return s, c

    s1, c1 = mk()
    r = Renderer(s1, c1, CFG, rt_reflections=True, taa=False, bloom=False)
    for _ in range(8):
        r.render_frame()
    color = np.array(np.asarray(r.state["SceneColor"]))
    mat = np.asarray(r.state["SceneMaterial"])
    vis = np.asarray(r.state["SceneCoverage"])
    mirror = (mat[..., 0] < 0.25) & (mat[..., 1] > 0.5) & (vis > 0)
    assert mirror.sum() > 50

    s2, c2 = mk()
    tr = PathTracer(s2, c2, W, H, max_bounces=4)
    tr.render_sample(48)
    pt = np.array(np.asarray(tr.radiance()))

    mirror_ratio = color[mirror].mean() / pt[mirror].mean()
    diffuse_ratio = color[(~mirror) & (vis > 0)].mean() / pt[(~mirror) & (vis > 0)].mean()
    assert 0.70 < mirror_ratio < 1.30, f"mirror energy ratio {mirror_ratio}"
    assert 0.80 < diffuse_ratio < 1.20, f"diffuse energy ratio {diffuse_ratio}"


def test_masked_transparent_triangles_excluded_from_rt():
    """Opacity-micromap analogue (MeshAsset omm + opacity-micromap-ext):
    fully transparent triangles of a MASKED material are culled from the
    BLAS at build time — shadow rays pass through the empty half of an
    alpha-tested card but are blocked by the opaque half."""
    import jax.numpy as jnp

    from arkoserenderer.ops.bvh import trace_rays
    from arkoserenderer.scene.scene import BLEND_MASKED, Material, Scene
    from arkoserenderer.core.types import SceneLimits

    scene = Scene(limits=SceneLimits(
        max_vertices=1 << 12, max_indices=3 << 12, max_drawables=16,
        max_materials=8, max_textures=8, texture_pool_texels=1 << 16,
    ))
    # Alpha texture: left half transparent, right half opaque.
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., :3] = 200
    tex[:, 4:, 3] = 255
    tid = scene.add_texture(tex, srgb=True)
    mat = scene.add_material(Material(
        base_color_tex=tid, blend_mode=BLEND_MASKED, alpha_cutoff=0.5,
    ))
    # Subdivided card (8x8 grid): the diagonal 2-triangle plane would leave
    # every triangle "mixed"; a grid gives fully-transparent triangles on
    # the empty half.
    from arkoserenderer.apps.geodata import terrain_segment

    card = terrain_segment(np.zeros((9, 9), np.float32), extent=2.0,
                           height_scale=0.0)
    card.material = mat
    sid = scene.add_segment(card)
    scene.add_instance(sid, np.eye(4, dtype=np.float32))
    arrays = scene.build(with_bvh=True)

    # Rays straight down through each half.
    origins = np.array([[-0.5, 1.0, 0.0], [0.5, 1.0, 0.0]], np.float32)
    dirs = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (2, 1))
    hit = trace_rays(arrays.bvh, jnp.asarray(origins), jnp.asarray(dirs))
    hits = np.asarray(hit.hit)
    # uv mapping: one half transparent -> exactly one of the two rays hits.
    assert hits.sum() == 1, hits


def test_half_res_rt_matches_full_res_roughly():
    """rt_scale=2: shadows + reflections trace at quarter rays with
    nearest-depth reconstruction; output must stay close to full-res RT."""
    import dataclasses

    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    r_full = Renderer(scene, cam, CFG, rt_shadows=True, rt_reflections=True,
                      taa=False, bloom=False)
    a = np.array(r_full.render_frame())

    scene2, cam2 = build_test_scene(viewport=(W, H), n_spheres=1)
    cfg2 = dataclasses.replace(CFG, rt_scale=2)
    r_half = Renderer(scene2, cam2, cfg2, rt_shadows=True, rt_reflections=True,
                      taa=False, bloom=False)
    b = np.array(r_half.render_frame())
    assert np.isfinite(b).all()
    # Same image up to reconstruction error at silhouettes.
    assert np.abs(a - b).mean() < 0.02
    assert (np.abs(a - b).max(axis=-1) > 0.1).mean() < 0.06


@pytest.mark.heavy  # multi-frame convergence: nightly lane
def test_reflections_carry_local_light():
    """Reflections of a spot-lit surface must include the spot's energy
    (shade_hits evaluates the scene's local lights like the primary loop):
    a mirror sphere's reflection of the lit floor brightens when the spot
    turns on — and the spot in this setup does not light the sphere's own
    pixels directly (it is outside the cone)."""
    from arkoserenderer.scene.lights import SpotLight

    def mk(with_spot):
        s, c = build_test_scene(viewport=(W, H), n_spheres=1)
        s.sun = None
        s.env_map = np.zeros((1, 2, 3), np.float32)
        s.env_brightness = 0.0
        s.ambient_lx = 0.0
        s.materials[2].roughness_factor = 0.03
        s.materials[2].metallic_factor = 1.0
        s.materials[2].base_color_factor = np.array([1, 1, 1, 1], np.float32)
        if with_spot:
            # A tight cone aimed at the floor patch beside the sphere.
            s.spots.append(SpotLight(
                position=np.array([-1.2, 3.0, 1.5], np.float32),
                direction=np.array([-0.2, -1.0, 0.0], np.float32),
                luminous_intensity_cd=250000.0,
                inner_cone_angle=np.radians(14.0),
                outer_cone_angle=np.radians(20.0),
                cast_shadows=False,
            ))
        return s, c

    def refl(with_spot):
        s, c = mk(with_spot)
        r = Renderer(s, c, CFG, rt_reflections=True, taa=False, bloom=False)
        for _ in range(3):
            r.render_frame()
        return np.array(np.asarray(r.state["SceneReflections"]))

    dark = refl(False)
    lit = refl(True)
    assert np.isfinite(lit).all()
    assert lit.max() > dark.max() + 0.01, (lit.max(), dark.max())
    assert lit.mean() > dark.mean()


@pytest.mark.heavy  # multi-frame convergence: nightly lane
def test_ddgi_probes_collect_local_light():
    """Probe rays evaluate local lights at their hits: with the sun and
    environment off, a spot on the floor is the only energy and DDGI
    irradiance must be nonzero (and zero without the light)."""
    from arkoserenderer.scene.lights import SpotLight

    def irr(with_spot):
        s, c = build_test_scene(viewport=(W, H), n_spheres=1)
        s.sun = None
        s.env_map = np.zeros((1, 2, 3), np.float32)
        s.env_brightness = 0.0
        s.ambient_lx = 0.0
        if with_spot:
            s.spots.append(SpotLight(
                position=np.array([0.0, 3.0, 0.0], np.float32),
                direction=np.array([0.0, -1.0, 0.0], np.float32),
                luminous_intensity_cd=200000.0,
                cast_shadows=True,
            ))
        r = Renderer(s, c, CFG, ddgi=True, taa=False, bloom=False)
        for _ in range(4):
            r.render_frame()
        return np.array(np.asarray(r.state["DDGI.irradiance"]))

    lit = irr(True)
    dark = irr(False)
    assert np.isfinite(lit).all()
    assert lit.max() > 1e-4, lit.max()
    assert lit.max() > dark.max() * 10 + 1e-6, (lit.max(), dark.max())
