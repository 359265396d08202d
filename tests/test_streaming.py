"""Incremental geometry streaming (VertexManager streaming state machine)."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene, make_box
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.scene import Material

CFG = PipelineConfig(
    width=96, height=96,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


def test_stream_instance_appears_without_rebuild():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    red = scene.add_material(Material(
        base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
    box = make_box((1.2, 1.2, 1.2))
    box.material = red
    sid = scene.add_segment(box)

    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img0 = np.array(r.render_frame())
    compiled_before = r.pipeline._compiled

    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.5, 0.6, 1.5)
    r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, w)
    img1 = np.array(r.render_frame())

    # The streamed box renders...
    assert np.abs(img1 - img0).max() > 0.05
    assert np.isfinite(img1).all()
    # ...with the SAME compiled frame function (no retrace/rebuild).
    assert r.pipeline._compiled is compiled_before

    # Streaming again stacks more instances.
    w2 = np.array(w); w2[:3, 3] = (1.5, 0.6, -1.0)
    r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, w2)
    img2 = np.array(r.render_frame())
    assert np.abs(img2 - img1).max() > 0.05


def test_stream_instance_capacity_error():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    sid = 1  # the sphere segment
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    w = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="pools full"):
        for _ in range(10000):
            r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, w)


def test_stream_matches_full_rebuild():
    """A streamed scene must render the same image as the equivalent scene
    built from scratch."""
    def fresh(extra):
        scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
        mat = scene.add_material(Material(
            base_color_factor=np.array([0.2, 0.8, 0.3, 1.0], np.float32)))
        box = make_box((1.0, 1.0, 1.0))
        box.material = mat
        sid = scene.add_segment(box)
        if extra:
            w = np.eye(4, dtype=np.float32)
            w[:3, 3] = (1.8, 0.5, 0.5)
            scene.add_instance(sid, w)
        return scene, cam, sid

    scene_a, cam_a, _ = fresh(extra=True)
    ra = Renderer(scene_a, cam_a, CFG, taa=False, bloom=False)
    ra.render_frame()
    ref = np.array(ra.render_frame())  # frame 1 (same jitter as below)

    scene_b, cam_b, sid = fresh(extra=False)
    rb = Renderer(scene_b, cam_b, CFG, taa=False, bloom=False)
    rb.render_frame()
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.8, 0.5, 0.5)
    rb.scene_arrays = scene_b.stream_instance(rb.scene_arrays, sid, w)
    got = np.array(rb.render_frame())
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_budgeted_streaming_state_machine():
    """The round-2 streaming criterion (VertexManager.h:187-226 +
    GpuScene.cpp:483-553): a large mesh loads across MULTIPLE frames under a
    per-frame byte budget while the renderer keeps producing frames with the
    same compiled function; the instance appears only once fully loaded."""
    from arkoserenderer.assets.procedural import make_uv_sphere
    from arkoserenderer.rendering.streaming import LOADED, StreamingManager

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    red = scene.add_material(Material(
        base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
    big = make_uv_sphere(1.1, rings=48, sectors=96)   # ~400 KB of pool data
    big.material = red
    sid = scene.add_segment(big)

    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    # Lockstep base renderer: same scene WITHOUT streaming, stepped in sync
    # so the per-frame Halton raster jitter matches frame for frame.
    scene_b, cam_b = build_test_scene(viewport=(96, 96), n_spheres=1)
    r_base = Renderer(scene_b, cam_b, CFG, taa=False, bloom=False)
    np.array(r.render_frame())
    np.array(r_base.render_frame())
    compiled_before = r.pipeline._compiled

    budget = 64 << 10
    mgr = StreamingManager(scene, budget_bytes=budget, chunk_rows=1024)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.6, 1.1, 1.4)
    ticket = mgr.enqueue_instance(sid, w)
    assert ticket.bytes_total > 4 * budget  # genuinely needs several frames

    frames_needed = 0
    diffs = []
    while mgr.pending:
        r.scene_arrays = mgr.tick(r.scene_arrays)
        assert mgr.bytes_uploaded_last_tick <= budget + 1024 * 64  # chunk slop
        img = np.array(r.render_frame())
        base = np.array(r_base.render_frame())
        diffs.append(np.abs(img - base).max())
        frames_needed += 1
        assert frames_needed < 64
    assert frames_needed >= 4          # the budget actually paced the load
    assert ticket.state == LOADED

    # Invisible until loaded: every mid-stream frame matches the lockstep
    # base render exactly (the load-safe upload ordering never exposes a
    # partial instance). The final in-loop frame may already show it.
    assert max(diffs[:-1]) < 1e-4, diffs
    final = np.array(r.render_frame())
    base = np.array(r_base.render_frame())
    assert np.abs(final - base).max() > 0.05   # now it renders
    assert r.pipeline._compiled is compiled_before  # zero retraces

    # And the result is identical to the immediate (unbudgeted) path.
    scene2, cam2 = build_test_scene(viewport=(96, 96), n_spheres=1)
    red2 = scene2.add_material(Material(
        base_color_factor=np.array([0.9, 0.1, 0.1, 1.0], np.float32)))
    big2 = make_uv_sphere(1.1, rings=48, sectors=96)
    big2.material = red2
    sid2 = scene2.add_segment(big2)
    r2 = Renderer(scene2, cam2, CFG, taa=False, bloom=False)
    r2.render_frame()
    r2.scene_arrays = scene2.stream_instance(r2.scene_arrays, sid2, w)
    # Step to the same frame index so the raster jitter matches.
    for _ in range(frames_needed + 1):
        ref = np.array(r2.render_frame())
    np.testing.assert_allclose(final, ref, atol=2e-3)


def test_async_prepare_then_stream():
    """enqueue_async runs the prepare step on a TaskGraph worker (the
    reference's background asset loads) and the ticket flows through the
    same budgeted state machine once ready."""
    from arkoserenderer.rendering.streaming import LOADED, StreamingManager

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    blue = scene.add_material(Material(
        base_color_factor=np.array([0.1, 0.2, 0.9, 1.0], np.float32)))
    box = make_box((1.0, 1.0, 1.0))
    box.material = blue
    sid = scene.add_segment(box)

    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img0 = np.array(r.render_frame())

    mgr = StreamingManager(scene, budget_bytes=8 << 20)

    def prepare():
        # Simulated decode work, then stage on the worker thread's result.
        w = np.eye(4, dtype=np.float32)
        w[:3, 3] = (-1.8, 0.5, 1.2)
        return (sid, w)

    ticket = mgr.enqueue_async(prepare)
    for _ in range(32):
        r.scene_arrays = mgr.tick(r.scene_arrays)
        r.render_frame()
        if not mgr.pending:
            break
    assert ticket.state == LOADED
    img1 = np.array(r.render_frame())
    assert np.abs(img1 - img0).max() > 0.05


def test_streamed_instance_visible_to_rt_without_rebuild():
    """A streamed instance of an existing segment must appear in RT (sun
    shadow mask + reflections) via the parked-TLAS-slot + in-jit-refit path
    (ops/bvh inst_cap) — no host BVH rebuild, no retrace — and match the
    image a full rebuild produces."""
    def make():
        return build_test_scene(viewport=(96, 96), n_spheres=1)

    scene, cam = make()
    r = Renderer(scene, cam, CFG, rt_shadows=True, rt_reflections=True,
                 taa=False, bloom=False)
    img0 = np.array(r.render_frame())
    compiled_before = r.pipeline._compiled

    # Stream a second sphere (segment 1 = the build-time sphere) hovering
    # above the floor between camera and sun: it must cast an RT shadow.
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.2, 1.6, 1.2)
    r.scene_arrays = scene.stream_instance(r.scene_arrays, 1, w)
    img1 = np.array(r.render_frame())
    assert np.isfinite(img1).all()
    assert np.abs(img1 - img0).max() > 0.05          # it changed the frame
    assert r.pipeline._compiled is compiled_before   # no retrace

    # Let the reflection denoiser's temporal accumulation converge past the
    # pre-stream history.
    for _ in range(4):
        img1 = np.array(r.render_frame())

    # Ground truth: the same scene fully rebuilt from scratch, rendered to
    # the SAME frame index (same camera jitter) with the same number of
    # post-scene-change frames.
    scene2, cam2 = make()
    w2 = np.eye(4, dtype=np.float32)
    w2[:3, 3] = (1.2, 1.6, 1.2)
    scene2.add_instance(1, w2)
    r2 = Renderer(scene2, cam2, CFG, rt_shadows=True, rt_reflections=True,
                  taa=False, bloom=False)
    for _ in range(r.frame_index):
        img2 = np.array(r2.render_frame())
    # Same geometry; BVH topology differs (streamed leaf vs rebuilt tree)
    # but the traced image must match except fp-order edge pixels and the
    # temporal tail of the pre-stream reflection history.
    diff = np.abs(img1 - img2)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff.max(axis=-1) > 0.05).mean() < 0.01


def test_streamed_material_texture_chain():
    """TEXTURE streaming: a material + texture registered AFTER build append
    the packed texture chain into the texel pool's capacity padding
    (Scene.stream_material) and become sampleable with no pipeline rebuild —
    the GpuScene.cpp:483-553 async-texture-finalization analogue."""
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    img0 = np.array(r.render_frame())
    compiled_before = r.pipeline._compiled

    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 0] = 255
    tex[..., 3] = 255
    tid = scene.add_texture(tex, srgb=True)
    r.scene_arrays, mid = scene.stream_material(
        r.scene_arrays, Material(base_color_tex=tid))

    box = make_box((1.0, 1.0, 1.0))
    box.material = mid
    sid = scene.add_segment(box)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.5, 0.8, 1.5)
    r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, w)

    img1 = np.array(r.render_frame())
    assert np.isfinite(img1).all()
    assert r.pipeline._compiled is compiled_before   # no retrace
    changed = np.abs(img1 - img0).max(axis=-1) > 0.05
    assert changed.any()
    # The box's redness can only come from the STREAMED texels: the record's
    # base_color_factor is white and the build-time pool never held red.
    red = img1[..., 0] - np.maximum(img1[..., 1], img1[..., 2])
    assert (red[changed] > 0.02).mean() > 0.5


def test_streamed_material_via_streaming_manager_budget():
    """The same texture chain through the budgeted StreamingManager: texel
    rows upload over several ticks under a small byte budget, and the
    material record lands LAST (a half-resident material never samples)."""
    from arkoserenderer.rendering.streaming import StreamingManager

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    r.render_frame()

    tex = np.zeros((32, 32, 4), np.uint8)
    tex[..., 0] = 255
    tex[..., 3] = 255
    tid = scene.add_texture(tex, srgb=True)
    mgr = StreamingManager(scene, budget_bytes=4 << 10)
    t = mgr.enqueue_material(Material(base_color_tex=tid))
    assert t.material_id >= 0
    # texel rows stream before the material record
    assert t.uploads[0].field == "mat_tex.rows"
    assert t.uploads[-1].field == "mat_records"

    ticks = 0
    while mgr.pending and ticks < 64:
        r.scene_arrays = mgr.tick(r.scene_arrays)
        ticks += 1
    assert t.state == "loaded"
    assert ticks > 1   # the budget actually split the chain across frames

    box = make_box((1.0, 1.0, 1.0))
    box.material = t.material_id
    sid = scene.add_segment(box)
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.5, 0.8, 1.5)
    r.scene_arrays = scene.stream_instance(r.scene_arrays, sid, w)
    img = np.array(r.render_frame())
    assert np.isfinite(img).all()
    red = img[..., 0] - np.maximum(img[..., 1], img[..., 2])
    assert (red > 0.02).any()


def test_streamed_material_pool_full():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, taa=False, bloom=False)
    big = np.zeros((512, 512, 4), np.uint8)
    big[..., 3] = 255
    n_mats = len(scene.materials)
    # Either capacity guard may trip first: the id-pool's raw-texel cursor
    # (add_texture) or the packed-row cursor (stage_material).
    with pytest.raises((RuntimeError, AssertionError), match="pool"):
        for _ in range(64):
            tid = scene.add_texture(big, srgb=False)
            r.scene_arrays, _ = scene.stream_material(
                r.scene_arrays, Material(base_color_tex=tid))
    # the failed stage rolled its material registration back
    assert len(scene.materials) < n_mats + 64


def test_streamed_instance_rt_via_streaming_manager():
    """Same path through the budgeted StreamingManager: the ticket's BVH
    rows upload under budget and the completion refit makes the instance
    visible to RT within a bounded number of frames."""
    from arkoserenderer.rendering.streaming import StreamingManager

    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False)
    img0 = np.array(r.render_frame())

    mgr = StreamingManager(scene, budget_bytes=16 << 10)  # small budget
    w = np.eye(4, dtype=np.float32)
    w[:3, 3] = (1.2, 1.6, 1.2)
    t = mgr.enqueue_instance(1, w)
    frames = 0
    while mgr.pending and frames < 64:
        r.scene_arrays = mgr.tick(r.scene_arrays)
        r.render_frame()
        frames += 1
    assert t.state == "loaded"
    img1 = np.array(r.render_frame())
    assert np.abs(img1 - img0).max() > 0.05
    assert np.isfinite(img1).all()


def test_streamed_skinned_instance_matches_rebuild():
    """Skeletal streaming (round 3 — the VertexManager
    allocateSkeletalMeshInstance analogue): a skinned instance streamed into
    a live scene must render identically to the same scene built from
    scratch (palette range allocation, skin pool rows, skinned vertex path)."""
    from arkoserenderer.scene.animation import Skeleton

    def skinned_scene(extra: bool):
        scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
        skel = scene.add_skeleton(Skeleton(
            parents=np.array([-1], np.int32),
            inverse_bind=np.eye(4, dtype=np.float32)[None],
            # Rest pose carries a visible offset: the skinned box renders
            # shifted vs its instance transform, so skinning provably runs.
            rest_translation=np.array([[0.4, 0.8, 0.0]], np.float32),
            rest_rotation=np.array([[0, 0, 0, 1]], np.float32),
            rest_scale=np.ones((1, 3), np.float32),
        ))
        box = make_box((0.8, 0.8, 0.8))
        box.material = scene.add_material(Material(
            base_color_factor=np.array([0.9, 0.2, 0.2, 1.0], np.float32)))
        v = box.positions.shape[0]
        box.skeleton = skel
        box.skin_joints = np.zeros((v, 4), np.int32)
        box.skin_weights = np.tile(
            np.array([1, 0, 0, 0], np.float32), (v, 1))
        sid = scene.add_segment(box)
        w0 = np.eye(4, dtype=np.float32)
        w0[:3, 3] = (-1.5, 0.6, 1.2)
        scene.add_instance(sid, w0)      # scene has skin at build time
        w1 = np.eye(4, dtype=np.float32)
        w1[:3, 3] = (1.6, 0.6, -0.4)
        if extra:
            scene.add_instance(sid, w1)
        return scene, cam, sid, w1

    scene_a, cam_a, _, _ = skinned_scene(extra=True)
    ra = Renderer(scene_a, cam_a, CFG, taa=False, bloom=False)
    ra.render_frame()
    ref = np.array(ra.render_frame())

    scene_b, cam_b, sid, w1 = skinned_scene(extra=False)
    rb = Renderer(scene_b, cam_b, CFG, taa=False, bloom=False)
    rb.render_frame()
    rb.scene_arrays = scene_b.stream_instance(rb.scene_arrays, sid, w1)
    got = np.array(rb.render_frame())
    np.testing.assert_allclose(got, ref, atol=1e-5)

    # The rest-pose offset must actually show: a rigid (unskinned) copy at
    # w1 would sit 0.8 lower — prove the streamed instance skins by
    # checking it differs from the rigid-streamed image.
    scene_c, cam_c, _, _ = skinned_scene(extra=False)
    rigid = make_box((0.8, 0.8, 0.8))
    rigid.material = scene_c.segments[-1].material
    sid_r = scene_c.add_segment(rigid)
    rc = Renderer(scene_c, cam_c, CFG, taa=False, bloom=False)
    rc.render_frame()
    rc.scene_arrays = scene_c.stream_instance(rc.scene_arrays, sid_r, w1)
    rigid_img = np.array(rc.render_frame())
    assert np.abs(rigid_img - ref).max() > 0.05


def test_streamed_skinned_requires_skin_path():
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    from arkoserenderer.scene.animation import Skeleton

    skel = scene.add_skeleton(Skeleton(
        parents=np.array([-1], np.int32),
        inverse_bind=np.eye(4, dtype=np.float32)[None],
        rest_translation=np.zeros((1, 3), np.float32),
        rest_rotation=np.array([[0, 0, 0, 1]], np.float32),
        rest_scale=np.ones((1, 3), np.float32),
    ))
    box = make_box((0.5, 0.5, 0.5))
    v = box.positions.shape[0]
    box.skeleton = skel
    box.skin_joints = np.zeros((v, 4), np.int32)
    box.skin_weights = np.tile(np.array([1, 0, 0, 0], np.float32), (v, 1))
    sid = scene.add_segment(box)
    scene.build()  # no skinned instance -> program has no skinning path
    with pytest.raises(AssertionError, match="skinning path"):
        scene.stage_instance(sid, np.eye(4, dtype=np.float32))
