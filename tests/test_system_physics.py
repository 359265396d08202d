"""System/input layer, camera controllers, physics integrator."""

import numpy as np

from arkoserenderer.physics.backend import (
    BodyDesc,
    BuiltinPhysicsBackend,
    PhysicsScene,
)
from arkoserenderer.scene.camera import Camera
from arkoserenderer.scene.controllers import FpsCameraController, MapCameraController
from arkoserenderer.system.input import Input
from arkoserenderer.system.system import HeadlessSystem, ReplaySystem


def test_input_edges_and_axes():
    inp = Input()
    inp.push_key_down("W")
    assert inp.is_down("w") and inp.was_pressed("w")
    assert inp.axis("w", "s") == 1.0
    inp.new_frame()
    assert inp.is_down("w") and not inp.was_pressed("w")
    inp.push_key_up("w")
    assert inp.was_released("w") and not inp.is_down("w")


def test_fps_controller_moves_forward():
    cam = Camera(viewport=(64, 64))
    cam.look_at((0, 0, 5), (0, 0, 0))
    ctl = FpsCameraController(cam)
    inp = Input()
    inp.push_key_down("w")
    for _ in range(60):
        ctl.update(inp, 1 / 60)
    assert cam.position[2] < 4.0  # moved toward -Z


def test_fps_controller_mouse_look():
    cam = Camera(viewport=(64, 64))
    cam.look_at((0, 0, 5), (0, 0, 0))
    ctl = FpsCameraController(cam)
    inp = Input()
    inp.push_mouse_move(0, 0)
    inp.new_frame()
    inp.push_mouse_move(200, 0)
    ctl.update(inp, 1 / 60)
    fwd = np.asarray(
        __import__("arkoserenderer.core.mathx", fromlist=["quat_rotate"]).quat_rotate(
            cam.orientation, np.array([0, 0, -1.0], np.float32), xp=np
        )
    )
    assert abs(fwd[0]) > 0.1  # yawed


def test_map_controller_zoom():
    cam = Camera(viewport=(64, 64))
    ctl = MapCameraController(cam, distance=10.0)
    inp = Input()
    inp.push_scroll(3.0)
    ctl.update(inp, 1 / 60)
    assert ctl.distance < 10.0
    assert np.isfinite(cam.position).all()


def test_replay_system_feeds_events():
    sys = ReplaySystem([(0, "push_key_down", ("w",)), (2, "push_key_up", ("w",))],
                       max_frames=4)
    frames_down = []
    while sys.new_frame():
        frames_down.append(sys.input.is_down("w"))
        sys.present(None)
    assert frames_down == [True, True, False, False]


def test_physics_ball_bounces_and_settles():
    b = BuiltinPhysicsBackend()
    b.add_static_plane((0, 1, 0), 0.0)
    ball = b.add_body(BodyDesc("sphere", np.array([0.2, 0.2, 0.2]), mass=1.0,
                               restitution=0.5), (0, 3.0, 0))
    heights = []
    for _ in range(600):
        b.step(1 / 60)
        heights.append(float(b.pos[ball][1]))
    assert min(heights) >= 0.19  # never penetrates the floor
    assert abs(heights[-1] - 0.2) < 0.02  # settled on the floor
    # It bounced: some local maximum after the first fall.
    first_touch = next(i for i, h in enumerate(heights) if h < 0.25)
    assert max(heights[first_touch:]) > 0.3


def test_physics_impulse_and_scene_sync():
    from arkoserenderer.assets.procedural import build_test_scene

    scene, cam = build_test_scene(viewport=(64, 64), n_spheres=1)
    b = BuiltinPhysicsBackend()
    b.add_static_plane((0, 1, 0), 0.0)
    body = b.add_body(BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=2.0), (0, 0.5, 0))
    ps = PhysicsScene(backend=b, scene=scene)
    ps.attach(body, 1)  # the sphere instance
    b.apply_impulse(body, (6.0, 0, 0))
    for _ in range(30):
        b.step(1 / 60)
    ps.commit()
    _, world, prev, *_ = scene.instances[1]
    assert world[0, 3] > 0.1  # moved +X from the impulse (friction decays it)
    assert prev is not None   # previous transform recorded for velocity


def test_dynamic_transforms_stream_into_renderer():
    """PhysicsScene.commit + Renderer(dynamic_transforms=True): the moved
    body shows up in the next frame without a scene rebuild (incremental
    instance-transform upload)."""
    from arkoserenderer.core.types import RasterConfig
    from arkoserenderer.models.standard import Renderer
    from arkoserenderer.rendering.pipeline import PipelineConfig

    from arkoserenderer.assets.procedural import build_test_scene

    cfg = PipelineConfig(
        width=96, height=96,
        raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
        shadow_map_size=128,
    )
    scene, cam = build_test_scene(viewport=(96, 96), n_spheres=1)
    r = Renderer(scene, cam, cfg, taa=False, bloom=False, dynamic_transforms=True)
    img0 = np.array(r.render_frame())
    arrays_before = r.scene_arrays

    # Teleport the sphere (instance 1) +1.2m up, as physics/editor would.
    sid, w, pw, clip, band = scene.instances[1]
    w2 = np.array(w)
    w2[1, 3] += 1.2
    scene.instances[1] = (sid, w2, w, clip, band)
    img1 = np.array(r.render_frame())

    assert np.abs(img1 - img0).max() > 0.05     # the sphere visibly moved
    # The heavy pools were NOT re-uploaded (same device buffers).
    assert r.scene_arrays.positions is arrays_before.positions
    assert r.scene_arrays.indices is arrays_before.indices
    # And the world transform did change on device.
    moved = float(np.asarray(r.scene_arrays.world[1][1, 3])
                  - np.asarray(arrays_before.world[1][1, 3]))
    assert abs(moved - 1.2) < 1e-5


def test_physics_triangle_mesh_collision():
    """Triangle-mesh collider (PhysicsBackend.h:14-47 mesh shape): a sphere
    dropped onto a ramp mesh stays ON the surface and — with Coulomb
    friction and real angular dynamics — ROLLS downhill (friction torque
    spins it up; tan(14 deg) < mu, so it cannot merely slide)."""
    import numpy as np

    from arkoserenderer.physics.backend import BodyDesc, BuiltinPhysicsBackend

    b = BuiltinPhysicsBackend()
    verts = np.array([[-2, 0, -2], [2, 1, -2], [2, 1, 2], [-2, 0, 2]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    b.add_static_mesh(verts, tris)
    body = b.add_body(BodyDesc("sphere", np.array([0.2] * 3, np.float32)),
                      (0.5, 3.0, 0.0))
    for _ in range(90):   # long enough to roll, short enough to stay on ramp
        b.step(1 / 60.0)
    p = b.pos[body]
    surface_y = (p[0] + 2) / 4            # the ramp plane: y = (x + 2) / 4
    assert 0.1 < p[1] - surface_y < 0.35  # riding at ~radius above surface
    assert p[0] < 0.2                     # moved downhill
    assert abs(p[2]) < 0.1                # no sideways drift
    assert float(b.omega[body][2]) > 1.0  # rolling, not sliding (+Z spin)
