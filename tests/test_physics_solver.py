"""Rigid-body solver behavior (the Jolt-class capabilities the reference
gets from arkose/physics/backend/jolt/JoltPhysicsBackend.cpp): Coulomb
friction, restitution, box-box manifolds, stacking stability, and body
activation (sleeping)."""

import numpy as np

from arkoserenderer.physics.backend import (
    BodyDesc,
    BuiltinPhysicsBackend,
)


def _floor():
    b = BuiltinPhysicsBackend()
    b.add_static_plane((0, 1, 0), 0.0)
    return b


def test_five_box_stack_is_stable():
    """The classic solver acceptance test: a 5-box tower must neither sink,
    drift, nor topple over 5 simulated seconds (needs multi-point contact
    manifolds + accumulated friction — a single-contact solver rocks itself
    apart)."""
    b = _floor()
    boxes = []
    for k in range(5):
        boxes.append(b.add_body(
            BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=1.0,
                     restitution=0.0),
            (0.0, 0.5 + 1.0 * k + 0.001 * k, 0.0),
        ))
    for _ in range(300):
        b.step(1 / 60.0)
    for k, body in enumerate(boxes):
        p = b.pos[body]
        assert abs(p[0]) < 0.08 and abs(p[2]) < 0.08, (k, p)  # no drift
        assert abs(p[1] - (0.5 + 1.0 * k)) < 0.06, (k, p)     # no sink/fly
        # Still upright: the local up axis stays within ~8 deg of world up.
        m = b.body_transform(body)
        assert m[1, 1] > 0.99, (k, m)
    # The settled stack goes to sleep (body activation).
    assert all(b.asleep[body] for body in boxes)


def test_coulomb_friction_holds_and_releases_on_incline():
    """tan(theta) vs mu decides statics: a box on a 15-degree incline must
    HOLD with mu = 0.6 (tan 15 = 0.27) and SLIDE with mu = 0.05."""
    theta = np.radians(15.0)
    n = np.array([-np.sin(theta), np.cos(theta), 0.0], np.float32)

    def run(mu):
        b = BuiltinPhysicsBackend()
        b.add_static_plane(n, 0.0)
        body = b.add_body(
            BodyDesc("box", np.array([0.3, 0.3, 0.3]), mass=1.0,
                     restitution=0.0, friction=mu),
            np.array([0.0, 0.0, 0.0]) + n * 0.3,
        )
        # Seat the box flat on the incline (rotate about +Z by theta) so the
        # test measures friction statics, not the corner-seating wobble.
        b.quat[body] = np.array(
            [0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)], np.float32
        )
        start = b.pos[body].copy()
        for _ in range(180):
            b.step(1 / 60.0)
        return float(np.linalg.norm(b.pos[body] - start))

    assert run(0.6) < 0.05    # static friction holds
    assert run(0.05) > 0.5    # slides away


def test_restitution_bounce_ratio():
    """Successive bounce heights of an e = 0.5 sphere follow h2/h1 ~ e^2."""
    b = _floor()
    ball = b.add_body(
        BodyDesc("sphere", np.array([0.2] * 3), mass=1.0, restitution=0.5),
        (0, 2.0, 0),
    )
    heights = []
    for _ in range(480):
        b.step(1 / 60.0)
        heights.append(float(b.pos[ball][1]))
    h = np.array(heights)
    # Find the first two bounce apexes (local maxima after the first touch).
    touch = int(np.argmax(h < 0.25))
    seg = h[touch:]
    rising = np.nonzero((seg[1:-1] > seg[:-2]) & (seg[1:-1] >= seg[2:]))[0]
    apex1 = float(seg[rising[0] + 1]) - 0.2
    later = rising[rising > rising[0] + 5]
    apex2 = float(seg[later[0] + 1]) - 0.2
    ratio = apex2 / apex1
    assert 0.1 < ratio < 0.45  # ~e^2 = 0.25, generous band


def test_box_box_collision_transfers_momentum():
    """A sliding box hits a resting one: momentum transfers through the
    box-box manifold and both keep finite, same-direction velocities."""
    b = _floor()
    a = b.add_body(
        BodyDesc("box", np.array([0.4, 0.4, 0.4]), mass=1.0,
                 restitution=0.1, friction=0.0),
        (-2.0, 0.4, 0.0), velocity=(4.0, 0.0, 0.0),
    )
    c = b.add_body(
        BodyDesc("box", np.array([0.4, 0.4, 0.4]), mass=1.0,
                 restitution=0.1, friction=0.0),
        (0.0, 0.4, 0.0),
    )
    for _ in range(90):
        b.step(1 / 60.0)
    va = b.vel[a]
    vc = b.vel[c]
    pc = b.pos[c]
    assert pc[0] > 0.15                  # the resting box was pushed +X
    assert vc[0] >= -1e-3                # never pushed backwards
    assert float(va[0]) < 4.0            # the impactor slowed down
    assert np.isfinite(va).all() and np.isfinite(vc).all()


def test_sleeping_body_wakes_on_impulse():
    b = _floor()
    box = b.add_body(
        BodyDesc("box", np.array([0.5, 0.5, 0.5]), mass=1.0,
                 restitution=0.0),
        (0, 0.5, 0),
    )
    for _ in range(120):
        b.step(1 / 60.0)
    assert b.asleep[box]
    p0 = b.pos[box].copy()
    for _ in range(60):   # asleep: gravity/solver skip it, zero drift
        b.step(1 / 60.0)
    assert np.allclose(b.pos[box], p0)
    b.apply_impulse(box, (4.0, 0.0, 0.0))
    assert not b.asleep[box]
    for _ in range(30):
        b.step(1 / 60.0)
    assert b.pos[box][0] > 0.1           # woke and moved


def test_box_tumbles_with_orientation():
    """Angular dynamics are real: a box launched spinning updates its
    orientation quaternion (body_transform rotation differs from identity)."""
    b = _floor()
    box = b.add_body(
        BodyDesc("box", np.array([0.3, 0.3, 0.3]), mass=1.0),
        (0, 3.0, 0),
    )
    b.omega[box] = np.array([0.0, 0.0, 3.0], np.float32)
    for _ in range(20):
        b.step(1 / 60.0)
    m = b.body_transform(box)
    assert abs(m[0, 0] - 1.0) > 0.1      # visibly rotated about Z
    q = b.quat[box]
    assert abs(float(np.linalg.norm(q)) - 1.0) < 1e-5
