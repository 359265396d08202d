"""Soft shadows + sigma denoiser (the reference's NRD ExternalFeature slot,
arkose/rendering/backend/vulkan/features/nrd/VulkanNRD.cpp): cone/disk light
samplers, the sigma shadow denoiser's convergence, and penumbra parity
between the denoised raster path and the converged stochastic estimator."""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import build_test_scene
from arkoserenderer.core import mathx as mx
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig
from arkoserenderer.scene.lights import SpotLight

W = H = 96
CFG = PipelineConfig(
    width=W, height=H,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=128,
)


# -- samplers -----------------------------------------------------------------

def test_sample_cone_statistics(rng):
    axis = np.array([0.3, 0.8, -0.5], np.float32)
    axis /= np.linalg.norm(axis)
    cos_max = np.cos(np.radians(10.0)).astype(np.float32)
    u1 = rng.random(4096).astype(np.float32)
    u2 = rng.random(4096).astype(np.float32)
    d = mx.sample_cone(axis[None, :], cos_max, u1, u2, xp=np)
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    cos = d @ axis
    assert (cos >= cos_max - 1e-5).all()
    # Uniform in cos over [cos_max, 1]: the mean is the interval midpoint.
    assert abs(cos.mean() - (1.0 + cos_max) / 2.0) < 2e-4


def test_sample_cone_zero_radius_is_exact_axis():
    axis = np.array([[0.0, 1.0, 0.0]], np.float32)
    d = mx.sample_cone(axis, np.float32(1.0),
                       np.array([0.37], np.float32),
                       np.array([0.91], np.float32), xp=np)
    assert np.allclose(d, axis, atol=1e-7)


def test_sample_disk_offset(rng):
    axis = np.array([0.6, -0.4, 0.7], np.float32)
    axis /= np.linalg.norm(axis)
    u1 = rng.random(4096).astype(np.float32)
    u2 = rng.random(4096).astype(np.float32)
    off = mx.sample_disk_offset(axis[None, :], 0.5, u1, u2, xp=np)
    # Perpendicular to the axis, inside the radius; uniform-area radial mean
    # is 2R/3.
    assert np.abs(off @ axis).max() < 1e-5
    r = np.linalg.norm(off, axis=-1)
    assert r.max() <= 0.5 + 1e-6
    assert abs(r.mean() - 2.0 * 0.5 / 3.0) < 5e-3
    off0 = mx.sample_disk_offset(axis[None, :], 0.0, u1, u2, xp=np)
    assert np.abs(off0).max() == 0.0


# -- denoiser unit behavior ---------------------------------------------------

def test_shadow_denoiser_constant_input_is_fixed_point(rng):
    import jax.numpy as jnp

    from arkoserenderer.ops import shadow_denoise as sdn

    h = w = 32
    mask = jnp.full((h, w, 1), 0.4, jnp.float32)
    depth = jnp.asarray(rng.random((h, w)).astype(np.float32) * 0.2 + 0.4)
    normal = jnp.tile(jnp.asarray([0.0, 1.0, 0.0], jnp.float32), (h, w, 1))
    vel = jnp.zeros((h, w, 2), jnp.float32)
    xs = np.arange(w, dtype=np.float32) + 0.5
    ys = np.arange(h, dtype=np.float32) + 0.5
    px, py = (g.ravel() for g in np.meshgrid(xs, ys))

    hist = jnp.zeros((h, w, 1), jnp.float32)
    mom = sdn.initial_moments(h, w, 1)
    prev_d = depth
    out, mom = sdn.denoise(mask, depth, normal, vel, hist, mom, prev_d,
                           px, py, True)
    assert np.allclose(np.asarray(out), 0.4, atol=1e-6)  # reset frame passes through
    for _ in range(3):
        out, mom = sdn.denoise(mask, depth, normal, vel, out, mom, depth,
                               px, py, False)
    assert np.allclose(np.asarray(out), 0.4, atol=1e-5)  # stable fixed point
    n = np.asarray(mom)[..., 2]
    assert (n >= 4.0).all()  # the shared sample count accumulates


# -- end-to-end: soft sun penumbra ---------------------------------------------

def _soft_sun_renderer(angular_deg, frames):
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    scene.sun.angular_radius_deg = angular_deg
    # Truth-harness mode: sub-pixel Halton jitter wobbles the depth buffer
    # (and thus the reconstructed receivers) frame to frame, which widens
    # the measured penumbra vs fixed receiver points.
    cam.jitter_enabled = False
    r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False)
    for _ in range(frames):
        r.render_frame()
    return r


@pytest.mark.heavy
def test_soft_sun_matches_converged_estimator():
    """The denoised stochastic mask must converge to the true cone-averaged
    visibility (the occlusion estimator's own expectation) on a static
    camera, and actually produce a penumbra where the hard sun has none."""
    import jax.numpy as jnp

    from arkoserenderer.ops.rt import trace_shadow_mask
    from arkoserenderer.ops.ssao import reconstruct_world_pos

    deg = 10.0
    r = _soft_sun_renderer(deg, frames=20)
    mask = np.asarray(r.state["ShadowMask.sun"])
    vis = np.asarray(r.state["Visibility"]).reshape(-1)
    depth = np.asarray(r.state["SceneDepth"])
    assert np.isfinite(mask).all() and (mask >= 0).all() and (mask <= 1).all()

    # Hard sun: the mask is binary (modulo float), no penumbra band.
    r_hard = _soft_sun_renderer(0.0, frames=2)
    m_hard = np.asarray(r_hard.state["ShadowMask.sun"])
    assert ((m_hard < 0.05) | (m_hard > 0.95)).all()
    soft_band = ((mask > 0.15) & (mask < 0.85)).sum()
    assert soft_band > 30  # a real penumbra region exists

    # Converged truth: average many cone-sampled hard masks at the SAME
    # receiver points (the estimator's expectation; denoiser must land on
    # it). Restrict to covered pixels, batched as one big trace.
    cam_state = r.camera.state(0)
    inv_vp = np.linalg.inv(np.asarray(cam_state.unjittered_view_proj))
    xs = np.arange(W, dtype=np.float32) + 0.5
    ys = np.arange(H, dtype=np.float32) + 0.5
    px, py = (g.ravel() for g in np.meshgrid(xs, ys))
    world = np.asarray(reconstruct_world_pos(
        jnp.asarray(depth.reshape(-1)), px, py, jnp.asarray(inv_vp), W, H
    ))
    covered = vis >= 0
    # Sample the comparison set: every covered pixel in the penumbra band
    # plus a subsample of the rest, capped for test cost.
    band = covered & ((mask.reshape(-1) > 0.1) & (mask.reshape(-1) < 0.9))
    rest = covered & ~band
    idx = np.concatenate([
        np.nonzero(band)[0][:512],
        np.nonzero(rest)[0][::37][:512],
    ])
    pts = world[idx]
    sun_dir = -np.asarray(r.scene.sun.normalized_direction())
    cos_max = np.cos(np.radians(deg)).astype(np.float32)
    n_samp = 64
    rng = np.random.default_rng(7)
    u = rng.random((n_samp, len(idx), 2)).astype(np.float32)
    dirs = mx.sample_cone(sun_dir[None, None, :], np.float32(cos_max),
                          u[..., 0], u[..., 1], xp=np)
    rep = np.broadcast_to(pts[None], (n_samp, len(idx), 3)).reshape(-1, 3)
    arrays = r.scene_arrays
    truth = np.asarray(trace_shadow_mask(
        arrays, jnp.asarray(rep), jnp.asarray(dirs.reshape(-1, 3)),
        jnp.ones(len(rep), bool),
    )).reshape(n_samp, len(idx)).mean(0)

    got = mask.reshape(-1)[idx]
    err = np.abs(got - truth)
    assert err.mean() < 0.06      # converges to the estimator's expectation
    assert np.quantile(err, 0.9) < 0.25


@pytest.mark.heavy
def test_soft_spot_shadow_penumbra():
    scene, cam = build_test_scene(viewport=(W, H), n_spheres=1)
    scene.sun.illuminance_lux = 2000.0
    scene.spots.append(SpotLight(
        position=np.array([-2.0, 3.5, 0.0], np.float32),
        direction=np.array([0.0, -1.0, 0.0], np.float32),
        luminous_intensity_cd=60000.0,
        outer_cone_angle=np.radians(50.0),
        inner_cone_angle=np.radians(35.0),
        cast_shadows=True,
        source_radius=0.35,
    ))
    r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False)
    for _ in range(12):
        img = np.asarray(r.render_frame())
    plane = np.asarray(r.state["ShadowMask.locals"][0])
    assert np.isfinite(img).all()
    assert np.isfinite(plane).all()
    assert (plane >= 0).all() and (plane <= 1).all()
    # A real penumbra band exists...
    assert ((plane > 0.15) & (plane < 0.85)).sum() > 20
    # ...while the zero-radius light stays binary.
    scene2, cam2 = build_test_scene(viewport=(W, H), n_spheres=1)
    scene2.sun.illuminance_lux = 2000.0
    scene2.spots.append(SpotLight(
        position=np.array([-2.0, 3.5, 0.0], np.float32),
        direction=np.array([0.0, -1.0, 0.0], np.float32),
        luminous_intensity_cd=60000.0,
        outer_cone_angle=np.radians(50.0),
        inner_cone_angle=np.radians(35.0),
        cast_shadows=True,
    ))
    r2 = Renderer(scene2, cam2, CFG, rt_shadows=True, taa=False, bloom=False)
    r2.render_frame()
    plane2 = np.asarray(r2.state["ShadowMask.locals"][0])
    assert ((plane2 < 0.05) | (plane2 > 0.95)).all()


@pytest.mark.heavy  # multi-frame convergence: nightly lane
def test_pathtracer_soft_sun_penumbra():
    """PT parity: a soft sun produces intermediate shadow values where the
    hard sun is binary, with total energy roughly preserved."""
    from arkoserenderer.models.pathtracer import PathTracer

    def render(deg, spp):
        scene, cam = build_test_scene(viewport=(48, 48), n_spheres=1)
        scene.sun.angular_radius_deg = deg
        scene.env_map = np.zeros((1, 2, 3), np.float32)
        scene.env_brightness = 0.0
        scene.ambient_lx = 0.0
        pt = PathTracer(scene, cam, 48, 48, max_bounces=1, aa=False)
        pt.render_sample(spp)
        return np.asarray(pt.radiance())

    hard = render(0.0, 1)       # deterministic NEE: 1 sample suffices
    soft = render(14.0, 24)
    assert np.isfinite(soft).all()
    lum_h = hard.mean(-1)
    lum_s = soft.mean(-1)
    # Pixels that were hard-shadowed but lie in the soft penumbra brighten;
    # fully-lit regions barely change -> overall energy close.
    assert abs(lum_s.mean() - lum_h.mean()) / max(lum_h.mean(), 1e-6) < 0.12
    changed = np.abs(lum_s - lum_h) > 0.02 * max(lum_h.max(), 1e-6)
    assert changed.sum() > 10   # the penumbra moved real pixels
