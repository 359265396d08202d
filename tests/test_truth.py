"""Pixel-level truth harness: the path tracer as ground truth for the
raster pipeline (the role PathTracerNode plays in the reference,
arkose/rendering/pathtracer/PathTracerNode.cpp:27-104 — ours goes further
and pins the agreement per pixel, which the reference never automated).

Setup that makes the comparison exact rather than statistical:
- sun-only, zero environment, zero flat ambient: the path tracer's
  first-bounce NEE is then *identically* the raster pipeline's direct term
  (same brdf.evaluate, same sun radiance, same exposure);
- PathTracer(aa=False): primary rays through exact pixel centers, so both
  renderers shade the same surface points (one deterministic sample
  suffices — with no environment, direct NEE has zero variance);
- Renderer(vignette=0.0): the Output pass's lens vignette is a stylistic
  term the path tracer deliberately lacks;
- rt_shadows: exact any-hit sun shadows on both sides (no VSM blur).

Under that setup, a broken BRDF term, normal interpolation bug, exposure
unit drift, shadow bias regression, or tonemap change shows up as a
per-pixel mismatch > 5% — the round-2 harness only bounded *image mean*
brightness to +/-40%.
"""

import numpy as np
import pytest

from arkoserenderer.assets.procedural import (
    build_flat_test_scene,
    build_test_scene,
)
from arkoserenderer.core.types import RasterConfig
from arkoserenderer.models.pathtracer import PathTracer
from arkoserenderer.models.standard import Renderer
from arkoserenderer.rendering.pipeline import PipelineConfig

W = H = 128
CFG = PipelineConfig(
    width=W, height=H,
    raster=RasterConfig(tile_h=8, tile_w=16, max_tris_per_tile=256),
    shadow_map_size=512,
)


def _edge_mask(img: np.ndarray, thresh: float = 0.03) -> np.ndarray:
    """True where the image is locally smooth (silhouette/shadow edges are
    half-pixel coverage questions, not shading correctness questions)."""
    lum = img.mean(-1)
    gx = np.abs(np.diff(lum, axis=1, prepend=lum[:, :1]))
    gy = np.abs(np.diff(lum, axis=0, prepend=lum[:1]))
    g = (gx + gy) > thresh
    edge = g.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= np.roll(np.roll(g, dy, 0), dx, 1)
    return ~edge


def _sun_only(scene):
    scene.env_map = np.zeros((1, 2, 3), np.float32)
    scene.env_brightness = 0.0
    scene.ambient_lx = 0.0


@pytest.mark.heavy
def test_direct_lighting_pixelwise():
    scene, cam = build_flat_test_scene(viewport=(W, H))
    r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False,
                 vignette=0.0)
    raster = np.array(r.render_frame())

    scene2, cam2 = build_flat_test_scene(viewport=(W, H))
    tr = PathTracer(scene2, cam2, W, H, max_bounces=1, seed=3, aa=False)
    tr.render_sample(1)  # deterministic: direct NEE has zero variance
    pt = np.array(tr.ldr())

    mask = _edge_mask(raster)
    assert mask.mean() > 0.7  # the scene is mostly smooth surfaces
    rel = np.abs(pt - raster).max(-1) / (raster.mean(-1) + 0.02)
    assert rel[mask].mean() < 0.01, f"mean rel {rel[mask].mean():.4f}"
    frac_bad = (rel[mask] > 0.05).mean()
    assert frac_bad < 0.015, f"{frac_bad:.2%} of smooth pixels off by >5%"


@pytest.mark.heavy
def test_textured_block_means():
    """Textured scene: texture *filtering* legitimately differs (screen-space
    mip selection vs the tracer's fixed ray mip), so compare 8x8 block means
    — filtering moves texels within a block, a broken sampler/material
    pipeline moves the block mean."""
    scene, cam = build_test_scene(viewport=(W, H))
    _sun_only(scene)
    r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False,
                 vignette=0.0)
    raster = np.array(r.render_frame())

    scene2, cam2 = build_test_scene(viewport=(W, H))
    _sun_only(scene2)
    tr = PathTracer(scene2, cam2, W, H, max_bounces=1, seed=5)
    tr.render_sample(8)
    pt = np.array(tr.ldr())

    rb = raster.reshape(H // 8, 8, W // 8, 8, 3).mean((1, 3))
    pb = pt.reshape(H // 8, 8, W // 8, 8, 3).mean((1, 3))
    rel = np.abs(pb - rb).max(-1) / (rb.mean(-1) + 0.02)
    assert rel.mean() < 0.03, f"block mean rel {rel.mean():.4f}"
    assert (rel > 0.10).mean() < 0.04, f"{(rel > 0.10).mean():.2%} blocks >10%"


@pytest.mark.heavy
def test_local_lights_pixelwise():
    """Spot + point NEE in the path tracer vs the raster local-light path:
    same cone/IES/1-over-d2 radiometry, and with rt_shadows both sides
    trace EXACT any-hit occlusion to the lights (RTLocalShadowPass vs the
    tracer's NEE rays). Sun off entirely — local lights are the only
    energy."""
    from arkoserenderer.scene.lights import PointLight, SpotLight

    def make():
        scene, cam = build_flat_test_scene(viewport=(W, H))
        scene.sun = None
        scene.spots.append(SpotLight(
            position=np.array([0.5, 3.5, 1.0], np.float32),
            direction=np.array([-0.15, -1.0, -0.1], np.float32),
            luminous_intensity_cd=220000.0,
            cast_shadows=True,
        ))
        scene.points.append(PointLight(
            position=np.array([-2.0, 2.0, 2.0], np.float32),
            luminous_intensity_cd=90000.0,
            cast_shadows=True,
        ))
        return scene, cam

    scene, cam = make()
    r = Renderer(scene, cam, CFG, rt_shadows=True, taa=False, bloom=False,
                 vignette=0.0)
    raster = np.array(r.render_frame())

    scene2, cam2 = make()
    tr = PathTracer(scene2, cam2, W, H, max_bounces=1, seed=4, aa=False)
    tr.render_sample(1)
    pt = np.array(tr.ldr())

    assert raster.mean() > 0.01  # the lights actually lit the scene
    mask = _edge_mask(raster)
    rel = np.abs(pt - raster).max(-1) / (raster.mean(-1) + 0.02)
    # The scene is deliberately dim (cone-lit), so the relative metric is
    # noisy in near-black pixels; the sharp criterion is the >5% fraction.
    assert rel[mask].mean() < 0.04, f"mean rel {rel[mask].mean():.4f}"
    frac_bad = (rel[mask] > 0.05).mean()
    assert frac_bad < 0.02, f"{frac_bad:.2%} of smooth pixels off by >5%"
