from arkoserenderer.rendering.passes.scenepass import ScenePass  # noqa: F401
from arkoserenderer.rendering.passes.geometry import GeometryPass  # noqa: F401
from arkoserenderer.rendering.passes.shadow import SunShadowPass  # noqa: F401
from arkoserenderer.rendering.passes.shading import VisibilityShadingPass  # noqa: F401
from arkoserenderer.rendering.passes.sky import SkyPass  # noqa: F401
from arkoserenderer.rendering.passes.taa import TAAPass  # noqa: F401
from arkoserenderer.rendering.passes.bloom import BloomPass  # noqa: F401
from arkoserenderer.rendering.passes.output import OutputPass  # noqa: F401
from arkoserenderer.rendering.passes.post import (  # noqa: F401
    CASPass,
    DepthOfFieldPass,
    FXAAPass,
    FogPass,
    LightingComposePass,
    MotionBlurPass,
    SSAOPass,
)
