"""arkoserenderer — a real-time rendering framework in JAX, run on a GPU.

A from-scratch reimagining of the capabilities of Shimmen/ArkoseRenderer
(C++/Vulkan) as array programs: the render-graph of passes becomes a
jit-traced pass DAG over device-resident frame-state tensors,
rasterization / texture sampling / ray traversal / image kernels are XLA
programs (the tile raster a Pallas kernel on the GPU), and the scene layer
is a set of fixed-capacity SoA device arrays.

Layer map (mirrors reference layers, see SURVEY.md §1):
  core/       — logging, flags, math, low-discrepancy sequences   (≈ arkcore/core)
  assets/     — glTF import, images, meshlets, procedural scenes  (≈ arkcore/asset)
  scene/      — Camera, lights, Scene → SceneArrays               (≈ arkose/scene)
  rendering/  — FrameGraph, Registry, render passes               (≈ arkose/rendering)
  ops/        — rasterizer, sampler, BRDF, post kernels           (≈ arkose/shaders + backend)
  parallel/   — device mesh + pixel-band sharding over several GPUs
  utils/      — timing, image IO
"""

__version__ = "0.1.0"
