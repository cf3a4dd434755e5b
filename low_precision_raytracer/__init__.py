"""low_precision_raytracer — a low-precision real-time ray tracer in JAX.

A JAX/XLA/Pallas framework with the capabilities of the CUDA/OpenGL
reference `ioissss/Low-precision-raytracer`:

- glTF 2.0 scene pipeline (meshes, metallic-roughness PBR materials, TRS
  animations, lights, cameras)            -> :mod:`.models`
- two-level BVH with stackless traversal and the low-precision (bf16/fp16)
  ray-triangle intersection with explicit error bounds + fp32 fallback
                                          -> :mod:`.ops`
- wavefront trace/shade path tracer with GGX importance sampling, skybox IBL,
  SVGF denoiser (temporal reprojection + a-trous wavelet filter) and TAA
                                          -> :mod:`.render`
- multi-device pixel-tile scaling over a `jax.sharding.Mesh`
                                          -> :mod:`.parallel`

Precision is a first-class switch: one kernel source runs in fp32, bf16 or
fp16 with fp32 accumulation at the numerically critical spots (mirrors the
reference's single templated kernel source instantiated for float/float16,
`rt/gui/imgui_window.cu:746-752`).
"""

from low_precision_raytracer.config import (
    BF16,
    FP16,
    FP32,
    DemoSettings,
    Precision,
    RenderConfig,
    SVGFConfig,
    get_precision,
)

__version__ = "0.1.0"

__all__ = [
    "BF16",
    "FP16",
    "FP32",
    "DemoSettings",
    "Precision",
    "RenderConfig",
    "SVGFConfig",
    "get_precision",
    "__version__",
]
