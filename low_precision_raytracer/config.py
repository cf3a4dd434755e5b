"""Configuration system.

The reference has no config files or CLI flags; its three config tiers are
UI-bound (see SURVEY.md §5.6 / `rt/gui/imgui_window.cu:94-100, 735-752`,
`rt/rtrt/cuda.hpp:2161-2168`).  Here they become frozen dataclasses:

- static (pre-load) fields — precision + resolution — select the compiled
  program, exactly like the reference's template instantiation choice;
- dynamic per-frame fields — mix weights, demo toggles — are traced values;
- compile-time constants — MAX_DIRECT_LIGHT=4, max_bounces=2, SVGF sigmas —
  are defaults of the same dataclasses.

Everything is hashable so a RenderConfig can be a `jax.jit` static argument.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# Precision discipline: on a GPU, JAX's DEFAULT precision runs fp32
# matmuls in TF32 (a 10-bit mantissa), which would silently demote the
# pipeline's intentionally-fp32 math (the always-fp32 z-row of the triangle
# test and its fp32 re-test in ops/dense.py, ray transforms, reprojection
# chains).  'highest' keeps those in true fp32; bf16/fp16-input matmuls
# with fp32 accumulation are unaffected.  Low precision in this framework
# is an explicit dtype choice, never an implicit compiler demotion.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and nothing is set here; otherwise the cache lives
# at a fixed path inside the checkout (the path is part of the cache key,
# so a moving directory would never hit).
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compilation_cache_dir() -> str | None:
    """The directory this process caches compiled programs in, or None
    when JAX_COMPILATION_CACHE_DIR already tells JAX where to cache."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT_DIR, ".jax_cache")


_cache_dir = compilation_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


@dataclass(frozen=True)
class Precision:
    """A low-precision rendering policy (the reference's `DataT` template
    parameter, `rt/math/number.hpp:7-130`, promoted to a runtime value).

    delta1/delta2 are the per-operation rounding-error units propagated into
    the ray-triangle error bounds (`rt/rtrt/cuda.hpp:246-248` uses
    2^-10 / 2^-8 for fp16).  bf16 has an 8-bit mantissa (vs fp16's 11), so its
    units are re-derived 8x wider.  fp32 keeps the reference's constants for
    behavioural parity (the reference instantiates the same template with
    the same constants for `float`).
    """

    name: str
    # per-op rounding error units for the dtype triangle test
    delta1: float
    delta2: float
    # ray-AABB precision slop: scene test accepts t1max <= t2min + scene_slop
    # (`rt/rtrt/cuda.hpp:98`), object test accepts t1max <= t2min * object_slop
    # (`rt/rtrt/cuda.hpp:139`)
    scene_aabb_slop: float = 0.02
    object_aabb_slop: float = 1.001953
    # dtype-keyed self-intersection ray origin offset
    # (`rt/rtrt/cuda.hpp:934-942`: 1e-4 fp32 / 1e-1 fp16)
    ray_moveforward_t: float = 1e-4

    @property
    def dtype(self):
        return {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}[
            self.name
        ]

    @property
    def np_dtype(self):
        import ml_dtypes

        return {
            "fp32": np.float32,
            "bf16": ml_dtypes.bfloat16,
            "fp16": np.float16,
        }[self.name]

    @property
    def is_f32(self) -> bool:
        return self.name == "fp32"


FP32 = Precision("fp32", delta1=2.0**-10, delta2=2.0**-8, ray_moveforward_t=1e-4)
FP16 = Precision("fp16", delta1=2.0**-10, delta2=2.0**-8, ray_moveforward_t=1e-1)
BF16 = Precision("bf16", delta1=2.0**-7, delta2=2.0**-5, ray_moveforward_t=1e-1)

_PRECISIONS = {"fp32": FP32, "fp16": FP16, "bf16": BF16}


def get_precision(name: str | Precision) -> Precision:
    if isinstance(name, Precision):
        return name
    return _PRECISIONS[name]


@dataclass(frozen=True)
class SVGFConfig:
    """SVGF denoiser constants (`rt/rtrt/cuda.hpp:1259-1263, 1268`)."""

    sigma_z: float = 1.0
    sigma_n: float = 128.0
    sigma_l: float = 4.0
    eps: float = 1e-5
    # a-trous wavelet iterations run with these strides, ping-ponging buffers;
    # iteration #1's output doubles as next frame's color history
    # (`rt/rtrt/cuda.hpp:1676-1710`)
    strides: tuple[int, ...] = (1, 2, 4, 8, 16)
    # temporal mix weights (`rt/gui/imgui_window.cu:97-98`)
    color_mix_weight: float = 0.1
    moments_mix_weight: float = 0.1
    # frames below this use the spatial (bilateral) moments estimate
    # (`rt/rtrt/cuda.hpp:1271`)
    spatial_moments_below: int = 4
    # Keep the CARRIED temporal state (color history + moments) and the
    # denoiser arithmetic in fp32 even when the render dtype is bf16/fp16.
    # Deliberate deviation from the reference, which stores history in
    # DataT (`rt/rtrt/cuda.hpp:1234-1243`) and pays for it: with bf16
    # state, every frame requantises the history lerp to an 8-bit
    # mantissa, so the accumulator never converges below the mantissa
    # step, which costs dB against a converged ground truth.  The carried
    # planes (and their temporal fetch) double in bytes.  False =
    # reference behaviour (state in the render dtype), kept for the
    # ablation harness.
    state_f32: bool = True


@dataclass(frozen=True)
class DemoSettings:
    """Per-term display toggles (`rt/rtrt/cuda.hpp:2161-2168`)."""

    add_direct_out: bool = True
    add_gi_colored: bool = True
    add_gi_white: bool = True
    demodulate: bool = False
    svgf: bool = True


@dataclass(frozen=True)
class RenderConfig:
    """The full renderer configuration.

    Counterpart of `Renderer<DataT>::Settings` + the compile-time constants
    (`rt/gui/imgui_window.cu:81, 94-100, 356`).
    """

    width: int = 1024
    height: int = 768
    precision: str = "fp32"

    gi_on: bool = True
    # max_bounces=2 hardcoded in the reference's procedure buffer ctor
    # (`rt/gui/imgui_window.cu:356`): a first-round shade plus one GI bounce
    max_bounces: int = 2
    max_direct_lights: int = 4

    svgf: SVGFConfig = SVGFConfig()
    demo: DemoSettings = DemoSettings()
    taa_mix_weight: float = 1.0
    taa_on: bool = True
    # Test hook: run the full TAA path (jittered map build + history blend)
    # even at taa_mix_weight=1, where the renderer normally elides the stage
    # as a bitwise identity.  Lets tests compare elided vs full output.
    taa_force_full: bool = False

    # Shade-stage compute dtype: f32 (default) even in bf16/fp16 modes.
    # Deliberate deviation from the reference's DataT shading: shading
    # error is SYSTEMATIC (the same BRDF/cosine/falloff rounding every
    # frame, which no amount of temporal accumulation washes out) —
    # measured as a converged-mean bias of ~29 dB vs fp32 in bf16 mode,
    # the dominant term of the ground-truth parity gap after the trace
    # geometry fixes.  The low-precision claim lives in the INTERSECTION
    # path, which stays in the render dtype: dtype coefficient tables, the
    # M-shift dtype triangle test, dtype AABB culling.  RNG draws follow
    # the shade dtype (f32 here), like every other shading input.
    # False = reference behaviour for the ablation harness.
    shade_f32: bool = True
    # 'both'  : compute dtype + fp32 triangle tests for every lane and select
    #           by the ambiguity band (exact reference semantics; on a vector
    #           machine all lanes pay both paths)
    # 'dtype' : low-precision test only, widened acceptance band (fast path)
    # 'auto'  : 'both'
    triangle_fallback: str = "auto"
    # traversal implementation (ops/trace.py):
    #   'auto'        : all-pairs for small scenes (dense_triton on a GPU,
    #                   dense elsewhere), BVH walk otherwise
    #   'dense'       : XLA all-pairs path (the plain reference)
    #   'dense_triton': the all-pairs test as one fused GPU kernel
    #   'jax'         : batched lax.while_loop two-level BVH walk
    traversal_impl: str = "auto"
    # triangles per BVH leaf (reference uses 1, `rt/trace/object_bvh.hpp:75`;
    # >1 trades traversal steps for vectorized leaf tests)
    bvh_leaf_size: int = 4
    # device mesh for multi-device rendering (parallel/tiling.py sets this):
    # when present, every trace launch runs under shard_map with rays
    # partitioned over the mesh's pixel axis — per-shard by construction,
    # never GSPMD-replicated.  jax.sharding.Mesh is hashable, so the config
    # stays a valid jit-static argument.
    mesh: object = None

    def __post_init__(self):
        assert self.precision in _PRECISIONS
        assert self.triangle_fallback in ("auto", "both", "dtype")
        assert self.traversal_impl in ("auto", "jax", "dense", "dense_triton")
        assert self.max_bounces >= 1, "max_bounces counts the primary shade round"

    @property
    def prec(self) -> Precision:
        return get_precision(self.precision)

    @property
    def dtype(self):
        return self.prec.dtype

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Skybox ambient colour used by the NO_GI fake-ambient path
# (`rt/rtrt/cuda.hpp:27` — the reference ships it as all-zero)
SKYBOX_COLOR = (0.0, 0.0, 0.0)

# Default "no hit yet" ray parameter (`rt/rtrt/cuda.hpp:54`: t = 1e5)
T_MAX_DEFAULT = 1e5
