"""Temporal anti-aliasing (`temporal_anti_aliasing`,
`rt/rtrt/cuda.hpp:2418-2439`): history blend through the jittered TAA
temporal map with NaN laundering."""

from __future__ import annotations

import jax.numpy as jnp

from low_precision_raytracer.math.vec import value_or
from low_precision_raytracer.ops.reproject import sample_linear


def temporal_anti_aliasing(color, history, taa_map, taa_weight, hist_pre=None):
    dt = color.dtype
    if hist_pre is not None:
        # finished weighted fetch (reproject.fetch_weighted semantics)
        h = hist_pre.astype(dt)
        hist = jnp.where((taa_map["frame_count"] > 0)[..., None], h, color)
    else:
        hist = sample_linear(taa_map, history, color)
    hist = value_or(hist, color)
    w = jnp.asarray(taa_weight, dt)
    return hist * (1 - w) + color * w
