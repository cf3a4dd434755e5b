"""Low-precision dtype helpers.

The reference stores BVH AABBs computed in fp32 "as DataT"
(`rt/trace/object_bvh.hpp:99-100`) with round-to-nearest, compensating the
shrinkage with traversal-time slop constants.  Here we additionally widen
AABBs *conservatively* at cast time (round lower bounds down, upper bounds
up), per SURVEY.md 2.3, so a bf16 AABB always contains its fp32 original.
"""

from __future__ import annotations

import numpy as np


def _next_down_bits(dtype, bits_dtype):
    """Return a function mapping dtype arrays to the next representable value
    toward -inf, via integer bit manipulation (works for bf16/fp16)."""

    def f(x):
        x = np.asarray(x, dtype)
        b = x.view(bits_dtype)
        # For positive values (and +0): decrement bits.  For negative: increment.
        is_neg = (x < 0) | ((x == 0) & (np.signbit(x)))
        stepped = np.where(is_neg, b + 1, b - 1)
        # exact zero (positive) steps to smallest negative subnormal
        neg_sub = np.array(-0.0, dtype).view(bits_dtype) + 1
        stepped = np.where((x == 0) & (~np.signbit(x)), neg_sub, stepped)
        return stepped.astype(bits_dtype).view(dtype)

    return f


def cast_round_down(x, np_dtype):
    """Cast fp32 -> np_dtype rounding toward -inf."""
    x = np.asarray(x, np.float32)
    if np_dtype == np.float32:
        return x
    y = x.astype(np_dtype)
    too_big = y.astype(np.float32) > x
    bits = np.uint16
    down = _next_down_bits(np_dtype, bits)(y)
    return np.where(too_big, down, y).astype(np_dtype)


def cast_round_up(x, np_dtype):
    """Cast fp32 -> np_dtype rounding toward +inf."""
    x = np.asarray(x, np.float32)
    if np_dtype == np.float32:
        return x
    return -cast_round_down(-x, np_dtype)


def widen_aabb(lo, hi, np_dtype):
    """Conservatively cast an fp32 AABB to np_dtype."""
    return cast_round_down(lo, np_dtype), cast_round_up(hi, np_dtype)
