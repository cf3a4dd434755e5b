"""Colour composition + tonemap (`rt/rtrt/cuda.hpp:2161-2228, 2441-2455`)."""

from __future__ import annotations

import jax.numpy as jnp

from low_precision_raytracer.config import DemoSettings


def write_clean_color(intensity0, intensity1, gi_multiplier0, demo: DemoSettings):
    """`write_clean_color` (`rt/rtrt/cuda.hpp:2170-2199`).

    The NaN tag in gi_multiplier0[..., 2] selects the demodulated path:
    tagged pixels route bounce light into the (colored, white) SVGF inputs;
    untagged (mirror russian-roulette) pixels add it directly.

    Returns (clean_color, mul_gi_colored, mul_gi_white).
    """
    dt = intensity0.dtype
    zero = jnp.zeros_like(intensity0)
    final = intensity0 if demo.add_direct_out else zero

    tagged = jnp.isnan(gi_multiplier0[..., 2])
    mul_gi_colored = jnp.where(
        tagged[..., None], gi_multiplier0[..., 0:1] * intensity1, zero
    ).astype(dt)
    mul_gi_white = jnp.where(
        tagged[..., None], gi_multiplier0[..., 1:2] * intensity1, zero
    ).astype(dt)
    if demo.add_direct_out:
        final = final + jnp.where(
            tagged[..., None], zero, intensity1 * gi_multiplier0
        )
    return final.astype(dt), mul_gi_colored, mul_gi_white


def add_denoised_color(clean, mul_gi_colored, mul_gi_white, albedo, demo: DemoSettings):
    """`add_denoised_color` (`rt/rtrt/cuda.hpp:2201-2228`): re-modulate."""
    a = jnp.ones_like(albedo) if demo.demodulate else albedo
    out = clean
    if demo.add_gi_colored:
        out = out + mul_gi_colored * a
    if demo.add_gi_white:
        out = out + mul_gi_white
    return out


def tonemap_gamma(color):
    """gamma 1/2.2 encode (`write_to_surface2d`, `rt/rtrt/cuda.hpp:2441-2455`),
    fp32 output clamped to [0, 1]."""
    c = jnp.clip(color.astype(jnp.float32), 0.0, None)
    return jnp.clip(c ** (1.0 / 2.2), 0.0, 1.0)
