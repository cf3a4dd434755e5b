"""Importance sampling helpers (`rt/rtrt/cuda.hpp:1713-1749`, Blender-derived).

Deviation from the reference, by design: the reference's `sample_ggx` feeds
two raw uniforms straight into (x, y) = (r*u2, r*u3), which is a sampling bug
(azimuth is non-uniform and the vector is not unit before the pdf is taken
from its z).  We sample the azimuth correctly with (cos, sin)(2*pi*u2); the
pdf formula is unchanged and is now actually consistent with the sample.
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_ggx(a2, u1, u2):
    """GGX half-vector sample in tangent space (z = cos theta).

    a2: alpha^2 = roughness^4.  u1, u2 ~ U(0, 1).
    """
    dt = u1.dtype
    one = jnp.asarray(1.0, dt)
    # cancellation-free denominator (1 - u1) + a2*u1 (mathematically
    # 1 + (a2-1)*u1): in bf16 the naive form rounds fl(1 + a2*u1) to 1 for
    # a2 < 2^-9, making z == 1 for EVERY sample — glossy metals in the
    # roughness band [0.1, 0.21) would render as perfect mirrors (same
    # cancellation class as d_ggx_opti below)
    z = jnp.sqrt((one - u1) / ((one - u1) + a2 * u1))  # cos theta
    r = jnp.sqrt(jnp.maximum(0.0, one - z * z).astype(dt))  # sin theta
    phi = jnp.asarray(2.0 * jnp.pi, dt) * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    return jnp.stack([x, y, z], axis=-1)


def d_ggx_opti(nh, a2):
    """`D_ggx_opti` (`rt/rtrt/cuda.hpp:1726-1729`): pi * tmp^2 with
    tmp = (NH*a2 - NH)*NH + 1 — computed in the cancellation-free form
    (1 - NH^2) + NH^2*a2: in bf16 the reference's form rounds to 0 at
    NH = 1 for a2 < 2^-9 (8-bit mantissa), blowing the pdf up to Inf."""
    nh2 = nh * nh
    tmp = (1.0 - nh2) + nh2 * a2
    return jnp.asarray(jnp.pi, nh.dtype) * tmp * tmp


def pdf_ggx_reflect(nh, a2):
    """`pdf_ggx_reflect` (`rt/rtrt/cuda.hpp:1731-1734`)."""
    return nh * a2 / d_ggx_opti(nh, a2)


def tangent_to_world(vec, n, t, b):
    """`tangent_to_world` (`rt/rtrt/cuda.hpp:1736-1740`)."""
    return (
        t * vec[..., 0:1] + b * vec[..., 1:2] + n * vec[..., 2:3]
    )


def uniform_hemisphere_trig(normal, tangent, bitangent, u1, u2):
    """Uniform hemisphere direction from TWO uniforms in an existing
    orthonormal frame: z = u1 (uniform cos theta IS uniform area on the
    hemisphere), phi = 2*pi*u2.  Same law as the reference's normalized-
    gaussian sampler (`rt/rtrt/cuda.hpp:1920-1931`), but no
    gaussians: threefry `normal()` draws pay erfinv chains and 1.5x the
    bits, where uniforms are nearly free.  The frame
    may be built around the UNFLIPPED normal — tangent/bitangent stay
    orthogonal to a negated n, so the hemisphere is still correct.
    Returns (dir, cosine = z)."""
    dt = normal.dtype
    z = u1.astype(dt)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z).astype(dt))
    phi = jnp.asarray(2.0 * jnp.pi, dt) * u2.astype(dt)
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    v = (
        tangent * x[..., None]
        + bitangent * y[..., None]
        + normal * z[..., None]
    )
    return v, z


def direction_to_spherical(d, offset_x, offset_y):
    """Equirectangular direction -> uv (`direction_to_spherical`,
    `rt/rtrt/cuda.hpp:1742-1749`), always fp32."""
    f32 = jnp.float32
    dx = d[..., 0].astype(f32)
    dy = d[..., 1].astype(f32)
    dz = jnp.clip(d[..., 2].astype(f32), -1.0, 1.0)
    u = 0.1591 * jnp.arctan2(dy, dx) + 0.5 + jnp.asarray(offset_x, f32)
    v = 0.3183 * jnp.arcsin(dz) + 0.5 + jnp.asarray(offset_y, f32)
    u = jnp.mod(u, 1.0)
    v = 1.0 - jnp.mod(v, 1.0)
    return u, v
