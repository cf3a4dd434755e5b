"""BRDF library (`rt/rtrt/bsdf.hpp`).

glTF-2.0-spec metallic-roughness BRDF split into a ``(colored, white)``
scalar pair — the albedo demodulation that makes SVGF-after-demodulation
work (SURVEY.md 2.11).  The final reflectance for a base colour ``c`` is
``c * colored + white`` (`BRDF::get_brdf`, `rt/rtrt/bsdf.hpp:52-54`).

All functions are elementwise over (...,) lanes in the render dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from low_precision_raytracer.math.vec import dot, normalize


class BRDF(NamedTuple):
    colored: jnp.ndarray  # (...,)
    white: jnp.ndarray  # (...,)

    def get_brdf(self, base_color):
        """base_color * colored + white (`rt/rtrt/bsdf.hpp:52-54`)."""
        return base_color * self.colored[..., None] + self.white[..., None]


def specular_brdf(V, H, L, N, alpha):
    """GGX NDF x height-correlated Smith visibility
    (`specularBRDF`, `rt/rtrt/bsdf.hpp:12-33`)."""
    dt = V.dtype
    hl = dot(H, L)
    hv = dot(H, V)
    nh = dot(N, H)
    anl = jnp.abs(dot(N, L))
    anv = jnp.abs(dot(N, V))
    a2 = alpha * alpha
    one = jnp.asarray(1.0, dt)
    div1 = anl + jnp.sqrt(jnp.maximum(0.0, a2 + (one - a2) * anl * anl).astype(dt))
    div2 = anv + jnp.sqrt(jnp.maximum(0.0, a2 + (one - a2) * anv * anv).astype(dt))
    # NDF denominator in the cancellation-free form (1 - nh^2) + nh^2*a2
    # (mathematically = nh^2*(a2-1) + 1, `rt/rtrt/bsdf.hpp:12-33`): in bf16
    # the reference's form rounds (a2 - 1) to exactly -1 for a2 < 2^-9, so
    # at nh = 1 the denominator cancels to 0 and d_val goes Inf, poisoning
    # the metallic mix with Inf*0 = NaN.  All terms here are non-negative —
    # at nh = 1 it computes a2 exactly in any dtype.
    nh2 = nh * nh
    denom = (one - nh2) + nh2 * a2
    d_val = a2 / (jnp.asarray(jnp.pi, dt) * jnp.maximum(denom * denom, jnp.asarray(1e-12, dt)))
    # div1/div2 can be exactly 0 at alpha = 0 when a sample lands in the
    # tangent plane (bf16 rounds the N.L dot to 0): clamp like denom so
    # 0/0 never mints a NaN the bad-mask below cannot catch
    eps = jnp.asarray(1e-12, dt)
    out = d_val / jnp.maximum(div1, eps) / jnp.maximum(div2, eps)
    bad = (nh <= 0) | (hl <= 0) | (hv <= 0)
    return jnp.where(bad, jnp.asarray(0.0, dt), out)


def material_brdf(metallic, roughness, V, L, N) -> BRDF:
    """Dielectric (f0=0.04 Schlick + Lambert/pi) + metal GGX mix
    (`material_brdf`, `rt/rtrt/bsdf.hpp:57-97`)."""
    dt = V.dtype
    one = jnp.asarray(1.0, dt)
    H = normalize(L + V)
    vh = dot(V, H)
    pow5 = jnp.maximum(0.0, one - jnp.abs(vh)).astype(dt) ** 5
    alpha = roughness * roughness
    layer = specular_brdf(V, H, L, N, alpha)

    f0 = jnp.asarray(0.04, dt)
    dielectric_fr = f0 + (one - f0) * pow5
    dielectric_white = dielectric_fr * layer
    dielectric_colored = (one - dielectric_fr) * jnp.asarray(1.0 / jnp.pi, dt)

    metal_white = layer * pow5
    metal_colored = layer * (one - pow5)

    colored = metal_colored * metallic + dielectric_colored * (one - metallic)
    white = metal_white * metallic + dielectric_white * (one - metallic)

    back = dot(L, N) < 0
    zero = jnp.asarray(0.0, dt)
    return BRDF(jnp.where(back, zero, colored), jnp.where(back, zero, white))


def glassy_brdf(metallic, V, L, N) -> BRDF:
    """Mirror-bounce BRDF for the russian-roulette glassy lobe
    (`glassy_brdf`, `rt/rtrt/bsdf.hpp:106-139`)."""
    dt = V.dtype
    one = jnp.asarray(1.0, dt)
    H = normalize(L + V)
    vh = dot(V, H)
    pow5 = jnp.maximum(0.0, one - jnp.abs(vh)).astype(dt) ** 5

    f0 = jnp.asarray(0.04, dt)
    dielectric_white = f0 + (one - f0) * pow5
    metal_white = pow5
    metal_colored = one - pow5

    colored = metal_colored * metallic
    white = metal_white * metallic + dielectric_white * (one - metallic)

    back = dot(L, N) < 0
    zero = jnp.asarray(0.0, dt)
    return BRDF(jnp.where(back, zero, colored), jnp.where(back, zero, white))
