"""Low-precision ray-triangle intersection — the novel core
(`CUDARenderGIInput::ray_triangle_intersection`, `rt/rtrt/cuda.hpp:193-413`).

Precomputed per-triangle shear/inverse matrix ``M`` (v2-relative frame, built
at load in fp32, see `models/scene.py:compute_m_matrices`): transforming
``(O - v2, D)`` by the rows of M gives ``(Ox, Dx, Oy, Dy)`` in the render
dtype but ``(Oz, Dz, t)`` **always in fp32** (`rt/rtrt/cuda.hpp:234-240`).
Explicit rounding-error bounds (per-op units delta1/delta2,
`rt/rtrt/cuda.hpp:246-248`) are propagated into ``error_u / error_v``; if a
barycentric coordinate lands inside the error band the test is re-run fully
in fp32 (`:266-328`), otherwise the dtype result widened by the bounds is
accepted (`:330-350`).

On a vector machine there is no warp divergence to exploit, so the default
``fallback='both'`` evaluates both paths for every lane and selects by the
band (exact reference semantics); ``fallback='dtype'`` skips the fp32 path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from low_precision_raytracer.config import Precision


class TriangleHit(NamedTuple):
    accept: jnp.ndarray  # bool
    t: jnp.ndarray  # f32
    u: jnp.ndarray  # f32
    v: jnp.ndarray  # f32


def _mrow_dot(m, row, vec3, dtype):
    """Row-of-M dot product keeping the three partial products (needed for
    the error bounds)."""
    a = (vec3[..., 0] * m[..., row, 0]).astype(dtype)
    b = (vec3[..., 1] * m[..., row, 1]).astype(dtype)
    c = (vec3[..., 2] * m[..., row, 2]).astype(dtype)
    return a, b, c, (a + b + c).astype(dtype)


def ray_triangle(
    o,
    d,
    v2,
    m,
    v2_f32,
    m_f32,
    best_t,
    min_dist,
    max_dist,
    prec: Precision,
    fallback: str = "both",
) -> TriangleHit:
    """Batched M-shift triangle test.

    o, d: (..., 3) local-space ray in the render dtype.
    v2, m: (..., 3) / (..., 3, 3) per-triangle data in the render dtype.
    v2_f32, m_f32: fp32 shadows (may be None when fallback='dtype').
    best_t: (...,) f32 current closest hit (the `intersection.t` compare).
    Returns fp32 (t, u, v) and an accept mask; does NOT update best_t.
    """
    dt = o.dtype
    f32 = jnp.float32

    O = (o - v2).astype(dt)

    ox0, ox1, ox2, Ox = _mrow_dot(m, 0, O, dt)
    dx0, dx1, dx2, Dx = _mrow_dot(m, 0, d, dt)
    oy0, oy1, oy2, Oy = _mrow_dot(m, 1, O, dt)
    dy0, dy1, dy2, Dy = _mrow_dot(m, 1, d, dt)

    # (Oz, Dz, t) always fp32 (`rt/rtrt/cuda.hpp:234-240`)
    Of = O.astype(f32)
    Df = d.astype(f32)
    m2f = m[..., 2, :].astype(f32)
    Oz = Of[..., 0] * m2f[..., 0] + Of[..., 1] * m2f[..., 1] + Of[..., 2] * m2f[..., 2]
    Dz = Df[..., 0] * m2f[..., 0] + Df[..., 1] * m2f[..., 1] + Df[..., 2] * m2f[..., 2]
    inv_dz = 1.0 / Dz
    t = -Oz * inv_dz  # f32

    t_dx = (t * Dx.astype(f32)).astype(dt)
    t_dy = (t * Dy.astype(f32)).astype(dt)
    u = (Ox + t_dx).astype(dt)
    v = (Oy + t_dy).astype(dt)

    # error propagation (`rt/rtrt/cuda.hpp:246-261`), all in the render dtype
    d1 = jnp.asarray(prec.delta1, dt)
    d2 = jnp.asarray(prec.delta2, dt)
    t_dt = t.astype(dt)

    def err3(a, b, c):
        s = jnp.abs(a) + jnp.abs(b) + jnp.abs(c)
        return d1 * s + d2 * s

    e_ox = err3(ox0, ox1, ox2)
    e_dx = err3(dx0, dx1, dx2)
    e_oy = err3(oy0, oy1, oy2)
    e_dy = err3(dy0, dy1, dy2)
    point2 = jnp.asarray(0.2, dt)
    three = jnp.asarray(3.0, dt)
    error_u = (e_ox + t_dt * e_dx + d1 * (jnp.abs(Ox) + three * jnp.abs(t_dx))) * point2
    error_v = (e_oy + t_dt * e_dy + d1 * (jnp.abs(Oy) + three * jnp.abs(t_dy))) * point2

    valid_t = (t > min_dist) & (t < best_t) & (t < max_dist)

    w = (jnp.asarray(1.0, dt) - u - v).astype(dt)
    zero = jnp.asarray(0.0, dt)
    in_band = lambda x, e: (x >= -e) & (x <= zero)
    ambiguous = (
        in_band(u, error_u) | in_band(v, error_v) | in_band(w, error_v + error_u)
    )
    dtype_accept = (
        (u > -error_u)
        & (v > -error_v)
        & (u + v < jnp.asarray(1.0, dt) + error_u + error_v)
    )

    if fallback == "dtype":
        accept = valid_t & dtype_accept
        uf = u.astype(f32)
        vf = v.astype(f32)
        return TriangleHit(accept, t, uf, vf)

    # full fp32 re-test (`rt/rtrt/cuda.hpp:266-328`): widens the *dtype-space*
    # local ray, exactly like the reference (ray.source is DataT there too)
    O32 = o.astype(f32) - v2_f32
    D32 = d.astype(f32)
    m0f = m_f32[..., 0, :]
    m1f = m_f32[..., 1, :]
    m2f32 = m_f32[..., 2, :]
    dot3 = lambda a, b: a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    Ox32 = dot3(O32, m0f)
    Dx32 = dot3(D32, m0f)
    Oy32 = dot3(O32, m1f)
    Dy32 = dot3(D32, m1f)
    Oz32 = dot3(O32, m2f32)
    Dz32 = dot3(D32, m2f32)
    t32 = -Oz32 / Dz32
    u32 = Ox32 + t32 * Dx32
    v32 = Oy32 + t32 * Dy32
    valid32 = (
        (t32 > min_dist)
        & (t32 < best_t)
        & (t32 < max_dist)
        & (u32 > 0)
        & (v32 > 0)
        & (u32 + v32 < 1)
    )

    accept = jnp.where(
        ambiguous, valid_t & valid32, valid_t & dtype_accept
    )
    t_out = jnp.where(ambiguous, t32, t)
    u_out = jnp.where(ambiguous, u32, u.astype(f32))
    v_out = jnp.where(ambiguous, v32, v.astype(f32))
    return TriangleHit(accept, t_out, u_out, v_out)
