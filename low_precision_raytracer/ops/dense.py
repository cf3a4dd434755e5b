"""Dense (BVH-free) ray-scene intersection for small scenes: the plain XLA
reference of the all-pairs route, and the route on backends without a GPU
(ops/dense_triton.py runs the same test as one fused GPU kernel).

The reference's M-shift triangle test (`rt/rtrt/cuda.hpp:205-240`)
transforms the ray into object space and dots it with per-triangle matrix
rows.  Folding each instance's world->local affine into the rows once per
frame (host precompute, `models/scene.py:_dense_coefficients`) turns the
whole two-level query into

    Ox = o_w @ n0 + e0,   Dx = d_w @ n0      (and rows 1, 2)

over ALL instance-triangles at once — a single ``(R, 3) @ (3, TI)`` matmul
chain per row: zero gathers, zero control flow.  bf16/fp16 coefficient rows
with fp32 accumulation realise the "low-precision trace with fp32
accumulation" design; the z row (t) always uses fp32 coefficients
(`rt/rtrt/cuda.hpp:234-240`).  The ambiguous-band fp32 re-test, skip
geometry, min/max distance and closest-hit semantics match the traversal
backend.  Rays are processed in chunks to bound the (chunk, TI) working set.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import Precision
from low_precision_raytracer.ops.traversal import Hit

F32 = jnp.float32

# rays per chunk: bounds the (chunk, TI) intermediates in device memory
CHUNK = 32768


def _mm(a, b):
    """Low-precision-input matmul with fp32 accumulation."""
    return jnp.dot(a, b, preferred_element_type=F32)


def _mm_f32(a, b):
    """Full-fp32 matmul.  Precision.HIGHEST is required: JAX's DEFAULT runs
    fp32 matmuls in TF32 on a GPU (a 10-bit mantissa), which would silently
    demote the always-fp32 z-row (`rt/rtrt/cuda.hpp:234-240`) and the fp32
    fallback path."""
    return jnp.dot(
        a, b, preferred_element_type=F32, precision=jax.lax.Precision.HIGHEST
    )


def _mm_bound(a, b):
    """Error-BOUND matmul: explicit DEFAULT precision, opting out of the
    global HIGHEST the config pins.  On a GPU that is TF32 for fp32 inputs
    (about three decimal digits), which is enough for a conservative bound
    that is scaled by the 0.2 fudge factor anyway."""
    return jnp.dot(
        a, b, preferred_element_type=F32, precision=jax.lax.Precision.DEFAULT
    )


def quantize(x, dt):
    """Round f32 values to the render dtype `dt`, kept as f32.  Written as
    an explicit reduce_precision: XLA on a GPU may drop an f32 -> dt -> f32
    convert pair as excess precision, which would leave the f32 rows of the
    test reading the unquantised ray while the dtype rows read the
    quantised one."""
    x = x.astype(F32)
    if dt == F32:
        return x
    fi = jnp.finfo(dt)
    return jax.lax.reduce_precision(x, exponent_bits=fi.nexp, mantissa_bits=fi.nmant)


def trace_rays_dense(
    scene,
    frame,
    origins,
    directions,
    *,
    prec: Precision,
    fallback: str = "both",
    skip_tri=None,
    min_dist=0.0,
    max_dist=1e5,
    find_any: bool = False,  # no early-out in dense mode; same result
) -> Hit:
    """All-pairs closest hit over every object instance.  Shapes: (R, 3) in."""
    assert frame.dense_n is not None, (
        "dense backend needs FrameInput dense coefficients (scene too large?)"
    )
    dt = prec.dtype
    R = origins.shape[0]
    min_dist = jnp.broadcast_to(jnp.asarray(min_dist, F32), (R,))
    max_dist = jnp.broadcast_to(jnp.asarray(max_dist, F32), (R,))
    if skip_tri is None:
        skip_tri = jnp.full((R,), -1, jnp.int32)

    c = frame.dense_center
    o_sh = quantize(origins.astype(F32) - c, dt).astype(dt)
    d_w = quantize(directions, dt).astype(dt)

    TI = frame.dense_n.shape[0]
    n_dt = frame.dense_n.reshape(TI, 9)
    n_f32 = frame.dense_n_f32.reshape(TI, 9)
    e_f32 = frame.dense_e
    tri_ids = frame.dense_tri
    obj_ids = frame.dense_obj

    d1 = jnp.asarray(prec.delta1, F32)
    d2 = jnp.asarray(prec.delta2, F32)
    d12 = d1 + d2

    n0 = n_dt[:, 0:3].T  # (3, TI) dtype
    n1 = n_dt[:, 3:6].T
    n2f = n_f32[:, 6:9].T  # z row always fp32
    a0 = jnp.abs(n0)
    a1 = jnp.abs(n1)

    def chunk_fn(args):
        o_c, d_c, skip_c, mind_c, maxd_c = args
        mm = _mm_f32 if prec.is_f32 else _mm
        Ox = mm(o_c, n0) + e_f32[:, 0]
        Dx = mm(d_c, n0)
        Oy = mm(o_c, n1) + e_f32[:, 1]
        Dy = mm(d_c, n1)
        Oz = _mm_f32(o_c.astype(F32), n2f) + e_f32[:, 2]
        Dz = _mm_f32(d_c.astype(F32), n2f)

        t = -Oz / Dz
        t_dx = t * Dx
        t_dy = t * Dy
        u = Ox + t_dx
        v = Oy + t_dy

        # error bounds on sum-of-|partials| (abs matmuls, conservative) —
        # single-pass DEFAULT precision even in fp32 mode (_mm_bound): the
        # exact 6-pass fp32 decomposition buys nothing for a fudge-scaled
        # bound and costs ~6x on 4 of the ~10 matmuls per chunk
        s_ox = _mm_bound(jnp.abs(o_c), a0) + jnp.abs(e_f32[:, 0])
        s_dx = _mm_bound(jnp.abs(d_c), a0)
        s_oy = _mm_bound(jnp.abs(o_c), a1) + jnp.abs(e_f32[:, 1])
        s_dy = _mm_bound(jnp.abs(d_c), a1)
        error_u = (d12 * s_ox + t * d12 * s_dx + d1 * (jnp.abs(Ox) + 3 * jnp.abs(t_dx))) * 0.2
        error_v = (d12 * s_oy + t * d12 * s_dy + d1 * (jnp.abs(Oy) + 3 * jnp.abs(t_dy))) * 0.2

        w = 1.0 - u - v
        in_band = lambda x, e: (x >= -e) & (x <= 0)
        ambiguous = (
            in_band(u, error_u) | in_band(v, error_v) | in_band(w, error_u + error_v)
        )
        dtype_accept = (u > -error_u) & (v > -error_v) & (u + v < 1 + error_u + error_v)

        if fallback == "both" and not prec.is_f32:
            of = o_c.astype(F32)
            df = d_c.astype(F32)
            n0f = n_f32[:, 0:3].T
            n1f = n_f32[:, 3:6].T
            Ox32 = _mm_f32(of, n0f) + e_f32[:, 0]
            Dx32 = _mm_f32(df, n0f)
            Oy32 = _mm_f32(of, n1f) + e_f32[:, 1]
            Dy32 = _mm_f32(df, n1f)
            t32 = t  # z row is already fp32
            u32 = Ox32 + t32 * Dx32
            v32 = Oy32 + t32 * Dy32
            ok32 = (u32 > 0) & (v32 > 0) & (u32 + v32 < 1)
            t_sel = t
            u_sel = jnp.where(ambiguous, u32, u)
            v_sel = jnp.where(ambiguous, v32, v)
            accept_geom = jnp.where(ambiguous, ok32, dtype_accept)
        elif fallback == "both":
            strict = (u > 0) & (v > 0) & (u + v < 1)
            t_sel, u_sel, v_sel = t, u, v
            accept_geom = jnp.where(ambiguous, strict, dtype_accept)
        else:
            t_sel, u_sel, v_sel = t, u, v
            accept_geom = dtype_accept

        accept = (
            accept_geom
            & (t_sel > mind_c[:, None])
            & (t_sel < maxd_c[:, None])
            & (tri_ids[None, :] != skip_c[:, None])
            & jnp.isfinite(t_sel)
        )

        t_masked = jnp.where(accept, t_sel, jnp.inf)
        k = jnp.argmin(t_masked, axis=1)
        tk = jnp.take_along_axis(t_masked, k[:, None], axis=1)[:, 0]
        hit = jnp.isfinite(tk)
        uk = jnp.take_along_axis(u_sel, k[:, None], axis=1)[:, 0]
        vk = jnp.take_along_axis(v_sel, k[:, None], axis=1)[:, 0]
        return (
            jnp.where(hit, tk, 1e5),
            jnp.where(hit, uk, 0.0),
            jnp.where(hit, vk, 0.0),
            jnp.where(hit, tri_ids[k], -1),
            jnp.where(hit, obj_ids[k], -1),
        )

    if R <= CHUNK:
        t, u, v, tri, obj = chunk_fn((o_sh, d_w, skip_tri, min_dist, max_dist))
        return Hit(t=t, u=u, v=v, tri=tri, obj=obj)

    pad = (-R) % CHUNK
    def padded(x, fill=0):
        return jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)])

    nc = (R + pad) // CHUNK
    chunks = (
        padded(o_sh).reshape(nc, CHUNK, 3),
        padded(d_w, 1).reshape(nc, CHUNK, 3),
        padded(skip_tri, -1).reshape(nc, CHUNK),
        padded(min_dist).reshape(nc, CHUNK),
        padded(max_dist).reshape(nc, CHUNK),
    )
    t, u, v, tri, obj = jax.lax.map(chunk_fn, chunks)
    flat = lambda x: x.reshape(-1)[:R]
    return Hit(t=flat(t), u=flat(u), v=flat(v), tri=flat(tri), obj=flat(obj))
