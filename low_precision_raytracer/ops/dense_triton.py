"""Dense all-pairs closest hit as one fused GPU kernel (Pallas, Triton route).

Same test and same answers as the plain reference `ops/dense.py`: the
M-shift triangle test with world-space coefficient rows
(`models/scene.py:_dense_coefficients`), dtype x/y rows with an fp32 z row
(`rt/rtrt/cuda.hpp:205-240`), the conservative error band, the fp32
re-test inside the band (`fallback='both'`), skip/min/max distance, and
closest-hit selection with ties to the lowest table row (`jnp.argmin`).

Why a kernel: the reference forms every (ray, triangle) plane of the test
from K=3 matrix products.  On a GPU those products run as GEMM kernels
whose outputs are not fused into the later argmin, so each (rays x
triangles) f32 plane goes to device memory and back.  Here one program
owns BR rays, loads them once (tail-masked: no padding of the launch),
walks the triangle table in BT-column blocks with a `fori_loop`
(`num_stages` pipelines the table loads), and keeps a running
(t, u, v, row) winner per (ray, column) in registers; one reduction over
the columns and one store per ray end it.  The table (~72 B per
instance-triangle) stays in L2.

Arithmetic: dtype operands are cast to f32 before the products.  A product
of two bf16 or two fp16 values is exact in f32, so only the order of the
3-term sums differs from the reference's matmuls.  The z row and the band
re-test use the f32 rows.  Tensor cores have nothing to do here: every
product has K = 3, so the kernel runs on the CUDA cores' f32 FMA units.

There is no interpret-mode fallback in production: `interpret=True` is for
tests on the CPU, and a GPU-less backend without it is an error.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from low_precision_raytracer.config import Precision
from low_precision_raytracer.ops.dense import quantize
from low_precision_raytracer.ops.traversal import Hit

F32 = jnp.float32

BLOCK_RAYS = 64
BLOCK_TRIS = 16
NUM_WARPS = 4
NUM_STAGES = 2

# first rows of the per-launch (rows, TI) f32 coefficient table: dtype x/y
# rows (6), f32 z row + offsets (6), f32 x/y rows of the band re-test (6)
_XY, _ZE, _XY32 = 0, 6, 12
_BIG_ROW = 2**31 - 1


def _kernel(rays_ref, skip_ref, tab_ref, tri_ref, t_ref, u_ref, v_ref, row_ref, *,
            n_rays, n_tris, br, bt, low, fallback, d1, d2):
    i = pl.program_id(0)
    rmask = i * br + jnp.arange(br) < n_rays

    def ray(k):
        x = plgpu.load(rays_ref.at[k, pl.ds(i * br, br)], mask=rmask, other=0.0)
        return x[:, None]

    ox, oy, oz, dx, dy, dz, mind, maxd = (ray(k) for k in range(8))
    skip = plgpu.load(skip_ref.at[pl.ds(i * br, br)], mask=rmask, other=-1)[:, None]
    aox, aoy, aoz = jnp.abs(ox), jnp.abs(oy), jnp.abs(oz)
    adx, ady, adz = jnp.abs(dx), jnp.abs(dy), jnp.abs(dz)
    d12 = d1 + d2

    def body(j, carry):
        best_t, best_u, best_v, best_row = carry
        cols = j * bt + jnp.arange(bt)
        cmask = cols < n_tris

        def tab(k):
            x = plgpu.load(tab_ref.at[k, pl.ds(j * bt, bt)], mask=cmask, other=0.0)
            return x[None, :]

        n00, n01, n02, n10, n11, n12 = (tab(_XY + k) for k in range(6))
        n20, n21, n22, e0, e1, e2 = (tab(_ZE + k) for k in range(6))
        tri = plgpu.load(tri_ref.at[pl.ds(j * bt, bt)], mask=cmask, other=-1)[None, :]

        Ox = ox * n00 + oy * n01 + oz * n02 + e0
        Dx = dx * n00 + dy * n01 + dz * n02
        Oy = ox * n10 + oy * n11 + oz * n12 + e1
        Dy = dx * n10 + dy * n11 + dz * n12
        Oz = ox * n20 + oy * n21 + oz * n22 + e2
        Dz = dx * n20 + dy * n21 + dz * n22
        t = -Oz / Dz
        t_dx = t * Dx
        t_dy = t * Dy
        u = Ox + t_dx
        v = Oy + t_dy

        a00, a01, a02 = jnp.abs(n00), jnp.abs(n01), jnp.abs(n02)
        a10, a11, a12 = jnp.abs(n10), jnp.abs(n11), jnp.abs(n12)
        s_ox = aox * a00 + aoy * a01 + aoz * a02 + jnp.abs(e0)
        s_dx = adx * a00 + ady * a01 + adz * a02
        s_oy = aox * a10 + aoy * a11 + aoz * a12 + jnp.abs(e1)
        s_dy = adx * a10 + ady * a11 + adz * a12
        err_u = (d12 * s_ox + t * d12 * s_dx
                 + d1 * (jnp.abs(Ox) + 3 * jnp.abs(t_dx))) * 0.2
        err_v = (d12 * s_oy + t * d12 * s_dy
                 + d1 * (jnp.abs(Oy) + 3 * jnp.abs(t_dy))) * 0.2
        dtype_accept = (u > -err_u) & (v > -err_v) & (u + v < 1 + err_u + err_v)
        if fallback == "both":
            w = 1.0 - u - v
            ambiguous = (
                ((u >= -err_u) & (u <= 0))
                | ((v >= -err_v) & (v <= 0))
                | ((w >= -(err_u + err_v)) & (w <= 0))
            )
            if low:
                f00, f01, f02, f10, f11, f12 = (tab(_XY32 + k) for k in range(6))
                u32 = (ox * f00 + oy * f01 + oz * f02 + e0) + t * (
                    dx * f00 + dy * f01 + dz * f02)
                v32 = (ox * f10 + oy * f11 + oz * f12 + e1) + t * (
                    dx * f10 + dy * f11 + dz * f12)
                ok32 = (u32 > 0) & (v32 > 0) & (u32 + v32 < 1)
                u = jnp.where(ambiguous, u32, u)
                v = jnp.where(ambiguous, v32, v)
                accept = jnp.where(ambiguous, ok32, dtype_accept)
            else:
                strict = (u > 0) & (v > 0) & (u + v < 1)
                accept = jnp.where(ambiguous, strict, dtype_accept)
        else:
            accept = dtype_accept

        accept = (
            accept & (t > mind) & (t < maxd) & (tri != skip)
            & jnp.isfinite(t) & cmask[None, :]
        )
        # strict '<': within a column, rows arrive in increasing order, so
        # the earliest of equal-t rows stays
        better = accept & (t < best_t)
        return (
            jnp.where(better, t, best_t),
            jnp.where(better, u, best_u),
            jnp.where(better, v, best_v),
            jnp.where(better, cols[None, :], best_row),
        )

    init = (
        jnp.full((br, bt), jnp.inf, F32),
        jnp.zeros((br, bt), F32),
        jnp.zeros((br, bt), F32),
        jnp.full((br, bt), _BIG_ROW, jnp.int32),
    )
    best_t, best_u, best_v, best_row = jax.lax.fori_loop(
        0, pl.cdiv(n_tris, bt), body, init
    )
    t_min = jnp.min(best_t, axis=1)
    # across columns, equal-t winners resolve to the lowest table row
    row = jnp.min(jnp.where(best_t == t_min[:, None], best_row, _BIG_ROW), axis=1)
    pick = best_row == row[:, None]
    u = jnp.sum(jnp.where(pick, best_u, 0.0), axis=1)
    v = jnp.sum(jnp.where(pick, best_v, 0.0), axis=1)
    hit = t_min < jnp.inf
    out = pl.ds(i * br, br)
    plgpu.store(t_ref.at[out], jnp.where(hit, t_min, 1e5), mask=rmask)
    plgpu.store(u_ref.at[out], jnp.where(hit, u, 0.0), mask=rmask)
    plgpu.store(v_ref.at[out], jnp.where(hit, v, 0.0), mask=rmask)
    plgpu.store(row_ref.at[out], jnp.where(hit, row, -1), mask=rmask)


def coefficient_table(frame, prec: Precision):
    """(rows, TI) f32 table: dtype x/y rows (values exact in f32), f32 z row,
    offsets, and for sub-fp32 modes the f32 x/y rows of the band re-test."""
    TI = frame.dense_n.shape[0]
    n = frame.dense_n.astype(F32).reshape(TI, 9)
    nf = frame.dense_n_f32.reshape(TI, 9)
    cols = [n[:, 0:6], nf[:, 6:9], frame.dense_e]
    if not prec.is_f32:
        cols.append(nf[:, 0:6])
    return jnp.concatenate(cols, axis=1).T


def trace_rays_dense_triton(
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
    find_any: bool = False,  # closest hit either way, as the reference
    interpret: bool = False,
    block_rays: int = BLOCK_RAYS,
    block_tris: int = BLOCK_TRIS,
) -> Hit:
    """Drop-in for `trace_rays_dense` on a GPU.  Shapes: (R, 3) in."""
    del scene, find_any
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "traversal_impl='dense_triton' is a CUDA kernel (Pallas on the "
            f"Triton route) and cannot run on the {jax.default_backend()!r} "
            "backend; use traversal_impl='dense' there"
        )
    assert frame.dense_n is not None, (
        "dense backend needs FrameInput dense coefficients (scene too large?)"
    )
    assert fallback in ("both", "dtype"), fallback
    dt = prec.dtype
    R = origins.shape[0]
    TI = frame.dense_n.shape[0]
    # the same dtype quantisation of the ray as the reference, carried in f32
    o = quantize(origins.astype(F32) - frame.dense_center, dt)
    d = quantize(directions, dt)
    mind = jnp.broadcast_to(jnp.asarray(min_dist, F32), (R,))
    maxd = jnp.broadcast_to(jnp.asarray(max_dist, F32), (R,))
    skip = (
        jnp.full((R,), -1, jnp.int32) if skip_tri is None
        else skip_tri.astype(jnp.int32)
    )
    rays = jnp.concatenate([o.T, d.T, mind[None], maxd[None]], axis=0)  # (8, R)

    kernel = functools.partial(
        _kernel, n_rays=R, n_tris=TI, br=block_rays, bt=block_tris,
        low=not prec.is_f32, fallback=fallback,
        d1=float(prec.delta1), d2=float(prec.delta2),
    )
    out1 = lambda dtype: jax.ShapeDtypeStruct((R,), dtype)
    t, u, v, row = pl.pallas_call(
        kernel,
        out_shape=(out1(F32), out1(F32), out1(F32), out1(jnp.int32)),
        grid=(pl.cdiv(R, block_rays),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="dense_triton",
    )(rays, skip, coefficient_table(frame, prec), frame.dense_tri)
    hit = row >= 0
    rc = jnp.maximum(row, 0)
    return Hit(
        t=t,
        u=u,
        v=v,
        tri=jnp.where(hit, frame.dense_tri[rc], -1),
        obj=jnp.where(hit, frame.dense_obj[rc], -1),
    )
