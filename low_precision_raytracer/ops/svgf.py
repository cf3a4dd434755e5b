"""SVGF denoiser (`rt/rtrt/cuda.hpp:1117-1711`): temporal accumulation with
outlier clamping, spatial/temporal moments, and 5 variance-guided a-trous
wavelet iterations (strides 1, 2, 4, 8, 16).

Formulation: every kernel is a fused XLA stencil built from
statically shifted slices over NaN-padded (H, W) arrays.  NaN padding
reproduces the reference's skip-out-of-bounds border handling exactly,
because every accumulation is already isfinite-masked (the reference treats
NaN/Inf as expected in-band values, SURVEY.md §5.3).

The reference's mu ping-pong cudaMemcpy size bug (`rt/rtrt/cuda.hpp:1666-1669`)
is not reproduced — state is functionally threaded (SURVEY.md 2.17).

Runs entirely in the render dtype, like the reference's DataT kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import SVGFConfig
from low_precision_raytracer.math.vec import luminance, value_or
from low_precision_raytracer.ops.reproject import gather_taps, weighted_taps

WAVELET_H = (3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
GAUSS_G = (1.0 / 2.0, 1.0 / 4.0)


def _pad_nan(x, k):
    """Pad (H, W, ...) with NaN margin k."""
    pad = [(k, k), (k, k)] + [(0, 0)] * (x.ndim - 2)
    return jnp.pad(x, pad, constant_values=jnp.nan)


def _shift(xp, i, j, H, W):
    """View of the NaN-padded array shifted by (i, j)."""
    k = (xp.shape[0] - H) // 2
    return xp[k + i : k + i + H, k + j : k + j + W]


def _tap_tables(stride, dt):
    """5x5 a-trous tap tables: (h weights, di offsets, dj offsets), indexed
    by a fori_loop (keeps the compiled stencil 25x smaller than unrolling)."""
    import numpy as np

    hs, dis, djs = [], [], []
    for i in range(-2, 3):
        for j in range(-2, 3):
            hs.append(WAVELET_H[abs(i)] * WAVELET_H[abs(j)])
            dis.append(i * stride)
            djs.append(j * stride)
    return (
        jnp.asarray(np.asarray(hs), dt),
        jnp.asarray(dis, jnp.int32),
        jnp.asarray(djs, jnp.int32),
    )



def _pow_int(x, n: int):
    """x**n via binary squaring (n static) — avoids the generic pow
    (exp(log)) lowering, which dominates stencil runtime on the VPU."""
    if n <= 0:
        return jnp.ones_like(x)  # x^0 == 1 (sigma_n = 0 disables the stop)
    result = None
    base = x
    while n > 0:
        if n & 1:
            result = base if result is None else result * base
        base = base * base
        n >>= 1
    return result


def _edge_weights(dz_abs, denom_z, ndot, sigma_n: float, extra=None):
    """w_z * w_n (optionally * w_l) with a single exp: exp(a)*exp(b) =
    exp(a+b), and integer sigma_n via squarings."""
    arg = -dz_abs / denom_z
    if extra is not None:
        arg = arg + extra
    w = jnp.exp(arg)
    if float(sigma_n).is_integer():
        return w * _pow_int(jnp.maximum(0.0, ndot).astype(w.dtype), int(sigma_n))
    return w * jnp.maximum(0.0, ndot).astype(w.dtype) ** jnp.asarray(sigma_n, w.dtype)


class SVGFState(NamedTuple):
    """Per-instance temporal state (one for GI-colored, one for GI-white)."""

    miu1: jnp.ndarray  # (H, W)
    miu2: jnp.ndarray  # (H, W)
    color_history: jnp.ndarray  # (H, W, 3)


def init_svgf_state(height, width, dtype) -> SVGFState:
    return SVGFState(
        miu1=jnp.zeros((height, width), dtype),
        miu2=jnp.zeros((height, width), dtype),
        color_history=jnp.zeros((height, width, 3), dtype),
    )


def preprocess_normal_depth(normal, depth):
    """Depth gradients with forward diff at the border, backward elsewhere
    (`preprocess_normal_depth`, `rt/rtrt/cuda.hpp:1442-1473`).
    normal: (H, W, 3); depth: (H, W).  -> grad (H, W, 2); normal/depth pass
    through unchanged at the call site (unlike the reference's in-place
    kernel, there is nothing to write back)."""
    gx = depth - jnp.roll(depth, 1, axis=1)
    gx = gx.at[:, 0].set(depth[:, 1] - depth[:, 0])
    gy = depth - jnp.roll(depth, 1, axis=0)
    gy = gy.at[0, :].set(depth[1, :] - depth[0, :])
    return jnp.stack([gx, gy], axis=-1)


def temporal_accumulation_color(input_color, history_color, svgf_map, color_taa_w,
                                hist_pre=None):
    """Outlier clamp (9x9 finite mean +-0.5 sigma, GAMES-202 style) + history
    lerp (`temporal_accumulation_color`, `rt/rtrt/cuda.hpp:1187-1243`).

    -> (integrated_color (H, W, 3), illum (H, W))."""
    dt = input_color.dtype
    H, W = input_color.shape[:2]
    # 9x9 finite box sums as a separable shifted-add filter (9+9 adds per
    # sum; reduce_window compiles pathologically slowly on this toolchain);
    # out-of-bounds taps contribute nothing, matching the reference's
    # bounds checks
    fin = jnp.isfinite(input_color)
    zero = jnp.asarray(0.0, dt)
    safe = jnp.where(fin, input_color, zero)

    def box9(x):
        xp = jnp.pad(x, ((4, 4), (0, 0), (0, 0)))
        rows = xp[0:H]
        for i in range(1, 9):
            rows = rows + xp[i : i + H]
        rp = jnp.pad(rows, ((0, 0), (4, 4), (0, 0)))
        out = rp[:, 0:W]
        for j in range(1, 9):
            out = out + rp[:, j : j + W]
        return out

    weights = box9(fin.astype(dt))
    miu1 = box9(safe) / weights
    miu2 = box9(safe * safe) / weights
    p_color = value_or(input_color, miu1)
    var = miu2 - miu1 * miu1
    std = jnp.sqrt(var)  # NaN when var rounds slightly negative
    half = jnp.asarray(0.5, dt)
    clamped = jnp.clip(p_color, miu1 - half * std, miu1 + half * std)
    # the reference's clip_both with NaN bounds returns the value unchanged
    # (`rt/rtrt/cuda.hpp:919-926`: NaN comparisons are false)
    p_color = jnp.where(jnp.isfinite(std), clamped, p_color)

    if hist_pre is None:
        hist_vals = gather_taps(svgf_map, history_color)
        h = weighted_taps(svgf_map, hist_vals, 0.0, channel=True).astype(dt)
    else:
        # finished weighted fetch (reproject.fetch_weighted semantics)
        h = hist_pre.astype(dt)
    hist = jnp.where((svgf_map["frame_count"] > 0)[..., None], h, p_color)
    hist = value_or(hist, p_color)
    w = jnp.asarray(color_taa_w, dt)
    integrated = w * p_color + (1 - w) * hist
    return integrated, luminance(integrated)


def temporal_accumulation_moments(
    svgf_map,
    depth,
    grad,
    normal,
    miu1_prev,
    miu2_prev,
    illum,
    moments_taa_w,
    cfg: SVGFConfig,
    m1_pre=None,
    m2_pre=None,
    unroll: bool = False,
):
    """Spatial (bilateral 5x5, <4 valid frames) or temporal moments
    (`temporal_accumulation_moments`, `rt/rtrt/cuda.hpp:1245-1337`).

    `unroll` replaces the fori_loop taps with 25 statically shifted slices:
    bigger program, but GSPMD can see the bounded halo and partition the
    stencil with ppermutes instead of all-gathering the padded arrays
    (use under a device mesh; single-chip keeps the small looped program).

    -> (miu1, miu2, variance)."""
    dt = illum.dtype
    H, W = illum.shape
    dp = _pad_nan(depth, 2)
    npad = _pad_nan(normal, 2)
    ip = _pad_nan(illum, 2)
    h_tab, di_tab, dj_tab = _tap_tables(1, dt)

    def tap_body(acc, h, di, dj, depth_q, normal_q, illum_q):
        m1, m2, wsum = acc
        d_dot = grad[..., 0] * jnp.asarray(di, dt) + grad[..., 1] * jnp.asarray(dj, dt)
        ndot = jnp.sum(normal * normal_q, axis=-1)
        hw = h * _edge_weights(
            jnp.abs(depth - depth_q),
            jnp.asarray(cfg.sigma_z, dt) * jnp.abs(d_dot + jnp.asarray(cfg.eps, dt)),
            ndot,
            cfg.sigma_n,
        )
        ok = jnp.isfinite(hw) & jnp.isfinite(illum_q)
        hw = jnp.where(ok, hw, 0.0).astype(dt)
        iq = jnp.where(ok, illum_q, 0.0).astype(dt)
        return (m1 + hw * iq, m2 + hw * iq * iq, wsum + hw)

    zero = jnp.zeros_like(illum)
    if unroll:
        acc = (zero, zero, zero)
        for i in range(-2, 3):
            for j in range(-2, 3):
                h = jnp.asarray(WAVELET_H[abs(i)] * WAVELET_H[abs(j)], dt)
                acc = tap_body(
                    acc, h, i, j,
                    _shift(dp, i, j, H, W),
                    _shift(npad, i, j, H, W),
                    _shift(ip, i, j, H, W),
                )
        m1, m2, wsum = acc
    else:
        def tap(idx, acc):
            di = di_tab[idx]
            dj = dj_tab[idx]
            return tap_body(
                acc, h_tab[idx], di.astype(dt), dj.astype(dt),
                jax.lax.dynamic_slice(dp, (2 + di, 2 + dj), (H, W)),
                jax.lax.dynamic_slice(npad, (2 + di, 2 + dj, 0), (H, W, 3)),
                jax.lax.dynamic_slice(ip, (2 + di, 2 + dj), (H, W)),
            )

        m1, m2, wsum = jax.lax.fori_loop(0, 25, tap, (zero, zero, zero))
    m1_spatial = m1 / wsum
    m2_spatial = m2 / wsum

    w = jnp.asarray(moments_taa_w, dt)
    illum2 = illum * illum
    if m1_pre is None:
        m1_vals = gather_taps(svgf_map, miu1_prev)
        m1_fetch = weighted_taps(svgf_map, m1_vals, 0.0, channel=False).astype(dt)
    else:
        m1_fetch = m1_pre.astype(dt)
    if m2_pre is None:
        m2_vals = gather_taps(svgf_map, miu2_prev)
        m2_fetch = weighted_taps(svgf_map, m2_vals, 0.0, channel=False).astype(dt)
    else:
        m2_fetch = m2_pre.astype(dt)
    m1_t = (1 - w) * m1_fetch + illum * w
    m2_t = (1 - w) * m2_fetch + illum2 * w
    m1_t = value_or(m1_t, illum)
    m2_t = value_or(m2_t, illum2)

    spatial = svgf_map["frame_count"] < cfg.spatial_moments_below
    miu1 = jnp.where(spatial, m1_spatial, m1_t)
    miu2 = jnp.where(spatial, m2_spatial, m2_t)
    return miu1, miu2, miu2 - miu1 * miu1


def wavelet_filter(color_in, var_in, depth, grad, normal, illum, stride, cfg: SVGFConfig,
                   unroll: bool = False):
    """One variance-guided a-trous iteration
    (`wavelet_filter<stride>`, `rt/rtrt/cuda.hpp:1339-1440`).

    `unroll`: static-slice taps for GSPMD halo partitioning (see
    temporal_accumulation_moments).

    -> (color_out, var_out)."""
    dt = illum.dtype
    H, W = illum.shape

    # 3x3 gaussian prefilter on variance (in-bounds taps only, no NaN skip)
    vp0 = jnp.pad(var_in, ((1, 1), (1, 1)), constant_values=0)
    mp0 = jnp.pad(jnp.ones_like(var_in), ((1, 1), (1, 1)), constant_values=0)
    gnum = jnp.zeros_like(var_in)
    gden = jnp.zeros_like(var_in)
    for i in range(-1, 2):
        for j in range(-1, 2):
            g = jnp.asarray(GAUSS_G[abs(i)] * GAUSS_G[abs(j)], dt)
            gnum = gnum + g * _shift(vp0, i, j, H, W)
            gden = gden + g * _shift(mp0, i, j, H, W)
    sqrt_g_var = jnp.sqrt(gnum / gden)

    k = 2 * stride
    cp = _pad_nan(color_in, k)
    vp = _pad_nan(var_in, k)
    dpad = _pad_nan(depth, k)
    npad = _pad_nan(normal, k)
    ip = _pad_nan(illum, k)

    sig_l = jnp.asarray(cfg.sigma_l, dt)
    eps = jnp.asarray(cfg.eps, dt)
    h_tab, di_tab, dj_tab = _tap_tables(stride, dt)

    def tap_body(acc, h, di, dj, depth_q, normal_q, illum_q, color_q, var_q):
        num_c, den_c, num_v, den_v = acc
        d_dot = grad[..., 0] * jnp.asarray(di, dt) + grad[..., 1] * jnp.asarray(dj, dt)
        ndot = jnp.sum(normal * normal_q, axis=-1)
        hw = h * _edge_weights(
            jnp.abs(depth - depth_q),
            jnp.asarray(cfg.sigma_z, dt) * jnp.abs(d_dot + eps),
            ndot,
            cfg.sigma_n,
            extra=-jnp.abs(illum - illum_q) / (sig_l * sqrt_g_var + eps),
        )
        hw_fin = jnp.isfinite(hw)

        ok_v = hw_fin & jnp.isfinite(var_q)
        hv = jnp.where(ok_v, hw, 0.0).astype(dt)
        num_v = num_v + hv * hv * jnp.where(ok_v, var_q, 0.0).astype(dt)
        den_v = den_v + hv

        ok_c = hw_fin & jnp.all(jnp.isfinite(color_q), axis=-1)
        hc = jnp.where(ok_c, hw, 0.0).astype(dt)
        num_c = num_c + hc[..., None] * jnp.where(ok_c[..., None], color_q, 0.0).astype(dt)
        den_c = den_c + hc
        return (num_c, den_c, num_v, den_v)

    zero1 = jnp.zeros_like(illum)
    acc0 = (jnp.zeros_like(color_in), zero1, zero1, zero1)
    if unroll:
        acc = acc0
        for i in range(-2, 3):
            for j in range(-2, 3):
                di, dj = i * stride, j * stride
                h = jnp.asarray(WAVELET_H[abs(i)] * WAVELET_H[abs(j)], dt)
                acc = tap_body(
                    acc, h, di, dj,
                    _shift(dpad, di, dj, H, W),
                    _shift(npad, di, dj, H, W),
                    _shift(ip, di, dj, H, W),
                    _shift(cp, di, dj, H, W),
                    _shift(vp, di, dj, H, W),
                )
        num_c, den_c, num_v, den_v = acc
    else:
        def tap(idx, acc):
            di = di_tab[idx]
            dj = dj_tab[idx]
            return tap_body(
                acc, h_tab[idx], di.astype(dt), dj.astype(dt),
                jax.lax.dynamic_slice(dpad, (k + di, k + dj), (H, W)),
                jax.lax.dynamic_slice(npad, (k + di, k + dj, 0), (H, W, 3)),
                jax.lax.dynamic_slice(ip, (k + di, k + dj), (H, W)),
                jax.lax.dynamic_slice(cp, (k + di, k + dj, 0), (H, W, 3)),
                jax.lax.dynamic_slice(vp, (k + di, k + dj), (H, W)),
            )

        num_c, den_c, num_v, den_v = jax.lax.fori_loop(0, 25, tap, acc0)

    next_var = num_v / (den_v * den_v)
    next_color = num_c / den_c[..., None]
    next_color = value_or(next_color, color_in)
    next_var = value_or(next_var, var_in)
    return next_color, next_var


def svgf_denoise(
    color,
    state: SVGFState,
    svgf_map,
    normal,
    depth,
    grad,
    cfg: SVGFConfig,
    color_taa_w,
    moments_taa_w,
    prefetch=None,
):
    """Full denoise sequence (`svgf_denoise`, `rt/rtrt/cuda.hpp:1636-1711`).

    -> (denoised_color, new_state).  Iteration #1's output doubles as next
    frame's color history (`:1676-1688`)."""
    hist_pre = m1_pre = m2_pre = None
    if prefetch is not None:
        hist_pre, m1_pre, m2_pre = prefetch
    integrated, illum = temporal_accumulation_color(
        color, state.color_history, svgf_map, color_taa_w, hist_pre=hist_pre
    )
    miu1, miu2, var = temporal_accumulation_moments(
        svgf_map, depth, grad, normal, state.miu1, state.miu2, illum, moments_taa_w,
        cfg, m1_pre=m1_pre, m2_pre=m2_pre,
    )
    c, v = integrated, var
    new_history = state.color_history
    for it, stride in enumerate(cfg.strides):
        c, v = wavelet_filter(c, v, depth, grad, normal, illum, stride, cfg)
        if it == 0:
            new_history = c
    return c, SVGFState(miu1=miu1, miu2=miu2, color_history=new_history)


def svgf_denoise_pair(
    color2,
    state2: SVGFState,  # leaves stacked (2, ...)
    svgf_map,
    normal,
    depth,
    grad,
    cfg: SVGFConfig,
    color_taa_w,
    moments_taa_w,
    prefetch2=None,
    mesh=None,  # row-sharded device mesh: halo-partitionable stencils
):
    """Both denoiser instances (GI-colored + GI-white,
    `rt/gui/imgui_window.cu:231-239`) in one vmapped pass of the XLA
    stencils: every stencil runs once on (2, H, W) instead of twice.

    Under a device mesh of more than one device the stencil taps unroll
    into static slices, so GSPMD partitions them with bounded halo
    exchanges (the looped taps' traced slice offsets defeat XLA's halo
    analysis and all-gather the pixel arrays)."""
    unroll = mesh is not None and int(mesh.devices.size) > 1

    # cfg.state_f32: denoiser arithmetic + the carried state run in fp32
    # regardless of the render dtype (bf16 history requantisation costs
    # dB of converged quality — config.SVGFConfig.state_f32).  The
    # denoised colour still leaves in the render dtype; the returned
    # SVGFState leaves in fp32.
    out_dt = color2.dtype
    if cfg.state_f32 and out_dt != jnp.float32:
        f32 = jnp.float32
        color2 = color2.astype(f32)
        normal = normal.astype(f32)
        depth = depth.astype(f32)
        grad = grad.astype(f32)
        state2 = SVGFState(*(x.astype(f32) for x in state2))
        if prefetch2 is not None:
            prefetch2 = jax.tree_util.tree_map(
                lambda x: x.astype(f32), prefetch2
            )

    def temporal(color, state, pre):
        hist_pre = m1_pre = m2_pre = None
        if pre is not None:
            hist_pre, m1_pre, m2_pre = pre
        integrated, illum = temporal_accumulation_color(
            color, state.color_history, svgf_map, color_taa_w, hist_pre=hist_pre
        )
        miu1, miu2, var = temporal_accumulation_moments(
            svgf_map, depth, grad, normal, state.miu1, state.miu2, illum,
            moments_taa_w, cfg, m1_pre=m1_pre, m2_pre=m2_pre, unroll=unroll,
        )
        return integrated, illum, miu1, miu2, var

    if prefetch2 is None:
        integrated2, illum2, miu1_2, miu2_2, var2 = jax.vmap(temporal, in_axes=(0, 0, None))(
            color2, state2, None
        )
    else:
        integrated2, illum2, miu1_2, miu2_2, var2 = jax.vmap(temporal)(
            color2, state2, prefetch2
        )

    def chain(c, v, illum):
        hist = None
        for it, stride in enumerate(cfg.strides):
            c, v = wavelet_filter(c, v, depth, grad, normal, illum, stride, cfg,
                                  unroll=unroll)
            if it == 0:
                hist = c
        return c, hist

    out2, hist2 = jax.vmap(chain)(integrated2, var2, illum2)
    new_state2 = SVGFState(miu1=miu1_2, miu2=miu2_2, color_history=hist2)
    return out2.astype(out_dt), new_state2
