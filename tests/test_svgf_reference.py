"""The XLA SVGF stencils (ops/svgf.py) against straightforward NumPy
implementations of the same formulas (`rt/rtrt/cuda.hpp:1187-1440`): one
test per a-trous stride, one for the temporal colour accumulation, one for
the moments.  The reference visits each tap with an explicit bounds check
(out-of-bounds taps are skipped, non-finite weights and values are
skipped), computes in float64, and is compared at f32 tolerances."""

import numpy as np
import pytest

import jax.numpy as jnp

from low_precision_raytracer.config import SVGFConfig
from low_precision_raytracer.ops import svgf as S

H, W = 20, 24
CFG = SVGFConfig()
LUMA = np.array([0.2126, 0.7152, 0.0722])
WAVELET_H = (3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    color[3, 5, 1] = np.nan  # a non-finite input the filter must skip
    var = rng.uniform(0.0, 0.05, (H, W)).astype(np.float32)
    depth = (2.0 + 0.3 * rng.uniform(size=(H, W))).astype(np.float32)
    normal = np.stack([0.1 * rng.normal(size=(H, W)), 0.1 * rng.normal(size=(H, W)),
                       np.ones((H, W))], -1)
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    grad = np.asarray(S.preprocess_normal_depth(jnp.asarray(normal), jnp.asarray(depth)))
    illum = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    return color, var, depth, grad, normal, illum


def _taps(stride):
    for i in range(-2, 3):
        for j in range(-2, 3):
            yield WAVELET_H[abs(i)] * WAVELET_H[abs(j)], i * stride, j * stride


def _edge_weight(y, x, yq, xq, di, dj, depth, grad, normal, extra=0.0):
    d_dot = grad[y, x, 0] * di + grad[y, x, 1] * dj
    arg = -abs(depth[y, x] - depth[yq, xq]) / (CFG.sigma_z * abs(d_dot + CFG.eps)) + extra
    ndot = max(0.0, float(np.dot(normal[y, x], normal[yq, xq])))
    return np.exp(arg) * ndot ** CFG.sigma_n


def _wavelet_ref(color, var, depth, grad, normal, illum, stride):
    c, v, z, g, n, lum = (x.astype(np.float64) for x in (color, var, depth, grad, normal, illum))
    out_c = np.zeros_like(c)
    out_v = np.zeros_like(v)
    for y in range(H):
        for x in range(W):
            # 3x3 gaussian of the variance over in-bounds taps
            gnum = gden = 0.0
            for i in (-1, 0, 1):
                for j in (-1, 0, 1):
                    if 0 <= y + i < H and 0 <= x + j < W:
                        gw = (0.5, 0.25)[abs(i)] * (0.5, 0.25)[abs(j)]
                        gnum += gw * v[y + i, x + j]
                        gden += gw
            sg = np.sqrt(gnum / gden)
            num_c = np.zeros(3)
            den_c = num_v = den_v = 0.0
            for h, di, dj in _taps(stride):
                yq, xq = y + di, x + dj
                if not (0 <= yq < H and 0 <= xq < W):
                    continue
                extra = -abs(lum[y, x] - lum[yq, xq]) / (CFG.sigma_l * sg + CFG.eps)
                hw = h * _edge_weight(y, x, yq, xq, di, dj, z, g, n, extra)
                if not np.isfinite(hw):
                    continue
                if np.isfinite(v[yq, xq]):
                    num_v += hw * hw * v[yq, xq]
                    den_v += hw
                if np.isfinite(c[yq, xq]).all():
                    num_c += hw * c[yq, xq]
                    den_c += hw
            nc = num_c / den_c if den_c else np.full(3, np.nan)
            nv = num_v / (den_v * den_v) if den_v else np.nan
            out_c[y, x] = np.where(np.isfinite(nc), nc, c[y, x])
            out_v[y, x] = nv if np.isfinite(nv) else v[y, x]
    return out_c, out_v


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_wavelet_stride_matches_numpy(stride):
    color, var, depth, grad, normal, illum = _inputs(stride)
    got_c, got_v = S.wavelet_filter(
        *(jnp.asarray(a) for a in (color, var, depth, grad, normal, illum)),
        stride, CFG,
    )
    want_c, want_v = _wavelet_ref(color, var, depth, grad, normal, illum, stride)
    np.testing.assert_allclose(np.asarray(got_c), want_c, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=2e-4, atol=2e-6)


def test_temporal_color_accumulation_matches_numpy():
    """9x9 finite mean/variance outlier clamp (GAMES-202 style), history
    lerp where the frame count says history exists, Rec.709 luminance."""
    color, _, _, _, _, _ = _inputs(7)
    rng = np.random.default_rng(8)
    hist = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    count = (rng.uniform(size=(H, W)) > 0.3).astype(np.int32)
    w = 0.1
    got, got_l = S.temporal_accumulation_color(
        jnp.asarray(color), None, dict(frame_count=jnp.asarray(count)), w,
        hist_pre=jnp.asarray(hist),
    )
    c = color.astype(np.float64)
    want = np.zeros_like(c)
    for y in range(H):
        for x in range(W):
            win = c[max(0, y - 4):y + 5, max(0, x - 4):x + 5].reshape(-1, 3)
            fin = np.isfinite(win)
            m1 = np.where(fin, win, 0).sum(0) / fin.sum(0)
            m2 = np.where(fin, win * win, 0).sum(0) / fin.sum(0)
            p = np.where(np.isfinite(c[y, x]), c[y, x], m1)
            with np.errstate(invalid="ignore"):
                std = np.sqrt(m2 - m1 * m1)
            p = np.where(np.isfinite(std), np.clip(p, m1 - 0.5 * std, m1 + 0.5 * std), p)
            h = hist[y, x] if count[y, x] > 0 else p
            want[y, x] = w * p + (1 - w) * h
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_l), want @ LUMA, rtol=1e-4, atol=1e-5)


def test_temporal_moments_matches_numpy():
    """Spatial 5x5 bilateral moments below `spatial_moments_below` valid
    frames, the temporal moment lerp at and above it."""
    _, _, depth, grad, normal, illum = _inputs(9)
    rng = np.random.default_rng(10)
    m1_pre = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    m2_pre = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    count = rng.integers(0, 8, (H, W)).astype(np.int32)
    w = 0.1
    m1, m2, var = S.temporal_accumulation_moments(
        dict(frame_count=jnp.asarray(count)), jnp.asarray(depth), jnp.asarray(grad),
        jnp.asarray(normal), None, None, jnp.asarray(illum), w, CFG,
        m1_pre=jnp.asarray(m1_pre), m2_pre=jnp.asarray(m2_pre),
    )
    lum = illum.astype(np.float64)
    want1 = np.zeros((H, W))
    want2 = np.zeros((H, W))
    for y in range(H):
        for x in range(W):
            if count[y, x] >= CFG.spatial_moments_below:
                want1[y, x] = (1 - w) * m1_pre[y, x] + w * lum[y, x]
                want2[y, x] = (1 - w) * m2_pre[y, x] + w * lum[y, x] ** 2
                continue
            s1 = s2 = ws = 0.0
            for h, di, dj in _taps(1):
                yq, xq = y + di, x + dj
                if not (0 <= yq < H and 0 <= xq < W):
                    continue
                hw = h * _edge_weight(y, x, yq, xq, di, dj, depth.astype(np.float64),
                                      grad, normal.astype(np.float64))
                s1 += hw * lum[yq, xq]
                s2 += hw * lum[yq, xq] ** 2
                ws += hw
            want1[y, x], want2[y, x] = s1 / ws, s2 / ws
    np.testing.assert_allclose(np.asarray(m1), want1, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m2), want2, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(var), want2 - want1 ** 2, rtol=1e-3, atol=1e-5)
