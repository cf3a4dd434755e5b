"""SVGF denoiser unit tests: NaN laundering, edge-stopping behaviour,
constant-signal invariance, temporal accumulation."""

import jax
import jax.numpy as jnp
import numpy as np

from low_precision_raytracer.config import SVGFConfig
from low_precision_raytracer.ops import svgf as S

H = W = 64
CFG = SVGFConfig()


def _flat_inputs(dt=jnp.float32, depth_val=2.0):
    normal = jnp.broadcast_to(jnp.asarray([0, 0, 1], dt), (H, W, 3))
    depth = jnp.full((H, W), depth_val, dt)
    grad = S.preprocess_normal_depth(normal, depth)
    return normal, depth, grad


def _tmap(count=0):
    """Identity temporal map: anchor at (y, x) (pre-shifted +1 for padding),
    full weight on tap 0."""
    return dict(
        frame_count=jnp.full((H, W), count, jnp.int32),
        weights=jnp.concatenate(
            [jnp.ones((H, W, 1), jnp.float32), jnp.zeros((H, W, 3), jnp.float32)], -1
        ),
        base_y=jnp.broadcast_to(jnp.arange(1, H + 1, dtype=jnp.int32)[:, None], (H, W)),
        base_x=jnp.broadcast_to(jnp.arange(1, W + 1, dtype=jnp.int32)[None, :], (H, W)),
    )


def test_wavelet_preserves_constant_image():
    normal, depth, grad = _flat_inputs()
    color = jnp.full((H, W, 3), 0.5, jnp.float32)
    illum = jnp.full((H, W), 0.5, jnp.float32)
    var = jnp.full((H, W), 0.01, jnp.float32)
    out_c, out_v = S.wavelet_filter(color, var, depth, grad, normal, illum, 1, CFG)
    np.testing.assert_allclose(np.asarray(out_c), 0.5, rtol=1e-5)
    # variance shrinks under averaging: sum h^2 w^2 / (sum h w)^2 < 1
    assert np.all(np.asarray(out_v) < 0.01)


def test_wavelet_launders_nan():
    normal, depth, grad = _flat_inputs()
    color = jnp.full((H, W, 3), 0.5, jnp.float32)
    color = color.at[10, 10].set(jnp.nan)
    illum = jnp.full((H, W), 0.5, jnp.float32)
    var = jnp.full((H, W), 0.01, jnp.float32)
    out_c, _ = S.wavelet_filter(color, var, depth, grad, normal, illum, 1, CFG)
    # neighbours of a NaN pixel stay finite (finite-masked accumulation);
    # the NaN pixel itself is filled from its finite neighbours
    assert np.isfinite(np.asarray(out_c)).all()


def test_wavelet_stops_at_normal_edges():
    """Two regions with opposing normals must not bleed (w_n = cos^128)."""
    dt = jnp.float32
    normal = jnp.where(
        (jnp.arange(W) < W // 2)[None, :, None],
        jnp.asarray([0, 0, 1], dt),
        jnp.asarray([1, 0, 0], dt),
    )
    normal = jnp.broadcast_to(normal, (H, W, 3))
    depth = jnp.full((H, W), 2.0, dt)
    grad = S.preprocess_normal_depth(normal, depth)
    color = jnp.where(
        (jnp.arange(W) < W // 2)[None, :, None], 1.0, 0.0
    ) * jnp.ones((H, W, 3), dt)
    illum = color[..., 0]
    var = jnp.full((H, W), 0.25, dt)
    out_c, _ = S.wavelet_filter(color, var, depth, grad, normal, illum, 1, CFG)
    out = np.asarray(out_c)
    # interior of each region keeps its value
    np.testing.assert_allclose(out[:, : W // 2 - 3], 1.0, atol=1e-3)
    np.testing.assert_allclose(out[:, W // 2 + 3 :], 0.0, atol=1e-3)


def test_temporal_color_blends_history():
    tmap = _tmap(count=5)
    inp = jnp.full((H, W, 3), 1.0, jnp.float32)
    hist = jnp.zeros((H, W, 3), jnp.float32)
    integrated, illum = S.temporal_accumulation_color(inp, hist, tmap, 0.1)
    # w=0.1: out = 0.1*in + 0.9*hist = 0.1
    np.testing.assert_allclose(np.asarray(integrated), 0.1, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(illum), 0.1 * (0.2126 + 0.7152 + 0.0722), atol=1e-4
    )


def test_temporal_color_no_history():
    tmap = _tmap(count=0)  # frame_count 0 -> use current colour as history
    inp = jnp.full((H, W, 3), 1.0, jnp.float32)
    hist = jnp.zeros((H, W, 3), jnp.float32)
    integrated, _ = S.temporal_accumulation_color(inp, hist, tmap, 0.1)
    np.testing.assert_allclose(np.asarray(integrated), 1.0, atol=1e-5)


def test_moments_spatial_vs_temporal_switch():
    normal, depth, grad = _flat_inputs()
    illum = jnp.full((H, W), 0.5, jnp.float32)
    prev1 = jnp.full((H, W), 0.9, jnp.float32)
    prev2 = jnp.full((H, W), 0.9, jnp.float32)
    # frame_count < 4: spatial estimate -> mu1 == illum for flat input
    m1s, m2s, _ = S.temporal_accumulation_moments(
        _tmap(count=1), depth, grad, normal, prev1, prev2, illum, 0.1, CFG
    )
    np.testing.assert_allclose(np.asarray(m1s), 0.5, atol=1e-4)
    # frame_count >= 4: temporal lerp with history
    m1t, _, _ = S.temporal_accumulation_moments(
        _tmap(count=5), depth, grad, normal, prev1, prev2, illum, 0.1, CFG
    )
    np.testing.assert_allclose(np.asarray(m1t), 0.9 * 0.9 + 0.5 * 0.1, atol=1e-4)


def test_denoise_reduces_noise_flat_geometry():
    normal, depth, grad = _flat_inputs()
    key = jax.random.PRNGKey(0)
    clean = 0.5
    noisy = clean + 0.2 * jax.random.normal(key, (H, W, 3), jnp.float32)
    state = S.init_svgf_state(H, W, jnp.float32)
    out, new_state = S.svgf_denoise(
        noisy, state, _tmap(count=0), normal, depth, grad, CFG, 0.1, 0.1
    )
    in_err = float(jnp.std(noisy - clean))
    out_err = float(jnp.std(out - clean))
    assert out_err < in_err * 0.35, f"denoise {in_err} -> {out_err}"
    # iteration #1 output became the colour history
    assert not np.allclose(np.asarray(new_state.color_history), 0.0)
