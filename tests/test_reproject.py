"""gather2x2 path parity: the shifted-select fast path must agree exactly
with the flat-take path wherever taps matter, and the `lax.cond` dispatch
must fall back for anchors outside the residual window (SURVEY.md 2.18 —
the temporal fetch is the hot stage, so it has two implementations)."""

import jax
import jax.numpy as jnp
import numpy as np

from low_precision_raytracer.ops.reproject import (
    RES_K,
    _gather2x2_take,
    gather2x2,
)


def _mk(H=33, W=47, C=5, seed=0, my=3, mx=-2):
    k = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(k, 4)
    arr = jax.random.normal(k1, (H, W, C), jnp.float32)
    # anchors: pixel + global motion + residual in [-K, K], clipped to the
    # padded range like _footprint does
    ry = jax.random.randint(k2, (H, W), -RES_K, RES_K + 1)
    rx = jax.random.randint(k3, (H, W), -RES_K, RES_K + 1)
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    by = jnp.clip(row + 1 + my + ry, 0, H)
    bx = jnp.clip(col + 1 + mx + rx, 0, W)
    care = jax.random.bernoulli(k4, 0.9, (H, W))
    return arr, by.astype(jnp.int32), bx.astype(jnp.int32), care


def test_shifted_matches_take_where_care():
    arr, by, bx, care = _mk()
    ref = _gather2x2_take(arr, by, bx)
    out = gather2x2(arr, by, bx, care=care)
    m = np.asarray(care)[..., None, None]
    np.testing.assert_array_equal(
        np.asarray(out) * m, np.asarray(ref) * m
    )


def test_shifted_matches_take_negative_motion_border():
    """Regression: negative global motion with a +K residual makes border
    pixels' slice indices overflow the rolled history; the fast path's outer
    pad must WRAP (the true row lives at the circularly-wrapped index) —
    a zero pad silently darkened the far border row/column during pans.
    Calls the fast path DIRECTLY so dispatch fallback can't mask the bug."""
    from low_precision_raytracer.ops.reproject import _gather2x2_shifted

    for my, mx in ((-2, 0), (0, -2), (-2, -2), (1, 1), (3, -2)):
        arr, by, bx, _ = _mk(seed=7, my=my, mx=mx)
        H, W = arr.shape[:2]
        row = jnp.arange(H)[:, None]
        col = jnp.arange(W)[None, :]
        res_y = by - (row + 1) - my
        res_x = bx - (col + 1) - mx
        in_win = (jnp.abs(res_y) <= RES_K) & (jnp.abs(res_x) <= RES_K)
        assert bool(jnp.any(in_win)), "degenerate test setup"
        ref = _gather2x2_take(arr, by, bx)
        out = _gather2x2_shifted(arr, by, bx, my, mx, res_y, res_x)
        m = np.asarray(in_win)[..., None, None]
        np.testing.assert_array_equal(np.asarray(out) * m, np.asarray(ref) * m)


def test_out_of_window_falls_back_exactly():
    arr, by, bx, care = _mk(seed=1)
    # one caring pixel far outside the residual window -> take path for
    # the whole frame, exact everywhere
    by = by.at[5, 5].set(0)
    bx = bx.at[5, 5].set(40)
    care = care.at[5, 5].set(True)
    ref = _gather2x2_take(arr, by, bx)
    out = gather2x2(arr, by, bx, care=care)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_channelless_and_no_care():
    arr, by, bx, _ = _mk(C=1)
    a2 = arr[..., 0]
    ref = _gather2x2_take(arr, by, bx)[..., 0]
    np.testing.assert_array_equal(np.asarray(gather2x2(a2, by, bx)), np.asarray(ref))


def test_static_camera_residuals_stay_in_window():
    """End-to-end guard for the shifted-select fast path: after one frame
    of a STATIC camera, every valid pixel's reprojected anchor must sit
    within RES_K of its own pixel (fp32-reconstructed positions — the
    bf16 G-buffer position wobbles +-10 px and would force the 60 ms
    take path every frame)."""
    import low_precision_raytracer.ops.reproject as rp
    from low_precision_raytracer.config import RenderConfig, get_precision
    from low_precision_raytracer.models import procedural
    from low_precision_raytracer.models.scene import (
        build_scene_arrays,
        flatten_frame,
    )
    from low_precision_raytracer.ops.camera import primary_ray_grid
    from low_precision_raytracer.ops.gbuffer import fill_gbuffer
    from low_precision_raytracer.ops.trace import resolve_cfg
    from low_precision_raytracer.render.framestate import init_frame_state
    from low_precision_raytracer.render.renderer import render_frame

    H = W = 48
    cfg = RenderConfig(width=W, height=H, precision="bf16")
    prec = get_precision(cfg.precision)
    host = procedural.cornell_box_scene()
    scene = build_scene_arrays(host, prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, prec, max_direct_lights=cfg.max_direct_lights,
                          width=W, height=H)
    cfg = resolve_cfg(scene, frame, cfg)
    state = init_frame_state(cfg, len(frame.obj_layout))
    key = jax.random.PRNGKey(0)
    _, _, state = render_frame(scene, frame, state, cfg, key)

    # recompute the SVGF footprint exactly as render_frame does
    o, d = primary_ray_grid(frame.cam_l2w, frame.cam_fov_y, W, H, prec.dtype)
    g_flat, hit = fill_gbuffer(
        scene, frame, o.reshape(-1, 3), d.reshape(-1, 3), prec, cfg=cfg
    )
    g = {k: v.reshape((H, W) + v.shape[1:]) for k, v in g_flat.items()}
    o32, d32 = primary_ray_grid(
        frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, jnp.float32
    )
    pos32 = o32 + g["t"].reshape(H, W)[..., None].astype(jnp.float32) * d32

    f32 = jnp.float32
    O = frame.obj_w2l.shape[0]
    comp = state.last_w2c[None] @ state.last_l2w @ frame.obj_w2l_f32
    onehot = (
        g["obj"].reshape(-1)[:, None] == jnp.arange(O, dtype=jnp.int32)[None, :]
    ).astype(f32)
    comp_px = jnp.dot(onehot, comp.reshape(O, 16)).reshape(H, W, 4, 4)
    p4 = jnp.concatenate([pos32, jnp.ones((H, W, 1), f32)], axis=-1)
    clip = (comp_px @ p4[..., None])[..., 0]
    g_fx = (1 + clip[..., 0] / clip[..., 3]) / 2 * W
    g_fy = (1 + clip[..., 1] / clip[..., 3]) / 2 * H
    by, bx, _, inb = rp._footprint(
        g_fx - jnp.asarray(0.5, prec.dtype), g_fy - jnp.asarray(0.5, prec.dtype),
        H, W, prec.dtype,
    )
    care = np.asarray(g["valid"] & jnp.any(inb, axis=-1))
    row = np.arange(H)[:, None]
    col = np.arange(W)[None, :]
    dy = np.asarray(by) - (row + 1)
    dx = np.asarray(bx) - (col + 1)
    bad = ((np.abs(dy) > rp.RES_K) | (np.abs(dx) > rp.RES_K)) & care
    assert bad.sum() == 0, f"{bad.sum()} caring pixels outside the K window"


def test_fetch_weighted_matches_raw_paths():
    """fetch_weighted (coefficient-plane fast path AND take fallback) must
    equal sum_k w_k * tap_k of the raw gather wherever taps matter."""
    from low_precision_raytracer.ops.reproject import (
        _residuals,
        fetch_weighted,
    )

    arr, by, bx, care = _mk()
    H, W, C = arr.shape
    wgt = jax.random.uniform(jax.random.PRNGKey(9), (H, W, 4), jnp.float32)
    ref = jnp.sum(
        _gather2x2_take(arr, by, bx).astype(jnp.float32) * wgt[..., None], axis=2
    )
    res = _residuals(by, bx, care)
    # anchor clipping at the borders can push residuals out of the window;
    # force the fast path and compare only where it guarantees parity
    my, mx, res_y, res_x, _ = res
    in_win = (jnp.abs(res_y) <= RES_K) & (jnp.abs(res_x) <= RES_K)
    res_fast = (my, mx, res_y, res_x, jnp.asarray(True))
    out = fetch_weighted(arr, by, bx, wgt, res_fast)
    m = np.asarray(care & in_win)[..., None]
    np.testing.assert_allclose(
        np.asarray(out) * m, np.asarray(ref) * m, rtol=1e-5, atol=1e-5
    )
    # force the take fallback (all_ok=False) — must agree EVERYWHERE
    res_fb = (*res[:4], jnp.asarray(False))
    out_fb = fetch_weighted(arr, by, bx, wgt, res_fb)
    np.testing.assert_allclose(
        np.asarray(out_fb), np.asarray(ref), rtol=1e-6, atol=1e-6
    )


def test_taa_identity_at_weight_one():
    """TAA at mix weight 1 is bitwise the identity — the property that lets
    render_frame statically elide the whole TAA map half at the reference's
    default weight (`taa_mix_weight = 1`, `rt/gui/imgui_window.cu:99`).
    Must hold even for non-finite history (value_or launders it FIRST,
    `rt/rtrt/cuda.hpp:2436-2438`; without that, inf * 0 would leak NaN)."""
    import jax
    from low_precision_raytracer.ops.taa import temporal_anti_aliasing

    H, W = 6, 8
    key = jax.random.PRNGKey(3)
    color = jax.random.uniform(key, (H, W, 3), jnp.float32)
    hist = jax.random.uniform(jax.random.PRNGKey(4), (H, W, 3), jnp.float32)
    hist = hist.at[0, 0, 0].set(jnp.nan).at[1, 2, 1].set(jnp.inf)
    count = jnp.ones((H, W), jnp.int32).at[2, 2].set(0)
    tmap = dict(frame_count=count)
    for dt in (jnp.float32, jnp.bfloat16):
        c = color.astype(dt)
        out = temporal_anti_aliasing(
            c, hist.astype(dt), tmap, 1.0, hist_pre=hist.astype(jnp.float32)
        )
        np.testing.assert_array_equal(np.asarray(out, np.float32),
                                      np.asarray(c, np.float32))


def test_render_taa_weight_one_elision_is_exact():
    """The elided TAA path (default at weight 1.0) must be bitwise identical
    to the FULL path forced through map build + jittered gather + history
    blend at the same weight — i.e. the elision really is exact, not just
    two spellings of the same skip.  `taa_force_full=True` runs the real
    temporal_anti_aliasing stage (`rt/rtrt/cuda.hpp:2418-2439` semantics) at
    w=1, where value_or launders history before `hist * 0`."""
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.render.renderer import Renderer

    imgs = {}
    for force_full in (True, False):
        cfg = RenderConfig(width=32, height=32, precision="fp32", gi_on=True,
                           taa_on=True, taa_mix_weight=1.0,
                           taa_force_full=force_full)
        r = Renderer(cornell_box_scene(), cfg)
        img = None
        for _ in range(2):
            img, _ = r.render()
        imgs[force_full] = np.asarray(img)
    np.testing.assert_array_equal(imgs[True], imgs[False])
