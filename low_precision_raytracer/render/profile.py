"""Per-stage profiling (reference §5.1: `Renderer::timing` around every
kernel + sync, `rt/gui/imgui_window.cu:86-91`).

Production frames are ONE fused jit program; this harness re-executes the
schedule as separately-jitted stages with `block_until_ready` between them,
producing a timing dict keyed by the reference's 12 stage names.  Every
stage runs the SAME code path production does (the vmapped SVGF pair with
prefetched taps, f32 reprojection positions, payload-carrying temporal
maps) so the breakdown is decision-grade.  Use only for profiling — stage
boundaries inhibit XLA fusion, exactly like the reference's
sync-after-every-launch discipline."""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import get_precision
from low_precision_raytracer.models.scene import flatten_frame
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.compose import (
    add_denoised_color,
    tonemap_gamma,
    write_clean_color,
)
from low_precision_raytracer.ops.gbuffer import fill_gbuffer
from low_precision_raytracer.ops.reproject import generate_temporal_maps
from low_precision_raytracer.ops.shade import gbuffer_to_shade_input, shade
from low_precision_raytracer.ops.svgf import (
    preprocess_normal_depth,
    svgf_denoise_pair,
)
from low_precision_raytracer.ops.taa import temporal_anti_aliasing
from low_precision_raytracer.render.renderer import _gi_shade_input, _trace_di


_TIMED_ITERS = 8


def _timed(name, stats, fn, *args):
    """Mean device-synchronised time of _TIMED_ITERS identical calls, after
    one warm-up (compile) call.  Stages are pure (explicit keys), so
    repeated identical calls are well-defined."""
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(_TIMED_ITERS):
        out = fn(*args)
    jax.block_until_ready(out)
    stats[name] = (time.perf_counter() - t0) / _TIMED_ITERS
    return out


def profile_frame(renderer, time_value: float = 0.0) -> dict[str, float]:
    """-> {stage name: seconds} using the reference's stage names."""
    cfg = renderer.cfg
    prec = get_precision(cfg.precision)
    dt = prec.dtype
    H, W = cfg.height, cfg.width
    R = H * W
    scene = renderer.scene
    state = renderer.state
    frame = flatten_frame(
        renderer.host, prec, time=time_value,
        max_direct_lights=cfg.max_direct_lights, width=W, height=H,
    )
    key = jax.random.PRNGKey(1)
    k_taa, k0, k1 = jax.random.split(key, 3)
    stats: dict[str, float] = {}

    @jax.jit
    def primary(frame):
        # production traces the f32 camera grid in every mode
        # (render/renderer.py: bf16 directions carry ~2.3 px of wobble)
        o32, d32 = primary_ray_grid(
            frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, jnp.float32
        )
        o32 = o32.reshape(R, 3)
        d32 = d32.reshape(R, 3)
        g, _ = fill_gbuffer(scene, frame, o32, d32, prec, cfg=cfg)
        return g, d32.astype(dt) if not cfg.prec.is_f32 else d32

    # warm up each stage once (compile), then measure
    g_flat, d = _timed("Primary Ray", stats, primary, frame)
    g2d = {k: v.reshape((H, W) + v.shape[1:]) for k, v in g_flat.items()}

    # temporal maps exactly as render_frame builds them: payload channels
    # fetched in the same pass, f32-reconstructed reprojection positions
    def tmaps(g2d, frame, state, k):
        if cfg.demo.svgf:
            svgf_payload = jnp.concatenate(
                [
                    state.svgf_colored.color_history,
                    state.svgf_colored.miu1[..., None],
                    state.svgf_colored.miu2[..., None],
                    state.svgf_white.color_history,
                    state.svgf_white.miu1[..., None],
                    state.svgf_white.miu2[..., None],
                ],
                axis=-1,
            )
        else:
            svgf_payload = None
        # mirror render_frame: TAA at mix weight 1 is the exact identity
        # (reference default) and its map half is statically elided
        taa_active = cfg.taa_on and (
            cfg.taa_force_full or float(cfg.taa_mix_weight) != 1.0
        )
        taa_payload = state.taa_history if taa_active else None
        if cfg.prec.is_f32:
            pos32 = None
        else:
            o32, d32 = primary_ray_grid(
                frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, jnp.float32
            )
            pos32 = o32 + g2d["t"].reshape(H, W)[..., None].astype(jnp.float32) * d32
        return generate_temporal_maps(
            g2d, frame, state, W, H, dt, k,
            svgf_payload=svgf_payload, taa_payload=taa_payload,
            n_meshes=scene.n_meshes, position_f32=pos32,
            want_taa=taa_active,
        )

    tmap_fn = jax.jit(tmaps)
    svgf_map, taa_map, svgf_taps, taa_taps = _timed(
        "Generate Temporal Map", stats, tmap_fn, g2d, frame, state, k_taa
    )

    shade_fn = jax.jit(
        lambda sin0, d, k: shade(
            scene, frame, sin0, view_dir=-d, prec=prec, cfg=cfg,
            first_round=True, no_gi=not cfg.gi_on, key=k,
        )
    )
    # production passes the f32-reconstructed primary positions into shade
    # (ShadeInput.position_f32); rebuild them here the same way
    if cfg.prec.is_f32:
        pos32_flat = None
    else:
        o32p, d32p = primary_ray_grid(
            frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, jnp.float32
        )
        pos32_flat = (
            o32p + g2d["t"].reshape(H, W)[..., None].astype(jnp.float32) * d32p
        ).reshape(H * W, 3)
    sin0 = gbuffer_to_shade_input(g_flat, position_f32=pos32_flat)
    out0 = _timed("Pixel Shade #1", stats, shade_fn, sin0, d, k0)

    di_fn = jax.jit(
        lambda src, lights, skips: _trace_di(
            scene, frame, src, lights, skips, prec, cfg
        )
    )
    di0 = _timed("Trace DI Ray #1", stats, di_fn, out0.source, out0.lights,
                 out0.skip_tri)

    acc_fn = jax.jit(lambda out, di: out.intensity + jnp.sum(di, axis=1) + out.di_sky)
    intensity0 = _timed("Accumulate DI #1", stats, acc_fn, out0, di0)
    intensity1 = jnp.zeros((R, 3), dt)

    if cfg.gi_on:
        from low_precision_raytracer.ops.trace import trace as _trace

        def gi_trace(o):
            maxt = jnp.where(o.gi_valid, 1e5, 0.0)
            hit = _trace(
                scene, frame, o.source, o.gi_direction, prec=prec, cfg=cfg,
                find_any=False, skip_tri=o.skip_tri,
                min_dist=prec.ray_moveforward_t, max_dist=maxt,
            )
            return _gi_shade_input(scene, frame, o, hit, prec)

        gi_fn = jax.jit(gi_trace)
        sin1 = _timed("Trace GI #1", stats, gi_fn, out0)
        shade1_fn = jax.jit(
            lambda sin1, vd, k: shade(
                scene, frame, sin1, view_dir=vd, prec=prec, cfg=cfg,
                first_round=False, no_gi=True, key=k,
            )
        )
        out1 = _timed("Shade #2", stats, shade1_fn, sin1, out0.view_dir_out, k1)
        di1 = _timed("Trace DI #2", stats, di_fn, out1.source, out1.lights,
                     out1.skip_tri)
        intensity1 = _timed("Accumulate DI #2", stats, acc_fn, out1, di1)

    # clean-colour split + the PRODUCTION denoiser: ONE vmapped pass over
    # both instances with the prefetched temporal taps (render_frame's
    # exact path — a single-instance run doubled would misprice it)
    clean, mul_c, mul_w = write_clean_color(
        intensity0.reshape(H, W, 3),
        intensity1.reshape(H, W, 3),
        out0.gi_multiplier.reshape(H, W, 3),
        cfg.demo,
    )
    if cfg.demo.svgf:
        def svgf_pair(mul_c, mul_w, svgf_map, svgf_taps, n, z, st):
            grad = preprocess_normal_depth(n, z)
            pre_c = (svgf_taps[..., 0:3], svgf_taps[..., 3], svgf_taps[..., 4])
            pre_w = (svgf_taps[..., 5:8], svgf_taps[..., 8], svgf_taps[..., 9])
            mul2 = jnp.stack([mul_c, mul_w])
            st2 = jax.tree_util.tree_map(
                lambda a, b: jnp.stack([a, b]), st.svgf_colored, st.svgf_white
            )
            pre2 = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), pre_c, pre_w)
            return svgf_denoise_pair(
                mul2, st2, svgf_map, n, z, grad, cfg.svgf,
                cfg.svgf.color_mix_weight, cfg.svgf.moments_mix_weight,
                prefetch2=pre2,
            )

        svgf_fn = jax.jit(svgf_pair)
        mul2, _ = _timed(
            "SVGF", stats, svgf_fn,
            mul_c, mul_w, svgf_map, svgf_taps, g2d["normal"], g2d["depth"], state,
        )
        mul_c, mul_w = mul2[0], mul2[1]

    color = add_denoised_color(
        clean, mul_c, mul_w, out0.albedo.reshape(H, W, 3), cfg.demo
    )
    if cfg.taa_on and taa_map is not None:
        taa_fn = jax.jit(
            lambda c, hist, tm, taps: temporal_anti_aliasing(
                c, hist, tm, cfg.taa_mix_weight, hist_pre=taps
            )
        )
        color = _timed("TAA", stats, taa_fn, color, state.taa_history, taa_map, taa_taps)

    backup_fn = jax.jit(
        lambda c, g2d: (
            tonemap_gamma(c),
            jnp.where(
                g2d["valid"],
                jnp.take(frame.obj_mesh, g2d["obj"], mode="clip"),
                -1,
            ).astype(jnp.int32),
        )
    )
    _timed("Backup Temporal Data", stats, backup_fn, color, g2d)

    from low_precision_raytracer.utils.timing import STAGE_NAMES

    # the canonical reference stage-name list lives in utils/timing.py; a
    # typo'd inline key here would silently diverge from it
    assert set(stats) <= set(STAGE_NAMES), sorted(set(stats) - set(STAGE_NAMES))
    total = sum(stats.values())
    stats["TOTAL (staged)"] = total
    return stats
