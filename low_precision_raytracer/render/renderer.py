"""The frame orchestrator (`Renderer<DataT>::render_cuda`,
`rt/gui/imgui_window.cu:121-283` — the 13-stage kernel schedule).

The whole schedule is ONE pure jitted step:

    image, aux, state = render_frame(scene, frame, state, cfg, key)

No per-stage host syncs (the reference's `cudaDeviceSynchronize` after every
launch exists only for its timing UI); the profiling harness re-creates the
per-stage timing dict with `block_until_ready` (render/profile.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import RenderConfig, get_precision
from low_precision_raytracer.models.scene import (
    HostScene,
    build_scene_arrays,
    flatten_frame,
)
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.compose import (
    add_denoised_color,
    tonemap_gamma,
    write_clean_color,
)
from low_precision_raytracer.ops.gbuffer import (
    fill_gbuffer,
    interpolate_hit_attributes,
)
from low_precision_raytracer.ops.reproject import generate_temporal_maps
from low_precision_raytracer.ops.shade import (
    SHADE_COMMON,
    SHADE_INVALID,
    SHADE_SKYBOX,
    ShadeInput,
    gbuffer_to_shade_input,
    shade,
)
from low_precision_raytracer.ops.svgf import (
    preprocess_normal_depth,
    svgf_denoise_pair,
)
from low_precision_raytracer.ops.taa import temporal_anti_aliasing
from low_precision_raytracer.ops.trace import trace
from low_precision_raytracer.render.framestate import FrameState, init_frame_state


def _trace_di(scene, frame, source, lights, skip_tri, prec, cfg):
    """`trace_di_light` (`rt/rtrt/cuda.hpp:2058-2081`): any-hit shadow ray per
    (pixel, light) command; invalid slots get max_dist 0 so their lanes
    terminate immediately (dense queues, no compaction — like the reference).

    -> di_intensity (R, L, 3) in the render dtype."""
    R = source.shape[0]
    L = lights.valid.shape[1]
    dt = prec.dtype
    if L == 0:
        return jnp.zeros((R, 0, 3), dt)
    # PIXEL-major command rows: the reshape stays local under the pixel-row
    # mesh
    o = jnp.broadcast_to(source[:, None, :], (R, L, 3)).reshape(R * L, 3)
    d = lights.direction.reshape(R * L, 3)
    maxt = jnp.where(lights.valid, lights.max_t.astype(jnp.float32), 0.0).reshape(R * L)
    skips = jnp.broadcast_to(skip_tri[:, None], (R, L)).reshape(R * L)
    hit = trace(
        scene,
        frame,
        o,
        d,
        prec=prec,
        cfg=cfg,
        find_any=True,
        skip_tri=skips,
        min_dist=prec.ray_moveforward_t,
        max_dist=maxt,
    )
    visible = hit.tri.reshape(R, L) < 0
    vis = (visible & lights.valid).astype(dt)[..., None]
    return vis * lights.multiplier


def _gi_shade_input(scene, frame, shade_out, hit, prec):
    """Closest GI hit -> next round's ShadeInput (COMMON / SKYBOX /
    INVALID), `trace_gi` (`rt/rtrt/cuda.hpp:2083-2141`)."""
    dt = prec.dtype
    attrs = interpolate_hit_attributes(scene, frame, hit, dt)
    got = hit.tri >= 0
    stype = jnp.where(
        shade_out.gi_valid,
        jnp.where(got, SHADE_COMMON, SHADE_SKYBOX),
        SHADE_INVALID,
    ).astype(jnp.int32)
    # f32 bounce-hit position: ray-origin chain o32 + t * d32 (t is f32,
    # the origin is the previous round's f32 source) — see
    # ShadeInput.position_f32
    pos32 = shade_out.source + hit.t[:, None] * shade_out.gi_direction.astype(
        jnp.float32
    )
    return ShadeInput(
        type=stype,
        position=attrs["position"],
        position_f32=pos32,
        normal=attrs["normal"],
        tangent=attrs["tangent"],
        color=attrs["color"],
        uv0=attrs["uv0"],
        uv1=attrs["uv1"],
        material=attrs["material"],
        obj=jnp.maximum(hit.obj, 0),
        tri=jnp.maximum(hit.tri, 0),
    )


def _trace_di_gi(scene, frame, shade_out, prec, cfg, *, want_gi):
    """The round's shadow rays and (optionally) its GI bounce ray share one
    trace launch — both depend only on this round's shade output, and a
    launch has a fixed cost (prep + dispatch) worth paying once, not twice.
    The fused launch runs closest-hit for all lanes (visible := no hit, the
    same predicate as any-hit).

    -> (di_intensity (R, L, 3), gi ShadeInput | None)."""
    R = shade_out.source.shape[0]
    L = shade_out.lights.valid.shape[1]
    dt = prec.dtype
    lights = shade_out.lights
    if not want_gi or L == 0:
        di = _trace_di(
            scene, frame, shade_out.source, lights, shade_out.skip_tri, prec, cfg,
        ) if L else jnp.zeros((R, 0, 3), dt)
        sin_next = None
        if want_gi:
            maxt = jnp.where(shade_out.gi_valid, 1e5, 0.0)
            hit = trace(
                scene, frame, shade_out.source, shade_out.gi_direction,
                prec=prec, cfg=cfg, find_any=False,
                skip_tri=shade_out.skip_tri,
                min_dist=prec.ray_moveforward_t,
                max_dist=maxt,
            )
            sin_next = _gi_shade_input(scene, frame, shade_out, hit, prec)
        return di, sin_next

    # PIXEL-major fused lanes: row i*(L+1)+l = pixel i's l-th shadow ray,
    # row i*(L+1)+L = its GI bounce ray.  Pixel-major keeps the
    # (R, L+1) -> (R*(L+1),) reshape a local operation under the pixel-row
    # mesh (a global block concat would make GSPMD all-gather the rays).
    K = L + 1
    o = jnp.broadcast_to(shade_out.source[:, None, :], (R, K, 3)).reshape(R * K, 3)
    d = jnp.concatenate(
        [lights.direction, shade_out.gi_direction[:, None, :]], axis=1
    ).reshape(R * K, 3)
    maxt_sh = jnp.where(lights.valid, lights.max_t.astype(jnp.float32), 0.0)
    maxt_gi = jnp.where(shade_out.gi_valid, 1e5, 0.0)
    maxt = jnp.concatenate([maxt_sh, maxt_gi[:, None]], axis=1).reshape(R * K)
    skips = jnp.broadcast_to(shade_out.skip_tri[:, None], (R, K)).reshape(R * K)
    hit = trace(
        scene, frame, o, d,
        prec=prec, cfg=cfg, find_any=False,
        skip_tri=skips,
        min_dist=prec.ray_moveforward_t,
        max_dist=maxt,
    )
    tri_rk = hit.tri.reshape(R, K)
    visible = tri_rk[:, :L] < 0
    vis = (visible & lights.valid).astype(dt)[..., None]
    di = vis * lights.multiplier
    hit_gi = jax.tree.map(lambda x: x.reshape(R, K)[:, L], hit)
    return di, _gi_shade_input(scene, frame, shade_out, hit_gi, prec)


@partial(jax.jit, static_argnames=("cfg",))
def render_frame(scene, frame, state: FrameState, cfg: RenderConfig, key):
    """One full frame.  -> (image (H, W, 3) f32 gamma-encoded, aux, state)."""
    prec = get_precision(cfg.precision)
    dt = prec.dtype
    H, W = cfg.height, cfg.width
    R = H * W
    # GI needs at least one bounce round beyond the primary shade
    # (reference hardcodes max_bounces=2, `rt/gui/imgui_window.cu:356`;
    # here the round count is the config knob)
    gi_rounds = cfg.max_bounces - 1 if cfg.gi_on else 0
    k_taa, k_shade0, *k_rounds = jax.random.split(key, 2 + max(gi_rounds, 1))

    # ---- primary rays + traced G-buffer ("Primary Ray" stage).  Each
    # stage below runs under a jax.named_scope (primary, temporal_maps,
    # shade, secondary, svgf), which tools/bench_trace.py reads back from a
    # profiler trace to split the device time by stage.
    # The camera grid is generated in f32 in EVERY precision mode and
    # handed to trace as-is.  Deliberate deviation from the reference
    # (which generates DataT primary rays, `rt/rtrt/cuda.hpp:950-961`): a
    # bf16 direction carries ~2^-9 rad of error ≈ 2.3 PIXELS of angular
    # wobble at 1080p — measured as the dominant term of the bf16-vs-fp32
    # gap (silhouette flip bands + displaced shadow boundaries).  The low-precision claim lives in the INTERSECTION
    # test, which quantises each ray to the render dtype itself.
    o32g, d32g = primary_ray_grid(
        frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H, jnp.float32
    )
    o = o32g.reshape(R, 3)
    d32 = d32g.reshape(R, 3)
    # shade's view_dir: full f32 under shade_f32 (a dtype round-trip would
    # re-quantize it), render dtype otherwise
    d = d32 if (cfg.prec.is_f32 or cfg.shade_f32) else d32.astype(dt)
    with jax.named_scope("primary"):
        g_flat, _ = fill_gbuffer(scene, frame, o, d32, prec, cfg=cfg)
    g2d = {k: v.reshape((H, W) + v.shape[1:]) for k, v in g_flat.items()}

    # ---- "Generate Temporal Map" (+ all temporal history fetched in the
    # same two gathers — one per tap set)
    if not cfg.demo.svgf:
        svgf_payload = None
    else:
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
        )  # (H, W, 10)
    # TAA at mix weight exactly 1 is the identity: the reference's own
    # default (`taa_mix_weight = 1`, `rt/gui/imgui_window.cu:99`) makes its
    # TAA kernel compute `hist * 0 + color * 1` — and `value_or` launders
    # non-finite history first (`rt/rtrt/cuda.hpp:2436-2438`), so the result
    # is bitwise `color`.  XLA cannot prove that (it can't rule out
    # non-finite history, so `hist * 0` never folds); the weight is static
    # config, so the whole TAA half — jitter RNG, second footprint, its
    # validation gather, history fetch, blend — is elided HERE instead.
    # Any weight < 1 takes the full path (tested bitwise-equal at w=1 in
    # tests/test_reproject.py).
    taa_active = cfg.taa_on and (
        cfg.taa_force_full or float(cfg.taa_mix_weight) != 1.0
    )
    taa_payload = state.taa_history if taa_active else None
    # f32 hit positions for reprojection: o32 + t * d32 over an f32 camera
    # grid (hit.t is always f32).  In bf16 mode the render-dtype G-buffer
    # position wobbles the reprojected footprint by pixels, rejecting
    # history and knocking the temporal gathers off their fast path.
    if cfg.prec.is_f32:
        pos32 = None
    else:
        pos32 = o32g + g2d["t"].reshape(H, W)[..., None].astype(jnp.float32) * d32g
    with jax.named_scope("temporal_maps"):
        svgf_map, taa_map, svgf_taps, taa_taps = generate_temporal_maps(
            g2d, frame, state, W, H, dt, k_taa,
            svgf_payload=svgf_payload, taa_payload=taa_payload,
            n_meshes=scene.n_meshes, position_f32=pos32,
            mesh=cfg.mesh,  # multi-device: halo-exchange fetch, no all-gathers
            want_taa=taa_active,
        )

    # ---- "Pixel Shade #1" (f32 primary hit positions anchor the light
    # geometry + ray origins in low-precision modes, ShadeInput.position_f32)
    sin0 = gbuffer_to_shade_input(
        g_flat,
        position_f32=None if pos32 is None else pos32.reshape(R, 3),
    )
    with jax.named_scope("shade"):
        out0 = shade(
            scene, frame, sin0, view_dir=-d, prec=prec, cfg=cfg,
            first_round=True, no_gi=gi_rounds == 0, key=k_shade0,
        )

    # ---- "Trace DI Ray #1" + "Trace GI #1" (+ "Accumulate DI #1", skybox
    # radiance): the round's shadow and bounce rays share one launch
    with jax.named_scope("secondary"):
        di0, sin_next = _trace_di_gi(
            scene, frame, out0, prec, cfg, want_gi=gi_rounds >= 1,
        )
    intensity0 = out0.intensity + jnp.sum(di0, axis=1) + out0.di_sky

    n_rays = jnp.asarray(R, jnp.int32) + jnp.sum(out0.lights.valid.astype(jnp.int32))

    # ---- GI rounds ("Shade #k+1", fused "Trace DI #k+1" + "Trace GI #k+1",
    # "Accumulate #k+1"), `cfg.max_bounces - 1` of them.  Round-1 radiance
    # feeds the SVGF colored/white demodulation channels directly (the
    # reference's two-bounce schedule); deeper rounds fold in multiplied by
    # the BRDF path throughput of the intermediate bounces.
    intensity1 = jnp.zeros((R, 3), dt)
    out_prev = out0
    path_mult = jnp.ones((R, 3), dt)
    for r in range(1, gi_rounds + 1):
        last = r == gi_rounds
        with jax.named_scope("shade"):
            out_r = shade(
                scene, frame, sin_next, view_dir=out_prev.view_dir_out,
                prec=prec, cfg=cfg, first_round=False,
                # the reference shades its final bounce with NO_GI=true
                no_gi=last, key=k_rounds[r - 1],
            )
        with jax.named_scope("secondary"):
            di_r, sin_next = _trace_di_gi(
                scene, frame, out_r, prec, cfg, want_gi=not last,
            )
        contrib = out_r.intensity + jnp.sum(di_r, axis=1) + out_r.di_sky
        intensity1 = intensity1 + path_mult * contrib
        n_rays = (
            n_rays
            + jnp.sum(out_prev.gi_valid.astype(jnp.int32))
            + jnp.sum(out_r.lights.valid.astype(jnp.int32))
        )
        if not last:
            # gi_multiplier is full-RGB BRDF weight on bounce rounds
            # (no demodulation tag past round 0) and zero on invalid lanes
            path_mult = path_mult * out_r.gi_multiplier
            out_prev = out_r

    # ---- "SVGF" block: clean colour split + two denoiser instances
    clean, mul_c, mul_w = write_clean_color(
        intensity0.reshape(H, W, 3),
        intensity1.reshape(H, W, 3),
        out0.gi_multiplier.reshape(H, W, 3),
        cfg.demo,
    )
    new_colored, new_white = state.svgf_colored, state.svgf_white
    if cfg.demo.svgf:
        normal2d = g2d["normal"]
        depth2d = g2d["depth"]
        grad = preprocess_normal_depth(normal2d, depth2d)
        # batch the two independent denoiser instances (GI-colored and
        # GI-white, `rt/gui/imgui_window.cu:231-239`) through ONE vmapped
        # pass: every stencil/filter runs once on (2, H, W) instead of
        # twice on (H, W), halving kernel dispatches
        mul2 = jnp.stack([mul_c, mul_w])
        st2 = jax.tree_util.tree_map(
            lambda a, b: jnp.stack([a, b]), state.svgf_colored, state.svgf_white
        )
        pre_c = (svgf_taps[..., 0:3], svgf_taps[..., 3], svgf_taps[..., 4])
        pre_w = (svgf_taps[..., 5:8], svgf_taps[..., 8], svgf_taps[..., 9])
        pre2 = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), pre_c, pre_w)
        with jax.named_scope("svgf"):
            mul2, new_st2 = svgf_denoise_pair(
                mul2, st2, svgf_map, normal2d, depth2d, grad, cfg.svgf,
                cfg.svgf.color_mix_weight, cfg.svgf.moments_mix_weight,
                prefetch2=pre2, mesh=cfg.mesh,
            )
        mul_c, mul_w = mul2[0], mul2[1]
        new_colored = jax.tree_util.tree_map(lambda x: x[0], new_st2)
        new_white = jax.tree_util.tree_map(lambda x: x[1], new_st2)
    color = add_denoised_color(
        clean, mul_c, mul_w, out0.albedo.reshape(H, W, 3), cfg.demo
    )

    # ---- "TAA" (identity at mix weight 1 — statically elided, see above)
    if taa_active:
        color = temporal_anti_aliasing(
            color, state.taa_history, taa_map, cfg.taa_mix_weight,
            hist_pre=taa_taps,
        )
    # keep the carried dtype stable (the f32 DI accumulation promotes
    # `color` to f32 in low-precision modes; a dtype change in a carried
    # leaf would retrace the jitted step on frame 2)
    new_taa_history = color.astype(state.taa_history.dtype)

    # ---- output + "Backup Temporal Data"
    image = tonemap_gamma(color)

    mesh_id = jnp.where(
        g2d["valid"], jnp.take(frame.obj_mesh, g2d["obj"], mode="clip"), -1
    ).astype(jnp.int32)

    new_state = FrameState(
        svgf_colored=new_colored,
        svgf_white=new_white,
        taa_history=new_taa_history,
        svgf_frame_count=svgf_map["frame_count"],
        last_mesh_id=mesh_id,
        last_prim=g2d["tri"].astype(jnp.int32),
        # per-OBJECT backup: keying by shared mesh would reproject every
        # instance through the last writer's transform (see FrameState)
        last_l2w=frame.obj_l2w_f32,
        last_w2c=frame.cam_w2c,
    )
    aux = dict(
        clean=clean,
        gi_colored=mul_c,
        gi_white=mul_w,
        albedo=out0.albedo.reshape(H, W, 3),
        valid=g2d["valid"],
        hit_t=g2d["t"].reshape(H, W),
        n_rays=n_rays,
    )
    return image, aux, new_state


class Renderer:
    """Host-side convenience wrapper: owns the device scene + frame state and
    runs the jitted step per frame (the `Renderer` class of the framework,
    SURVEY.md 2.20)."""

    def __init__(self, host_scene: HostScene, cfg: RenderConfig):
        from low_precision_raytracer.ops.trace import resolve_cfg

        self.host = host_scene
        self.prec = get_precision(cfg.precision)
        self.scene = build_scene_arrays(host_scene, self.prec, leaf_size=cfg.bvh_leaf_size)
        frame0 = flatten_frame(
            host_scene, self.prec, max_direct_lights=cfg.max_direct_lights,
            width=cfg.width, height=cfg.height,
        )
        self.cfg = resolve_cfg(self.scene, frame0, cfg)  # bake 'auto' backend
        self.state = init_frame_state(self.cfg, len(frame0.obj_layout))
        self.frame_index = 0
        from low_precision_raytracer.utils.rng import render_key

        self.key = render_key(0)

    def render(self, time: float = 0.0):
        """Flatten the scene at `time` (TLAS rebuild on host, like the
        reference's per-frame `scene_bvh.update`) and render one frame."""
        frame = flatten_frame(
            self.host,
            self.prec,
            time=time,
            max_direct_lights=self.cfg.max_direct_lights,
            width=self.cfg.width,
            height=self.cfg.height,
        )
        self.key, sub = jax.random.split(self.key)
        image, aux, self.state = render_frame(self.scene, frame, self.state, self.cfg, sub)
        self.frame_index += 1
        return image, aux
