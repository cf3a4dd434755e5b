"""Benchmark entry: prints one JSON line per metric, the HEADLINE metric
last.  Every line names the device it ran on; a backend without a GPU is
refused.

Headline: Mrays/s at bf16 on the Cornell-box pipeline at 1080p (GI on,
SVGF + TAA on).  Ray count = primary + valid shadow + valid bounce + valid
bounce-shadow lanes, measured on device.  Frame times are taken to
`jax.block_until_ready`.

Secondary lines: bf16 parity (direct PSNR/SSIM + the ground-truth
delta form), fp16 parity + fp32-fallback rate (the reference's flagship
precision, `rt/gui/imgui_window.cu:746-752`), and the Sponza-class
(BASELINE config 5) 1080p frame time.

Extra diagnostics (fps, fp32 comparison) go to stderr.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import numpy as np


def parity_at_spec(width=1920, height=1080, precision="bf16", frames=8,
                   truth_frames=0, conv_frames=0):
    """North-star parity, BOTH forms:

    - direct:  PSNR/SSIM(low-precision @ frames, fp32 @ frames) — the
      difference metric reported since round 1;
    - ground-truth (truth_frames > 0): PSNR(low @ frames, truth) vs
      PSNR(fp32 @ frames, truth), the literal reading of "bf16+SVGF within
      1 dB of fp32" — both pipelines scored against the SAME converged
      reference, the DELTA between the scores is the headline.  Truth = the
      linear-space average of `truth_frames` INDEPENDENT 1 spp fp32 frames
      with the denoiser/TAA off (per-frame fresh keys, no shared temporal
      history — an fp32-pipeline-derived truth like "fp32 at frame 32"
      would share its history with the fp32 candidate and inflate its
      score).
    - converged-candidate (conv_frames > frames, needs truth_frames): the
      SAME delta with both candidates run to `conv_frames` of temporal
      accumulation.  The 8-frame window still carries residual Monte-Carlo
      noise, which the delta form counts against whichever pipeline has
      more per-pixel variation (a block-flattened image can score BETTER
      at 8 frames despite being a worse renderer).
      At 32 frames both candidates are near their accumulation fixpoint,
      so the residual delta isolates the persistent dtype bias.

    Returns dict(psnr, ssim[, psnr_vs_truth, fp32_psnr_vs_truth, delta_db,
    delta_db_converged]).
    """
    from low_precision_raytracer.config import DemoSettings, RenderConfig
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.render.renderer import Renderer
    from low_precision_raytracer.utils.image import psnr, ssim

    assert precision != "fp32", "parity compares a low-precision run vs fp32"
    imgs = {}
    imgs_conv = {}
    for prec in ("fp32", precision):
        cfg = RenderConfig(width=width, height=height, precision=prec, gi_on=True)
        r = Renderer(cornell_box_scene(), cfg)
        img = None
        for i in range(max(frames, conv_frames)):
            img, _ = r.render()
            if i + 1 == frames:
                imgs[prec] = np.asarray(img)
        if conv_frames > frames:
            imgs_conv[prec] = np.asarray(img)
    out = dict(
        psnr=psnr(imgs["fp32"], imgs[precision]),
        ssim=ssim(imgs["fp32"], imgs[precision]),
    )
    if truth_frames > 0:
        cfg = RenderConfig(width=width, height=height, precision="fp32",
                           gi_on=True, taa_on=False,
                           demo=DemoSettings(svgf=False))
        r = Renderer(cornell_box_scene(), cfg)
        acc = np.zeros((height, width, 3), np.float64)
        for _ in range(truth_frames):
            img, _ = r.render()
            # accumulate in LINEAR radiance (the renderer gamma-encodes)
            acc += np.asarray(img, np.float64) ** 2.2
        truth = np.clip((acc / truth_frames) ** (1.0 / 2.2), 0.0, 1.0).astype(
            np.float32
        )
        p_low = psnr(truth, imgs[precision])
        p_f32 = psnr(truth, imgs["fp32"])
        out.update(psnr_vs_truth=p_low, fp32_psnr_vs_truth=p_f32,
                   delta_db=p_f32 - p_low)
        if imgs_conv:
            pc_low = psnr(truth, imgs_conv[precision])
            pc_f32 = psnr(truth, imgs_conv["fp32"])
            out.update(psnr_vs_truth_converged=pc_low,
                       fp32_psnr_vs_truth_converged=pc_f32,
                       delta_db_converged=pc_f32 - pc_low)
    return out


def fallback_rate(width=256, height=256, precision="fp16"):
    """fp32-fallback rate of the low-precision triangle test (the metric
    the CUDA reference cannot observe, SURVEY.md §5.5) on the Cornell
    primary launch."""
    from low_precision_raytracer.config import RenderConfig, get_precision
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.models.scene import (
        build_scene_arrays,
        flatten_frame,
    )
    from low_precision_raytracer.ops.camera import primary_ray_grid
    from low_precision_raytracer.ops.diagnostics import (
        fallback_rate as _rate,
    )

    prec = get_precision(precision)
    cfg = RenderConfig(width=width, height=height, precision=precision)
    host = cornell_box_scene()
    scene = build_scene_arrays(host, prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, prec, max_direct_lights=cfg.max_direct_lights,
                          width=width, height=height)
    o, d = primary_ray_grid(frame.cam_l2w, frame.cam_fov_y, width, height,
                            prec.dtype)
    return float(
        _rate(frame, o.reshape(-1, 3), d.reshape(-1, 3), prec)["rate"]
    )


def bench(width=1920, height=1080, precision="bf16", frames=20, warmup=3,
          scene_builder=None, label="Cornell", reps=1):
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.models.scene import build_scene_arrays, flatten_frame
    from low_precision_raytracer.render.framestate import init_frame_state
    from low_precision_raytracer.render.renderer import render_frame

    cfg = RenderConfig(width=width, height=height, precision=precision, gi_on=True)
    host = scene_builder() if scene_builder is not None else cornell_box_scene()
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(
        host, cfg.prec, max_direct_lights=cfg.max_direct_lights, width=width, height=height
    )
    from low_precision_raytracer.ops.trace import resolve_cfg

    cfg = resolve_cfg(scene, frame, cfg)
    state = init_frame_state(cfg, len(frame.obj_layout))
    from low_precision_raytracer.utils.rng import render_key

    key = render_key(0)

    assert warmup >= 1, "first frame compiles; it must not be timed"
    image = None
    for i in range(warmup):
        key, sub = jax.random.split(key)
        image, aux, state = render_frame(scene, frame, state, cfg, sub)
    jax.block_until_ready(image)
    subs = list(jax.random.split(key, frames))

    # `reps` independent timed loops -> median-of-reps frame time with a
    # min/max spread
    rep_dts = []
    ray_counts = []
    for rep in range(max(1, reps)):
        t0 = time.perf_counter()
        for i in range(frames):
            image, aux, state = render_frame(scene, frame, state, cfg, subs[i])
            # hold the device scalar; reading it here would sync every frame
            if rep == 0:
                ray_counts.append(aux["n_rays"])
        jax.block_until_ready(image)
        rep_dts.append((time.perf_counter() - t0) / frames)
    dt = float(np.median(rep_dts))
    # average valid-ray count of the TIMED frames (per-frame counts vary
    # with the sampled bounce/shadow validity, so a warmup frame's count
    # would skew the metric)
    n_rays = float(sum(int(c) for c in ray_counts)) / frames

    mrays = n_rays / dt / 1e6
    spread = ""
    if len(rep_dts) > 1:
        spread = (
            f" [median of {len(rep_dts)}; {min(rep_dts) * 1e3:.1f}"
            f"-{max(rep_dts) * 1e3:.1f} ms]"
        )
    print(
        f"[bench] {label} {precision} {width}x{height}: {dt * 1e3:.1f} ms/frame "
        f"({1 / dt:.2f} fps), {n_rays / 1e6:.2f} Mrays/frame -> {mrays:.1f} Mrays/s"
        f"{spread}",
        file=sys.stderr,
    )
    return mrays, dt, n_rays, rep_dts


def main():
    from low_precision_raytracer.models.procedural import sponza_like_scene
    from low_precision_raytracer.utils.device import require_gpu

    device = require_gpu()

    def emit(rec):
        print(json.dumps({**rec, "device": device}), flush=True)

    # parity + secondary metric lines first; the headline stays LAST
    pr = parity_at_spec(truth_frames=64, conv_frames=32)
    emit({
        "metric": "PSNR bf16+SVGF vs fp32, Cornell 1080p 8 frames",
        "value": float(pr["psnr"]),
        "unit": "dB",
        "ssim": float(pr["ssim"]),
        "psnr_vs_truth_bf16": float(pr["psnr_vs_truth"]),
        "psnr_vs_truth_fp32": float(pr["fp32_psnr_vs_truth"]),
        "delta_db_vs_truth": float(pr["delta_db"]),
        "delta_db_vs_truth_32f": float(pr["delta_db_converged"]),
        "psnr_vs_truth_bf16_32f": float(pr["psnr_vs_truth_converged"]),
        "psnr_vs_truth_fp32_32f": float(pr["fp32_psnr_vs_truth_converged"]),
        "target": "direct PSNR >= 30 dB AND ground-truth delta <= 1 dB",
    })
    # fp16: the reference's FLAGSHIP precision
    # (`rt/gui/imgui_window.cu:746-752`) measured end-to-end
    pr16 = parity_at_spec(precision="fp16")
    emit({
        "metric": "PSNR fp16+SVGF vs fp32, Cornell 1080p 8 frames",
        "value": float(pr16["psnr"]),
        "unit": "dB",
        "ssim": float(pr16["ssim"]),
        "fp32_fallback_rate": fallback_rate(precision="fp16"),
        "target": "PSNR(fp16, fp32) >= 30 dB",
    })
    f_mrays, f_dt, f_rays, f_reps = bench(
        precision="fp16", frames=6, warmup=2, reps=3, label="Cornell-fp16",
    )
    emit({
        "metric": "Mrays/s fp16 Cornell 1080p (GI+SVGF+TAA)",
        "value": f_mrays,
        "unit": "Mrays/s",
        "ms_per_frame": f_dt * 1e3,
        "spread_ms": [x * 1e3 for x in sorted(f_reps)],
    })
    # Sponza-class second metric (BASELINE config 5): the north star
    # tracked on a reference-class scene, not just Cornell
    s_mrays, s_dt, s_rays, s_reps = bench(
        frames=6, warmup=2, scene_builder=sponza_like_scene,
        label="Sponza-class", reps=3,
    )
    emit({
        "metric": "Sponza-class 1080p bf16 full frame (GI+SVGF+TAA)",
        "value": s_dt * 1e3,
        "unit": "ms/frame",
        "mrays_per_s": s_mrays,
        "spread_ms": [x * 1e3 for x in sorted(s_reps)],
    })
    mrays, dt, n_rays, reps = bench(frames=10, reps=5)
    emit({
        "metric": "Mrays/s bf16 Cornell 1080p (GI+SVGF+TAA)",
        "value": mrays,
        "unit": "Mrays/s",
        "ms_per_frame": dt * 1e3,
        "spread_mrays": [n_rays / x / 1e6 for x in sorted(reps, reverse=True)],
    })


if __name__ == "__main__":
    main()
