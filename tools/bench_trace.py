"""All-pairs trace on the GPU: the fused kernel (ops/dense_triton.py) against
the plain XLA route (ops/dense.py), at 1080p, on Cornell and the
Sponza-class scene, in fp32, bf16 and fp16.

    python tools/bench_trace.py launch   # primary launch: times + agreement
    python tools/bench_trace.py frame    # whole render_frame per route
    python tools/bench_trace.py trace    # profiler trace of a frame per route

Prints one JSON line per measurement, each naming the device.  Traces go to
chiprun_out/trace_<scene>_<precision>_<route>/.  Needs a GPU.
"""

import os as _os
import sys as _sys

# runnable as `python tools/<name>.py` from anywhere: put the repo root
# (this file's parent's parent) on sys.path before package imports
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.procedural import (
    cornell_box_scene,
    sponza_like_scene,
)
from low_precision_raytracer.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer.ops import dense_triton
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.dense import trace_rays_dense
from low_precision_raytracer.render.framestate import init_frame_state
from low_precision_raytracer.render.renderer import render_frame
from low_precision_raytracer.utils.device import require_gpu

W, H = 1920, 1080
SCENES = {"cornell": cornell_box_scene, "sponza": sponza_like_scene}
PRECISIONS = ("fp32", "bf16", "fp16")


def emit(device, **rec):
    print(json.dumps({**rec, "device": device}), flush=True)


def setup(scene_name, precision, width=W, height=H):
    cfg = RenderConfig(width=width, height=height, precision=precision, gi_on=True)
    host = SCENES[scene_name]()
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, cfg.prec, max_direct_lights=cfg.max_direct_lights,
                          width=width, height=height)
    return cfg, scene, frame


def primary_rays(frame, width=W, height=H):
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, width, height,
                            jnp.float32)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def timed(fn, *args, iters=10):
    """-> (compile+first-call seconds, steady seconds per call, output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / iters, out


def agreement(ref, got):
    """tri/obj agreement rate, and the share of agreeing hits within
    |dt| <= 1e-5 max(1, |t|), |du|, |dv| <= 1e-5."""
    rt, gt = np.asarray(ref.tri), np.asarray(got.tri)
    same = (rt == gt) & (np.asarray(ref.obj) == np.asarray(got.obj))
    hit = same & (rt >= 0)
    dt = np.abs(np.asarray(ref.t) - np.asarray(got.t))[hit]
    tt = np.maximum(1.0, np.abs(np.asarray(ref.t)[hit]))
    du = np.abs(np.asarray(ref.u) - np.asarray(got.u))[hit]
    dv = np.abs(np.asarray(ref.v) - np.asarray(got.v))[hit]
    within = (dt <= 1e-5 * tt) & (du <= 1e-5) & (dv <= 1e-5)
    within4 = (dt <= 1e-4 * tt) & (du <= 1e-4) & (dv <= 1e-4)
    return dict(
        tri_obj_agree=float(same.mean()),
        within_tol=float(within.mean()) if within.size else 1.0,
        within_tol_1e4=float(within4.mean()) if within4.size else 1.0,
        max_dt_rel=float((dt / tt).max()) if dt.size else 0.0,
        max_duv=float(max(du.max(), dv.max())) if du.size else 0.0,
        hit_rate=float((rt >= 0).mean()),
    )


def launch_one(device, scene_name, precision, iters=10):
    cfg, scene, frame = setup(scene_name, precision)
    o, d = primary_rays(frame)
    prec = cfg.prec
    xla = jax.jit(lambda fr, o, d: trace_rays_dense(scene, fr, o, d, prec=prec))
    ker = jax.jit(lambda fr, o, d: dense_triton.trace_rays_dense_triton(
        scene, fr, o, d, prec=prec))
    cx, tx, hx = timed(xla, frame, o, d, iters=iters)
    ck, tk, hk = timed(ker, frame, o, d, iters=iters)
    emit(device, part="launch", scene=scene_name, precision=precision,
         rays=int(o.shape[0]), instance_tris=int(frame.dense_n.shape[0]),
         xla_ms=tx * 1e3, kernel_ms=tk * 1e3, xla_first_s=cx, kernel_first_s=ck,
         **agreement(hx, hk))


def frame_one(device, scene_name, precision, impl, frames=5):
    cfg, scene, frame = setup(scene_name, precision)
    cfg = cfg.replace(traversal_impl=impl)
    state = init_frame_state(cfg, len(frame.obj_layout))
    keys = list(jax.random.split(jax.random.PRNGKey(0), frames + 2))
    t0 = time.perf_counter()
    img, aux, state = render_frame(scene, frame, state, cfg, keys[0])
    jax.block_until_ready(img)
    first = time.perf_counter() - t0
    img, aux, state = render_frame(scene, frame, state, cfg, keys[1])
    jax.block_until_ready(img)
    t0 = time.perf_counter()
    for k in keys[2:]:
        img, aux, state = render_frame(scene, frame, state, cfg, k)
    jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / frames
    emit(device, part="frame", scene=scene_name, precision=precision, impl=impl,
         ms_per_frame=dt * 1e3, first_frame_s=first,
         mrays_per_s=float(aux["n_rays"]) / dt / 1e6,
         finite=bool(np.isfinite(np.asarray(img)).all()))


STAGES = ("primary", "temporal_maps", "shade", "secondary", "svgf")


def hlo_scopes(compiled_text):
    """-> ({instruction name: stage scope}, [materialised f32 (rays x
    triangles) planes]) from an optimised HLO module.  A plane counts as
    materialised when an instruction outside every fusion body produces
    it: that buffer lives in device memory."""
    import re

    scope, planes = {}, []
    in_fused = False
    for line in compiled_text.splitlines():
        head = re.match(r"^(ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head and "=" not in line.split("{")[0]:
            in_fused = head.group(2).startswith("fused_") or "fused" in head.group(2)
            continue
        m = re.match(r"^\s*(ROOT )?%?([\w.\-]+) = (\S+)", line)
        if not m:
            continue
        name, shape = m.group(2), m.group(3)
        op = re.search(r'op_name="([^"]*)"', line)
        if op:
            parts = op.group(1).split("/")
            scope[name] = next((p for p in parts if p in STAGES), "other")
        if not in_fused and re.match(r"f32\[\d+,\d+\]", shape):
            dims = [int(x) for x in re.findall(r"\d+", shape.split("{")[0])[1:]]
            if len(dims) == 2 and min(dims) >= 1000 and max(dims) >= 10000:
                planes.append((name, shape.split("{")[0]))
    return scope, planes


def trace_frame(device, scene_name, precision, impl):
    """Profiler trace of one steady frame on `impl`: device time per stage
    (named scopes of render/renderer.py), busy share of the traced window,
    the top device ops, and the (rays x triangles) planes the optimised
    program materialises."""
    cfg, scene, frame = setup(scene_name, precision)
    cfg = cfg.replace(traversal_impl=impl)
    state = init_frame_state(cfg, len(frame.obj_layout))
    key = jax.random.PRNGKey(0)
    text = render_frame.lower(scene, frame, state, cfg, key).compile().as_text()
    scope, planes = hlo_scopes(text)
    for _ in range(2):
        img, aux, state = render_frame(scene, frame, state, cfg, key)
    jax.block_until_ready(img)
    out_dir = _os.path.join("chiprun_out", f"trace_{scene_name}_{precision}_{impl}")
    jax.profiler.start_trace(out_dir)
    t0 = time.perf_counter()
    img, aux, state = render_frame(scene, frame, state, cfg, key)
    jax.block_until_ready(img)
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    emit(device, part="trace", scene=scene_name, precision=precision, impl=impl,
         traced_frame_ms=wall * 1e3, materialised_planes=planes[:8],
         n_materialised_planes=len(planes), **reduce_trace(out_dir, scope))


def reduce_trace(out_dir, scope, top=12):
    """Device time by stage and by op from the newest .xplane.pb."""
    import glob

    path = sorted(glob.glob(_os.path.join(out_dir, "plugins", "profile", "*",
                                          "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    by_op, by_stage, spans = {}, {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                by_op[op] = by_op.get(op, 0.0) + ev.duration_ns
                st = scope.get(op, "other")
                by_stage[st] = by_stage.get(st, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        device_busy_ms=busy / 1e6,
        window_ms=window / 1e6,
        stage_ms={k: v / 1e6 for k, v in sorted(by_stage.items())},
        top_ops=[(name, scope.get(name, "other"), ns / 1e6) for name, ns in ranked],
    )


def main(argv):
    device = require_gpu()
    parts = argv or ["launch"]
    for part in parts:
        if part == "launch":
            for s in SCENES:
                for p in PRECISIONS:
                    launch_one(device, s, p)
        elif part == "frame":
            for s in SCENES:
                for p in PRECISIONS:
                    for impl in ("dense", "dense_triton"):
                        frame_one(device, s, p, impl)
        elif part == "trace":
            for s in SCENES:
                for impl in ("dense", "dense_triton"):
                    trace_frame(device, s, "bf16", impl)
        else:
            raise SystemExit(f"unknown part {part!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
