"""Smoke test of the renderer on GPUs: drives the user entry points once at
full width and checks what comes out.  Everything runs in this one process
(a second JAX process could not reserve the card's memory).

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --four-cards  # only the 4-card sharded frame

One card:
  1. device: JAX must run on a GPU; prints the card's name and power limit;
  2. main path: `Renderer` on Cornell at 1920x1080 in bf16, fp16 and fp32
     (finite, not black; bf16 and fp16 >= 30 dB PSNR against fp32 at the
     same frame count), Sponza-class at 1920x1080 bf16, and one frame
     through the CLI's `render` subcommand to a PNG;
  3. large scene: `sponza_like_scene(8, 3)` (82,690 instance-triangles)
     at 256x256 bf16 through the BVH walk;
  4. kernel check: the fused all-pairs kernel against the XLA reference on
     1080p primary rays of both scenes, in all three precisions.

Four cards: `render_frame_sharded` over a 4-GPU pixel-row mesh, 3 frames
of Cornell at 1920x1080 bf16, against the same frames with the same keys
on one card (PSNR >= 40 dB and >= 99% of pixels within 1/255).

No phase catches its own failure: any failure exits non-zero.  The last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import time
import zlib

import numpy as np

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
W, H = 1920, 1080


def log(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


def check_image(img, what: str) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if not np.isfinite(img).all():
        raise AssertionError(f"{what}: non-finite pixels")
    if img.mean() <= 0.01:
        raise AssertionError(f"{what}: black image (mean {img.mean()})")
    return img


def read_png_rgb(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG written with filter type 0 (utils/image.py)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise AssertionError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


def render_frames(host, cfg, n_frames):
    """-> (last image, compile+first frame s, steady ms per frame, route)."""
    import jax

    from low_precision_raytracer.render.renderer import Renderer

    t0 = time.perf_counter()
    r = Renderer(host, cfg)
    img, _ = r.render()
    jax.block_until_ready(img)
    first = time.perf_counter() - t0
    times = []
    for _ in range(n_frames - 1):
        t0 = time.perf_counter()
        img, _ = r.render()
        jax.block_until_ready(img)
        times.append(time.perf_counter() - t0)
    return img, first, 1e3 * float(np.mean(times)), r.cfg.traversal_impl


def main_path(card):
    from low_precision_raytracer.cli import main as cli_main
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer.utils.image import psnr

    n_frames = 4
    imgs = {}
    for p in ("fp32", "bf16", "fp16"):
        cfg = RenderConfig(width=W, height=H, precision=p, gi_on=True)
        img, first, ms, impl = render_frames(cornell_box_scene(), cfg, n_frames)
        imgs[p] = check_image(img, f"cornell {p}")
        log(card, f"cornell {W}x{H} {p} trace={impl}: compile+first frame {first:.2f} s")
        log(card, f"cornell {W}x{H} {p} trace={impl}: {ms:.3f} ms/frame "
                  f"(mean of {n_frames - 1} frames after warm-up)")
    for p in ("bf16", "fp16"):
        q = psnr(imgs["fp32"], imgs[p])
        log(card, f"cornell {p} vs fp32 at frame {n_frames}: PSNR {q:.3f} dB")
        if not q >= 30.0:
            raise AssertionError(f"{p} vs fp32 PSNR {q:.3f} dB < 30 dB")

    cfg = RenderConfig(width=W, height=H, precision="bf16", gi_on=True)
    img, first, ms, impl = render_frames(sponza_like_scene(), cfg, 3)
    check_image(img, "sponza-class bf16")
    log(card, f"sponza-class {W}x{H} bf16 trace={impl}: compile+first frame {first:.2f} s")
    log(card, f"sponza-class {W}x{H} bf16 trace={impl}: {ms:.3f} ms/frame "
              "(mean of 2 frames after warm-up)")

    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "smoke_cli_cornell_bf16.png")
    rc = cli_main(["render", "cornell", "--width", str(W), "--height", str(H),
                   "--precision", "bf16", "--frames", "1", "--out", png])
    if rc != 0:
        raise AssertionError(f"cli render exited {rc}")
    px = read_png_rgb(png)
    if px.shape != (H, W, 3) or px.mean() < 2.0:
        raise AssertionError(f"cli PNG {px.shape} mean {px.mean()}")
    log(card, f"cli render -> {os.path.basename(png)} {px.shape[1]}x{px.shape[0]}, "
              f"mean pixel {px.mean():.2f}/255")


def large_scene(card):
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.models.procedural import sponza_like_scene

    host = sponza_like_scene(pillar_grid=8, sphere_subdiv=3)
    cfg = RenderConfig(width=256, height=256, precision="bf16", gi_on=True)
    img, first, ms, impl = render_frames(host, cfg, 2)
    check_image(img, "large colonnade")
    if impl != "jax":
        raise AssertionError(f"large scene routed to {impl!r}, not the BVH walk")
    log(card, f"colonnade-83k 256x256 bf16 trace={impl}: compile+first frame "
              f"{first:.2f} s, {ms:.3f} ms/frame")


def kernel_check(card):
    import jax
    import jax.numpy as jnp

    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.models.procedural import (
        cornell_box_scene,
        sponza_like_scene,
    )
    from low_precision_raytracer.models.scene import build_scene_arrays, flatten_frame
    from low_precision_raytracer.ops.camera import primary_ray_grid
    from low_precision_raytracer.ops.dense import trace_rays_dense
    from low_precision_raytracer.ops.dense_triton import trace_rays_dense_triton

    def timed(fn, *args):
        out = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(5):
            out = fn(*args)
        jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / 5 * 1e3

    for name, build in (("cornell", cornell_box_scene), ("sponza-class", sponza_like_scene)):
        host = build()
        for p in ("fp32", "bf16", "fp16"):
            cfg = RenderConfig(width=W, height=H, precision=p)
            scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
            frame = flatten_frame(host, cfg.prec, width=W, height=H)
            o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, W, H,
                                    jnp.float32)
            o, d = o.reshape(-1, 3), d.reshape(-1, 3)
            prec = cfg.prec
            ref, t_ref = timed(jax.jit(lambda fr, o, d: trace_rays_dense(
                scene, fr, o, d, prec=prec)), frame, o, d)
            got, t_k = timed(jax.jit(lambda fr, o, d: trace_rays_dense_triton(
                scene, fr, o, d, prec=prec)), frame, o, d)
            rt, gt = np.asarray(ref.tri), np.asarray(got.tri)
            same = (rt == gt) & (np.asarray(ref.obj) == np.asarray(got.obj))
            hit = same & (rt >= 0)
            tt = np.abs(np.asarray(ref.t))[hit]
            dt = np.abs(np.asarray(ref.t) - np.asarray(got.t))[hit]
            duv = np.maximum(np.abs(np.asarray(ref.u) - np.asarray(got.u)),
                             np.abs(np.asarray(ref.v) - np.asarray(got.v)))[hit]
            within = (dt <= 1e-5 * np.maximum(1.0, tt)) & (duv <= 1e-5)
            ok = float(np.mean(within)) if hit.any() else 1.0
            log(card, f"kernel {name} {p} 1080p primary: tri/obj agree "
                      f"{same.mean():.6f}; of those, |dt| <= 1e-5*max(1,|t|) and "
                      f"|du|,|dv| <= 1e-5 on {ok:.6f}; dense_triton {t_k:.3f} ms, "
                      f"XLA dense {t_ref:.3f} ms")
            # Both sides evaluate the same f32 expressions in another
            # summation order.  u = Ox + t*Dx cancels terms as large as the
            # ray origin's barycentric coordinates (~1e3 for small, distant
            # triangles), so a few ulps of those terms exceed 1e-5 in u on a
            # fraction of a percent of hits: the share is printed and held
            # to 99%, and tri/obj agreement to 99.9%.
            if not (same.mean() >= 0.999 and ok >= 0.99):
                raise AssertionError(f"kernel disagrees with the reference ({name} {p})")


def four_cards(card):
    import jax

    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.models.scene import build_scene_arrays, flatten_frame
    from low_precision_raytracer.ops.trace import resolve_cfg
    from low_precision_raytracer.parallel.tiling import (
        make_pixel_mesh,
        render_frame_sharded,
    )
    from low_precision_raytracer.render.framestate import init_frame_state
    from low_precision_raytracer.render.renderer import render_frame
    from low_precision_raytracer.utils.image import psnr
    from low_precision_raytracer.utils.rng import render_key

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    cfg = RenderConfig(width=W, height=H, precision="bf16", gi_on=True)
    host = cornell_box_scene()
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, cfg.prec, max_direct_lights=cfg.max_direct_lights,
                          width=W, height=H)
    cfg = resolve_cfg(scene, frame, cfg)
    keys = list(jax.random.split(render_key(0), 3))
    mesh = make_pixel_mesh(4)
    one = init_frame_state(cfg, len(frame.obj_layout))
    four = one
    for i, k in enumerate(keys):
        t0 = time.perf_counter()
        img1, _, one = render_frame(scene, frame, one, cfg, k)
        jax.block_until_ready(img1)
        t1 = time.perf_counter()
        img4, _, four = render_frame_sharded(mesh, scene, frame, four, cfg, k)
        jax.block_until_ready(img4)
        t4 = time.perf_counter()
        log(card, f"frame {i + 1}: one card {(t1 - t0) * 1e3:.3f} ms, "
                  f"four cards {(t4 - t1) * 1e3:.3f} ms (frame 1 includes compile)")
    a = check_image(img1, "one-card frame 3")
    b = check_image(img4, "four-card frame 3")
    q = psnr(a, b)
    close = float(np.mean(np.abs(a - b) <= 1.0 / 255.0))
    log(card, f"4-card vs 1-card Cornell {W}x{H} bf16 frame 3 (trace="
              f"{cfg.traversal_impl}): PSNR {q:.3f} dB, pixels within 1/255 {close:.6f}")
    if not (q >= 40.0 and close >= 0.99):
        raise AssertionError("sharded frames disagree with the one-card frames")


def result_line(devices) -> str:
    """The last line of standard output: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded frame and its comparison")
    args = ap.parse_args(argv)

    import jax

    from low_precision_raytracer.utils.device import card_lines, require_gpu

    device = require_gpu()  # raises without a GPU: no result line
    for line in card_lines():
        print(line, flush=True)
    card = device["card"]
    if args.four_cards:
        four_cards(card)
    else:
        main_path(card)
        large_scene(card)
        kernel_check(card)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
