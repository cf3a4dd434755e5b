"""Headless CLI (replaces the reference's ImGui explorer app, SURVEY.md 2.21):

    lprt render scene.glb --precision bf16 --width 1024 --height 768 \
         --frames 8 --out out.png
    lprt render --scene cornell --profile
    lprt info scene.glb
    lprt bench --width 1920 --height 1080

The reference's pre-load static config (precision + resolution,
`rt/gui/imgui_window.cu:735-752`) maps to CLI flags; its per-frame Inspect
panel toggles map to --no-svgf/--no-taa/--no-gi/--demodulate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_scene(name_or_path: str):
    from low_precision_raytracer.models import procedural

    builders = {
        "cornell": procedural.cornell_box_scene,
        "cornell-anim": procedural.animated_cornell_scene,
        "sphere": procedural.single_mesh_scene,
        "triangle": procedural.single_triangle_scene,
        "sponza": procedural.sponza_like_scene,
    }
    if name_or_path in builders:
        return builders[name_or_path]()
    from low_precision_raytracer.models.gltf import load_gltf

    scene = load_gltf(name_or_path)
    if not scene.meshes:
        # the default camera/headlight rigs below aggregate mesh AABBs
        raise SystemExit(
            "scene has no meshes — nothing to render (camera/light-only "
            "glTF files are valid but not renderable)"
        )
    if scene.active_camera is None:
        # rig a default camera like the explorer does when the file has none
        from low_precision_raytracer.models.hierarchy import CameraObject
        import numpy as np

        cam = CameraObject(name="default-cam", fov_y=np.pi / 3)
        los = [m.aabb[0] for m in scene.meshes]
        his = [m.aabb[1] for m in scene.meshes]
        lo = np.min(np.stack(los), axis=0)
        hi = np.max(np.stack(his), axis=0)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
        cam.translation = center + np.array([0, 0, 2.5 * radius], np.float32)
        scene.root.add(cam)
        scene.active_camera = cam
    from low_precision_raytracer.models.hierarchy import LightObject

    if not any(isinstance(n, LightObject) for n in scene.root.walk()):
        # headlight rig for light-less files (e.g. the Khronos Box sample):
        # without it a GI render of such a file is legitimately black
        # (SKYBOX_COLOR is 0) — a CLI convenience, not reference parity
        import numpy as np
        from low_precision_raytracer.models.hierarchy import LIGHT_POINT

        los = [m.aabb[0] for m in scene.meshes]
        his = [m.aabb[1] for m in scene.meshes]
        lo = np.min(np.stack(los), axis=0)
        hi = np.max(np.stack(his), axis=0)
        radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
        lamp = LightObject(
            name="default-headlight",
            light_type=LIGHT_POINT,
            intensity=np.full(3, 40.0 * radius * radius, np.float32),
        )
        lamp.translation = np.asarray(
            scene.active_camera.translation, np.float32
        ) + np.array([radius, 2.0 * radius, radius], np.float32)
        scene.root.add(lamp)
    return scene


def cmd_render(args) -> int:
    from low_precision_raytracer.config import DemoSettings, RenderConfig
    from low_precision_raytracer.render.renderer import Renderer
    from low_precision_raytracer.utils.image import save_png

    if args.frames < 1:
        raise SystemExit("--frames must be >= 1")

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        precision=args.precision,
        gi_on=not args.no_gi,
        taa_on=not args.no_taa,
        taa_mix_weight=args.taa_weight,
        demo=DemoSettings(svgf=not args.no_svgf, demodulate=args.demodulate),
        triangle_fallback=args.fallback,
        traversal_impl=args.impl,
        max_bounces=args.bounces,
    )
    scene = _build_scene(args.scene)
    if args.skybox:
        from low_precision_raytracer.models.scene import Skybox
        from low_precision_raytracer.utils.image import load_hdr_equirect

        scene.skybox = Skybox(data=load_hdr_equirect(args.skybox), exposure=args.skybox_exposure)

    renderer = Renderer(scene, cfg)
    image = None
    t0 = time.perf_counter()
    for f in range(args.frames):
        image, aux = renderer.render(time=f * args.time_step)
        if args.out_pattern:
            save_png(args.out_pattern.format(f), image)
    import jax

    jax.block_until_ready(image)
    dt = time.perf_counter() - t0
    print(
        f"rendered {args.frames} frame(s) {args.width}x{args.height} "
        f"{args.precision} in {dt:.2f}s ({args.frames / dt:.2f} fps incl. compile)",
        file=sys.stderr,
    )
    if args.profile:
        from low_precision_raytracer.render.profile import profile_frame

        stats = profile_frame(renderer)
        for k, v in stats.items():
            print(f"{k:>24s}: {v * 1e3:8.3f} ms", file=sys.stderr)
    if args.out:
        save_png(args.out, image)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    scene = _build_scene(args.scene)
    tris = sum(m.n_triangles for m in scene.meshes)
    verts = sum(m.positions.shape[0] for m in scene.meshes)
    info = dict(
        meshes=len(scene.meshes),
        triangles=int(tris),
        vertices=int(verts),
        materials=len(scene.materials),
        textures=len(scene.textures),
        animated=scene.animated,
        has_camera=scene.active_camera is not None,
    )
    print(json.dumps(info, indent=2))
    return 0


def cmd_parity(args) -> int:
    """bf16-vs-fp32 parity harness (SURVEY.md §4): renders the same scene at
    both precisions and reports PSNR/SSIM + the fp32-fallback rate — the
    reference's manual Half-Float A/B toggle made automatic."""
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.render.renderer import Renderer
    from low_precision_raytracer.utils.image import psnr, ssim
    import numpy as np

    imgs = {}
    renderers = {}
    for prec in ("fp32", args.precision):
        cfg = RenderConfig(
            width=args.width, height=args.height, precision=prec, gi_on=not args.no_gi
        )
        scene = _build_scene(args.scene)
        renderers[prec] = Renderer(scene, cfg)
        img = None
        for f in range(args.frames):
            img, _ = renderers[prec].render(time=f * args.time_step)
        imgs[prec] = np.asarray(img)
    p = psnr(imgs["fp32"], imgs[args.precision])
    s = ssim(imgs["fp32"], imgs[args.precision])

    # fallback-rate diagnostic on the low-precision primary rays
    from low_precision_raytracer.models.scene import flatten_frame
    from low_precision_raytracer.ops.camera import primary_ray_grid
    from low_precision_raytracer.ops.diagnostics import fallback_rate

    r = renderers[args.precision]
    frame = flatten_frame(r.host, r.prec, max_direct_lights=r.cfg.max_direct_lights,
                          width=r.cfg.width, height=r.cfg.height)
    rate = float("nan")
    if frame.dense_n is not None:
        o, d = primary_ray_grid(frame.cam_l2w, frame.cam_fov_y, r.cfg.width,
                                r.cfg.height, r.prec.dtype)
        stats = fallback_rate(frame, o.reshape(-1, 3), d.reshape(-1, 3), r.prec)
        rate = float(stats["rate"])
    print(json.dumps({
        "precision": args.precision,
        "psnr_db": round(p, 2),
        "ssim": round(s, 4),
        "fp32_fallback_rate": round(rate, 6),
        "frames": args.frames,
    }))
    return 0


def cmd_view(args) -> int:
    """Interactive explorer: renders frames into a browser canvas over HTTP
    (the reference's GLFW/ImGui explorer, `rt/gui/imgui_window.cu:369-846`,
    rebuilt on the same controller scheme)."""
    from low_precision_raytracer.config import DemoSettings, RenderConfig
    from low_precision_raytracer.gui.viewer import SceneExplorer, serve

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        precision=args.precision,
        gi_on=not args.no_gi,
        demo=DemoSettings(svgf=not args.no_svgf),
        taa_mix_weight=0.3,  # interactive: keep history but converge fast
    )
    scene = _build_scene(args.scene)
    if args.skybox:
        from low_precision_raytracer.models.scene import Skybox
        from low_precision_raytracer.utils.image import load_hdr_equirect

        scene.skybox = Skybox(
            data=load_hdr_equirect(args.skybox), exposure=args.skybox_exposure
        )
    explorer = SceneExplorer(scene, cfg)
    srv = serve(explorer, host=args.host, port=args.port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_bench(args) -> int:
    import bench as bench_mod  # repo-root bench.py

    mrays, dt, n_rays, _reps = bench_mod.bench(
        width=args.width, height=args.height, precision=args.precision, frames=args.frames
    )
    print(json.dumps({"mrays_per_s": round(mrays, 2), "ms_per_frame": round(dt * 1e3, 2)}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lprt", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", help="glTF path or builtin: cornell|sphere|triangle")
    pr.add_argument("--width", type=int, default=1024)
    pr.add_argument("--height", type=int, default=768)
    pr.add_argument("--precision", choices=["fp32", "bf16", "fp16"], default="fp32")
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--time-step", type=float, default=1 / 30)
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--out-pattern", default=None,
                    help="per-frame PNG path pattern, e.g. frames/f{:04d}.png")
    pr.add_argument("--no-gi", action="store_true")
    pr.add_argument("--no-svgf", action="store_true")
    pr.add_argument("--no-taa", action="store_true")
    pr.add_argument("--taa-weight", type=float, default=1.0)
    pr.add_argument("--demodulate", action="store_true")
    pr.add_argument("--fallback", choices=["auto", "both", "dtype"], default="auto")
    pr.add_argument("--impl", default="auto",
                    choices=["auto", "jax", "dense", "dense_triton"],
                    help="trace backend (auto: all-pairs for small scenes, "
                         "BVH walk for large)")
    pr.add_argument("--bounces", type=int, default=2,
                    help="max_bounces incl. the primary shade round")
    pr.add_argument("--skybox", default=None, help="equirectangular HDR path")
    pr.add_argument("--skybox-exposure", type=float, default=1.0)
    pr.add_argument("--profile", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="print scene statistics")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    pp = sub.add_parser("parity", help="bf16-vs-fp32 PSNR/SSIM parity check")
    pp.add_argument("scene", nargs="?", default="cornell")
    pp.add_argument("--precision", choices=["bf16", "fp16"], default="bf16")
    pp.add_argument("--width", type=int, default=256)
    pp.add_argument("--height", type=int, default=256)
    pp.add_argument("--frames", type=int, default=4)
    pp.add_argument("--time-step", type=float, default=1 / 30)
    pp.add_argument("--no-gi", action="store_true")
    pp.set_defaults(fn=cmd_parity)

    pb = sub.add_parser("bench", help="run the benchmark")
    pb.add_argument("--width", type=int, default=1920)
    pb.add_argument("--height", type=int, default=1080)
    pb.add_argument("--precision", default="bf16")
    pb.add_argument("--frames", type=int, default=20)
    pb.set_defaults(fn=cmd_bench)

    pv = sub.add_parser("view", help="interactive browser explorer")
    pv.add_argument("scene", nargs="?", default="cornell")
    pv.add_argument("--width", type=int, default=512)
    pv.add_argument("--height", type=int, default=512)
    pv.add_argument("--precision", choices=["fp32", "bf16", "fp16"], default="bf16")
    pv.add_argument("--no-gi", action="store_true")
    pv.add_argument("--no-svgf", action="store_true")
    pv.add_argument("--skybox", default=None, help="equirectangular HDR path")
    pv.add_argument("--skybox-exposure", type=float, default=1.0)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8008)
    pv.set_defaults(fn=cmd_view)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
