"""Measure interactive-explorer fps through the real HTTP frame loop on a
GPU (the server listens on localhost only).

Usage: python tools/bench_viewer_fps.py [size] [frames]
Drives `serve()` with a camera that orbits slightly each frame (so the
temporal path sees real motion) and reports steady-state fps after warmup.
"""

import os as _os, sys as _sys
# runnable as `python tools/<name>.py` from anywhere: put the repo root
# (this file's parent's parent) on sys.path before package imports
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import sys
import threading
import time
import urllib.request


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    from low_precision_raytracer.config import RenderConfig
    from low_precision_raytracer.gui.viewer import SceneExplorer, serve
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.utils.device import require_gpu

    device = require_gpu()
    cfg = RenderConfig(width=size, height=size, precision="bf16")
    ex = SceneExplorer(cornell_box_scene(), cfg)
    srv = serve(ex, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def frame(keys):
        body = json.dumps({"keys": keys, "mouse": [5, 5]}).encode()
        req = urllib.request.Request(base + "/frame", data=body, method="POST")
        resp = urllib.request.urlopen(req, timeout=600)
        resp.read()
        return json.loads(resp.headers["x-stats"])

    for _ in range(4):  # warmup/compile
        frame([])
    t0 = time.perf_counter()
    for k in range(n):
        stats = frame(["w"] if k % 2 else ["a"])  # keep the camera moving
    dt_total = time.perf_counter() - t0
    print(json.dumps({
        "viewer_fps": round(n / dt_total, 2),
        "ms_per_frame": round(dt_total / n * 1e3, 1),
        "size": size,
        "frames": n,
        "last_stats": stats,
        "device": device,
    }))
    srv.shutdown()


if __name__ == "__main__":
    main()
