"""Routing of trace launches, the compile-cache location, the PNG writer,
and chip_smoke.py's refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from low_precision_raytracer import config as config_mod
from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.scene import DENSE_MAX_OBJECTS, DENSE_MAX_TRIS
from low_precision_raytracer.ops import trace as trace_mod
from low_precision_raytracer.ops.dense import quantize
from low_precision_raytracer.utils.image import save_png, to_uint8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(n_obj, tris_each):
    return SimpleNamespace(
        obj_layout=tuple((0, 0, tris_each) for _ in range(n_obj))
    )


@pytest.mark.parametrize(
    "backend,impl,frame,want",
    [
        ("cpu", "auto", _frame(7, 5), "dense"),
        ("gpu", "auto", _frame(7, 5), "dense_triton"),
        ("gpu", "auto", _frame(1, DENSE_MAX_TRIS + 1), "jax"),
        ("gpu", "auto", _frame(DENSE_MAX_OBJECTS + 1, 2), "jax"),
        ("cpu", "auto", _frame(0, 0), "jax"),
        ("gpu", "dense", _frame(7, 5), "dense"),
        ("cpu", "jax", _frame(7, 5), "jax"),
    ],
)
def test_resolve_impl(monkeypatch, backend, impl, frame, want):
    """'auto' takes the all-pairs route on small scenes (the fused kernel
    on a GPU, XLA elsewhere) and the BVH walk past the all-pairs limits;
    a forced route is kept as given."""
    monkeypatch.setattr(trace_mod.jax, "default_backend", lambda: backend)
    cfg = RenderConfig(traversal_impl=impl)
    assert trace_mod.resolve_impl(None, frame, cfg) == want
    assert trace_mod.resolve_cfg(None, frame, cfg).traversal_impl == want


def test_auto_fallback_is_both():
    from low_precision_raytracer.models.procedural import cornell_box_scene
    from low_precision_raytracer.models.scene import build_scene_arrays, flatten_frame
    from low_precision_raytracer.ops.camera import primary_ray_grid
    from low_precision_raytracer.ops.dense import trace_rays_dense

    cfg = RenderConfig(width=16, height=16, precision="bf16", traversal_impl="dense")
    host = cornell_box_scene()
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, cfg.prec, width=16, height=16)
    o, d = primary_ray_grid(frame.cam_l2w_f32, frame.cam_fov_y_f32, 16, 16, jnp.float32)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    got = trace_mod.trace(scene, frame, o, d, prec=cfg.prec, cfg=cfg)
    want = trace_rays_dense(scene, frame, o, d, prec=cfg.prec, fallback="both")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config_mod.compilation_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    assert os.path.isfile(os.path.join(os.path.dirname(path), "chip_smoke.py"))


def test_cache_dir_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config_mod.compilation_cache_dir() is None


@pytest.mark.parametrize("dt", [jnp.bfloat16, jnp.float16])
def test_quantize_rounds_like_a_cast(dt):
    x = jax.random.normal(jax.random.PRNGKey(0), (4096,), jnp.float32) * 30.0
    got = jax.jit(lambda x: quantize(x, dt))(x)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x.astype(dt).astype(jnp.float32)))


def test_save_png_roundtrip(tmp_path):
    """The zlib PNG writer: upright rows, 8-bit RGB, readable back."""
    img = jax.random.uniform(jax.random.PRNGKey(1), (7, 11, 3))
    path = str(tmp_path / "x.png")
    save_png(path, img)
    px = chip_smoke.read_png_rgb(path)
    np.testing.assert_array_equal(px, to_uint8(img)[::-1])
    try:
        from PIL import Image
    except ImportError:
        return
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), px)


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_result_line():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
