"""Multi-device pixel-tile sharding (SURVEY.md §5.8): the sharded render must
match the single-device render (pixel tiles are embarrassingly parallel)."""

import jax
import numpy as np
import pytest

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.procedural import cornell_box_scene
from low_precision_raytracer.models.scene import build_scene_arrays, flatten_frame
from low_precision_raytracer.ops.trace import resolve_cfg
from low_precision_raytracer.parallel.tiling import make_pixel_mesh, render_frame_sharded
from low_precision_raytracer.render.framestate import init_frame_state
from low_precision_raytracer.render.renderer import render_frame

needs_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh"
)


def _setup(h=32, w=32):
    cfg = RenderConfig(width=w, height=h, precision="fp32", gi_on=True)
    host = cornell_box_scene()
    scene = build_scene_arrays(host, cfg.prec, leaf_size=cfg.bvh_leaf_size)
    frame = flatten_frame(host, cfg.prec, max_direct_lights=4, width=w, height=h)
    cfg = resolve_cfg(scene, frame, cfg)
    state = init_frame_state(cfg, len(frame.obj_layout))
    key = jax.random.PRNGKey(3)
    return cfg, scene, frame, state, key


@needs_devices
def test_sharded_matches_single_device():
    cfg, scene, frame, state, key = _setup()
    img1, _, state1 = render_frame(scene, frame, state, cfg, key)
    mesh = make_pixel_mesh(8)
    img8, _, state8 = render_frame_sharded(mesh, scene, frame, state, cfg, key)
    np.testing.assert_allclose(
        np.asarray(img1), np.asarray(img8), rtol=2e-4, atol=2e-4
    )
    # the carried temporal state matches too
    np.testing.assert_allclose(
        np.asarray(state1.taa_history, np.float32),
        np.asarray(state8.taa_history, np.float32),
        rtol=2e-3, atol=2e-3,
    )


@needs_devices
def test_single_device_mesh_matches_no_mesh():
    """A 1-device mesh is semantically no mesh: the temporal-fetch
    residual fast path must still work (regression: fetch_weighted used to
    crash unpacking residuals=None on size-1 meshes)."""
    cfg, scene, frame, state, key = _setup()
    img1, _, _ = render_frame(scene, frame, state, cfg, key)
    mesh = make_pixel_mesh(1)
    imgm, _, _ = render_frame_sharded(mesh, scene, frame, state, cfg, key)
    np.testing.assert_allclose(
        np.asarray(img1), np.asarray(imgm), rtol=2e-4, atol=2e-4
    )


@needs_devices
def test_sharded_two_frames_temporal():
    """Two sharded frames in sequence: temporal state stays sharded and
    consistent with the single-device run."""
    cfg, scene, frame, state, key = _setup()
    k1, k2 = jax.random.split(key)
    mesh = make_pixel_mesh(8)
    imgA, _, stA = render_frame(scene, frame, state, cfg, k1)
    imgA2, _, stA2 = render_frame(scene, frame, stA, cfg, k2)
    imgB, _, stB = render_frame_sharded(mesh, scene, frame, state, cfg, k1)
    imgB2, _, stB2 = render_frame_sharded(mesh, scene, frame, stB, cfg, k2)
    np.testing.assert_allclose(
        np.asarray(imgA2), np.asarray(imgB2), rtol=5e-4, atol=5e-4
    )
