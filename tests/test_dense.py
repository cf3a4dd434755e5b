"""XLA all-pairs intersection vs the BVH traversal and the oracle."""

import numpy as np
import pytest

from low_precision_raytracer.config import get_precision
from low_precision_raytracer.models.hierarchy import build_flat_scene
from low_precision_raytracer.models.procedural import cornell_box_scene
from low_precision_raytracer.models.scene import build_scene_arrays, frame_input_from_flat
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.dense import trace_rays_dense
from low_precision_raytracer.ops.traversal import trace_rays

from oracle import brute_force_trace


def _setup(prec_name, res=32):
    host = cornell_box_scene()
    prec = get_precision(prec_name)
    scene = build_scene_arrays(host, prec, leaf_size=4)
    flat = build_flat_scene(host.root, host.active_camera)
    frame = frame_input_from_flat(flat, host, prec)
    o, d = primary_ray_grid(frame.cam_l2w, flat.cam_fov_y, res, res, prec.dtype)
    return host, prec, scene, flat, frame, o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.mark.parametrize("prec_name", ["fp32", "bf16"])
def test_dense_matches_oracle(prec_name):
    host, prec, scene, flat, frame, o, d = _setup(prec_name)
    hit = trace_rays_dense(scene, frame, o, d, prec=prec, fallback="both")
    want = brute_force_trace(flat, host.meshes, np.asarray(o, np.float64), np.asarray(d, np.float64))
    got_hit = np.asarray(hit.tri) >= 0
    agree = (got_hit == want["hit"]).mean()
    assert agree > 0.99, f"{prec_name} dense agreement {agree}"
    both = got_hit & want["hit"]
    same = np.asarray(hit.tri)[both] == want["tri"][both]
    t_err = np.abs(np.asarray(hit.t)[both][same] - want["t"][both][same])
    tol = 1e-3 if prec_name == "fp32" else 0.03
    assert np.quantile(t_err, 0.95) < tol


def test_dense_matches_bvh_traversal_fp32():
    host, prec, scene, flat, frame, o, d = _setup("fp32")
    dense = trace_rays_dense(scene, frame, o, d, prec=prec, fallback="both")
    bvh = trace_rays(scene, frame, o, d, prec=prec, leaf_size=4, fallback="both")
    same_tri = np.asarray(dense.tri) == np.asarray(bvh.tri)
    assert same_tri.mean() > 0.98, f"dense-vs-bvh tri agreement {same_tri.mean()}"
    both = (np.asarray(dense.tri) >= 0) & (np.asarray(bvh.tri) >= 0) & same_tri
    np.testing.assert_allclose(
        np.asarray(dense.t)[both], np.asarray(bvh.t)[both], rtol=1e-3, atol=1e-3
    )


def test_dense_skip_and_maxdist():
    host, prec, scene, flat, frame, o, d = _setup("fp32")
    hit = trace_rays_dense(scene, frame, o, d, prec=prec)
    # skipping the hit triangle from the surface: no zero-distance re-hit
    p = np.asarray(o) + np.asarray(hit.t)[:, None] * np.asarray(d)
    import jax.numpy as jnp

    re = trace_rays_dense(
        scene, frame, jnp.asarray(p, prec.dtype), d, prec=prec,
        skip_tri=hit.tri, min_dist=1e-4,
    )
    t2 = np.asarray(re.t)
    assert (t2[np.asarray(re.tri) >= 0] > 1e-4).all()
    # max_dist=0 kills all hits
    none = trace_rays_dense(scene, frame, o, d, prec=prec, max_dist=0.0)
    assert (np.asarray(none.tri) == -1).all()
