import numpy as np
import pytest

from low_precision_raytracer.config import get_precision
from low_precision_raytracer.models.hierarchy import build_flat_scene
from low_precision_raytracer.models.procedural import (
    cornell_box_scene,
    icosphere_mesh,
    single_mesh_scene,
    single_triangle_scene,
)
from low_precision_raytracer.models.scene import (
    build_scene_arrays,
    frame_input_from_flat,
)
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.traversal import trace_rays

from oracle import brute_force_trace


def _setup(host, prec_name, leaf_size=4, res=32):
    prec = get_precision(prec_name)
    scene = build_scene_arrays(host, prec, leaf_size=leaf_size)
    flat = build_flat_scene(host.root, host.active_camera)
    frame = frame_input_from_flat(flat, host, prec)
    import numpy as _np

    o, d = primary_ray_grid(
        frame.cam_l2w, flat.cam_fov_y, res, res, prec.dtype
    )
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    return prec, scene, flat, frame, o, d


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_single_triangle_vs_oracle(leaf_size):
    host = single_triangle_scene()
    prec, scene, flat, frame, o, d = _setup(host, "fp32", leaf_size)
    hit = trace_rays(
        scene, frame, o, d, prec=prec, leaf_size=leaf_size, fallback="both"
    )
    want = brute_force_trace(flat, host.meshes, np.asarray(o), np.asarray(d))
    got_hit = np.asarray(hit.tri) >= 0
    agree = got_hit == want["hit"]
    assert agree.mean() > 0.995, f"hit agreement {agree.mean()}"
    both = got_hit & want["hit"] & agree
    np.testing.assert_allclose(
        np.asarray(hit.t)[both], want["t"][both], rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("prec_name", ["fp32", "bf16", "fp16"])
def test_icosphere_vs_oracle(prec_name):
    host = single_mesh_scene(icosphere_mesh(2))
    prec, scene, flat, frame, o, d = _setup(host, prec_name, leaf_size=4)
    hit = trace_rays(scene, frame, o, d, prec=prec, leaf_size=4, fallback="both")
    want = brute_force_trace(flat, host.meshes, np.asarray(o, np.float64), np.asarray(d, np.float64))
    got_hit = np.asarray(hit.tri) >= 0
    agree = (got_hit == want["hit"]).mean()
    min_agree = 0.995 if prec_name == "fp32" else 0.97
    assert agree > min_agree, f"{prec_name}: hit agreement {agree}"
    both = got_hit & want["hit"]
    t_err = np.abs(np.asarray(hit.t)[both] - want["t"][both])
    tol = 1e-3 if prec_name == "fp32" else 0.05
    assert np.quantile(t_err, 0.95) < tol, f"{prec_name}: t err q95 {np.quantile(t_err, 0.95)}"


def test_cornell_vs_oracle_fp32():
    host = cornell_box_scene()
    prec, scene, flat, frame, o, d = _setup(host, "fp32", leaf_size=4, res=48)
    hit = trace_rays(scene, frame, o, d, prec=prec, leaf_size=4, fallback="both")
    want = brute_force_trace(flat, host.meshes, np.asarray(o, np.float64), np.asarray(d, np.float64))
    got_hit = np.asarray(hit.tri) >= 0
    agree = (got_hit == want["hit"]).mean()
    # the slop-widened acceptance bands legitimately accept grazing edge
    # rays the strict oracle rejects (overlapping wall seams are edge-on)
    assert agree > 0.99, f"hit agreement {agree}"
    both = got_hit & want["hit"]
    same_tri = np.asarray(hit.tri)[both] == want["tri"][both]
    # pixels hitting the same triangle must match t tightly
    np.testing.assert_allclose(
        np.asarray(hit.t)[both][same_tri], want["t"][both][same_tri], rtol=1e-4, atol=1e-4
    )
    assert same_tri.mean() > 0.98
    # every camera ray into the closed box must hit something
    assert got_hit.mean() > 0.999


def test_cornell_bf16_close_to_fp32():
    host = cornell_box_scene()
    prec32, scene32, flat, frame32, o32, d32 = _setup(host, "fp32", leaf_size=4, res=48)
    hit32 = trace_rays(scene32, frame32, o32, d32, prec=prec32, leaf_size=4)
    prec16, scene16, _, frame16, o16, d16 = _setup(host, "bf16", leaf_size=4, res=48)
    hit16 = trace_rays(scene16, frame16, o16, d16, prec=prec16, leaf_size=4)
    same_obj = np.asarray(hit32.obj) == np.asarray(hit16.obj)
    assert same_obj.mean() > 0.97, f"object agreement {same_obj.mean()}"
    t32 = np.asarray(hit32.t)[same_obj]
    t16 = np.asarray(hit16.t)[same_obj]
    assert np.quantile(np.abs(t32 - t16), 0.95) < 0.05


def test_find_any_shadow_rays():
    host = cornell_box_scene()
    prec, scene, flat, frame, o, d = _setup(host, "fp32", leaf_size=4, res=24)
    # closest hits first
    hit = trace_rays(scene, frame, o, d, prec=prec, leaf_size=4)
    hitmask = np.asarray(hit.tri) >= 0
    # shadow rays from hit points toward the light
    light_pos = np.asarray(frame.light_pos)[0].astype(np.float32)
    p = np.asarray(o, np.float32) + np.asarray(hit.t)[:, None] * np.asarray(d, np.float32)
    to_light = light_pos - p
    dist = np.linalg.norm(to_light, axis=1)
    dirs = to_light / dist[:, None]
    any_hit = trace_rays(
        scene,
        frame,
        p.astype(np.float32),
        dirs.astype(np.float32),
        prec=prec,
        leaf_size=4,
        find_any=True,
        skip_tri=hit.tri,
        min_dist=1e-4,
        max_dist=dist,
    )
    want = brute_force_trace(
        flat,
        host.meshes,
        p.astype(np.float64),
        dirs.astype(np.float64),
        min_dist=1e-4,
        max_dist=dist,
        skip_tri=np.asarray(hit.tri),
    )
    got = (np.asarray(any_hit.tri) >= 0)[hitmask]
    agree = (got == want["hit"][hitmask]).mean()
    assert agree > 0.97, f"shadow agreement {agree}"


def test_skip_geometry_prevents_self_hit():
    host = single_triangle_scene()
    prec, scene, flat, frame, o, d = _setup(host, "fp32", leaf_size=1)
    hit = trace_rays(scene, frame, o, d, prec=prec, leaf_size=1)
    # re-trace from the surface along the same direction, skipping the hit tri
    p = np.asarray(o) + np.asarray(hit.t)[:, None] * np.asarray(d)
    re = trace_rays(
        scene,
        frame,
        p.astype(np.float32),
        d,
        prec=prec,
        leaf_size=1,
        skip_tri=hit.tri,
    )
    # single triangle scene: nothing left to hit
    assert not np.any((np.asarray(re.tri) >= 0) & (np.asarray(hit.tri) >= 0))
