"""The fused all-pairs kernel (ops/dense_triton.py), run in interpret mode on
the CPU, against the plain XLA reference (ops/dense.py) and the fp64
brute-force oracle.

Tolerances: both sides compute the same f32 expressions in a different
summation order, so accept decisions can flip only at u, v ~ 0 and at
near-ties; where tri/obj agree, t, u and v agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from low_precision_raytracer.config import get_precision
from low_precision_raytracer.models.hierarchy import build_flat_scene
from low_precision_raytracer.models.procedural import (
    _mesh_node,
    cornell_box_scene,
    single_triangle_scene,
    sponza_like_scene,
)
from low_precision_raytracer.models.scene import build_scene_arrays, frame_input_from_flat
from low_precision_raytracer.ops.camera import primary_ray_grid
from low_precision_raytracer.ops.dense import quantize, trace_rays_dense
from low_precision_raytracer.ops.dense_triton import (
    coefficient_table,
    trace_rays_dense_triton,
)

from oracle import brute_force_trace

def _twin_triangle():
    """Two instances of one triangle at the same place: every hit is an
    exact t tie between table rows 0 and 1."""
    host = single_triangle_scene()
    host.root.add(_mesh_node(host, 0, 0, "tri-copy"))
    return host


SCENES = {
    "twin": _twin_triangle,
    "cornell": cornell_box_scene,
    "colonnade": lambda: sponza_like_scene(pillar_grid=2, sphere_subdiv=1,
                                           with_skybox=False),
}
_CACHE = {}


def _setup(scene_name, prec_name, res=(20, 16)):
    """-> (host, flat, prec, scene, frame, origins, directions); 320 f32
    primary rays (not a multiple of the kernel's ray block)."""
    key = (scene_name, prec_name, res)
    if key not in _CACHE:
        host = SCENES[scene_name]()
        prec = get_precision(prec_name)
        scene = build_scene_arrays(host, prec, leaf_size=4)
        flat = build_flat_scene(host.root, host.active_camera)
        frame = frame_input_from_flat(flat, host, prec)
        w, h = res
        o, d = primary_ray_grid(frame.cam_l2w_f32, flat.cam_fov_y, w, h, jnp.float32)
        _CACHE[key] = (host, flat, prec, scene, frame, o.reshape(-1, 3), d.reshape(-1, 3))
    return _CACHE[key]


def _assert_matches(ref, got, min_agree=0.999):
    rt, gt = np.asarray(ref.tri), np.asarray(got.tri)
    same = (rt == gt) & (np.asarray(ref.obj) == np.asarray(got.obj))
    assert same.mean() >= min_agree, f"tri/obj agreement {same.mean()}"
    hit = same & (rt >= 0)
    t_ref = np.asarray(ref.t)[hit]
    assert (np.abs(t_ref - np.asarray(got.t)[hit])
            <= 1e-5 * np.maximum(1.0, np.abs(t_ref))).all()
    for a, b in ((ref.u, got.u), (ref.v, got.v)):
        assert (np.abs(np.asarray(a)[hit] - np.asarray(b)[hit]) <= 1e-5).all()
    miss = same & (rt < 0)
    assert (np.asarray(got.t)[miss] == 1e5).all()
    assert (np.asarray(got.u)[miss] == 0).all() and (np.asarray(got.v)[miss] == 0).all()


@pytest.mark.parametrize("scene_name", ["cornell", "colonnade"])
@pytest.mark.parametrize("find_any", [False, True])
@pytest.mark.parametrize("fallback", ["both", "dtype"])
@pytest.mark.parametrize("prec_name", ["fp32", "bf16", "fp16"])
def test_kernel_matches_reference(prec_name, fallback, find_any, scene_name):
    """Parity matrix: precision x fallback x find_any x scene.  Any-hit
    launches use shadow-like distance limits."""
    _, _, prec, scene, frame, o, d = _setup(scene_name, prec_name)
    kw = dict(prec=prec, fallback=fallback, find_any=find_any)
    if find_any:
        kw.update(min_dist=0.05, max_dist=3.0)
    ref = trace_rays_dense(scene, frame, o, d, **kw)
    got = trace_rays_dense_triton(scene, frame, o, d, interpret=True, **kw)
    _assert_matches(ref, got)


@pytest.mark.parametrize("scene_name", ["cornell", "colonnade"])
@pytest.mark.parametrize("prec_name", ["fp32", "bf16", "fp16"])
def test_kernel_matches_fp64_oracle(prec_name, scene_name):
    host, flat, prec, scene, frame, o, d = _setup(scene_name, prec_name)
    got = trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True)
    # the oracle traces the same dtype-quantised ray the test sees
    o_q = np.asarray(quantize(o - frame.dense_center, prec.dtype), np.float64)
    o_q += np.asarray(frame.dense_center, np.float64)
    d_q = np.asarray(quantize(d, prec.dtype), np.float64)
    want = brute_force_trace(flat, host.meshes, o_q, d_q)
    hit = np.asarray(got.tri) >= 0
    agree = (hit == want["hit"]).mean()
    assert agree > 0.99, f"{prec_name} hit agreement {agree}"
    both = hit & want["hit"] & (np.asarray(got.tri) == want["tri"])
    assert both.sum() > 0.5 * hit.sum()
    t_err = np.abs(np.asarray(got.t)[both] - want["t"][both])
    tol = 1e-3 if prec_name == "fp32" else 0.03
    assert np.quantile(t_err, 0.95) < tol


@pytest.mark.parametrize("block_rays", [16, 64, 128])
def test_ray_tail_not_multiple_of_block(block_rays):
    """300 rays: every block size leaves a partial last ray block."""
    _, _, prec, scene, frame, o, d = _setup("cornell", "bf16")
    o, d = o[:300], d[:300]
    ref = trace_rays_dense(scene, frame, o, d, prec=prec)
    got = trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True,
                                  block_rays=block_rays)
    assert got.t.shape == (300,) and got.tri.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(ref.tri), np.asarray(got.tri))
    np.testing.assert_array_equal(np.asarray(ref.obj), np.asarray(got.obj))


@pytest.mark.parametrize("block_tris", [8, 32])
def test_triangle_tail_not_multiple_of_block(block_tris):
    """Cornell has 34 instance-triangles: the last table block is partial,
    and its masked columns must never win."""
    _, _, prec, scene, frame, o, d = _setup("cornell", "fp32")
    assert frame.dense_n.shape[0] % block_tris != 0
    ref = trace_rays_dense(scene, frame, o, d, prec=prec)
    got = trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True,
                                  block_tris=block_tris)
    _assert_matches(ref, got, min_agree=1.0)


def test_skip_tri_and_distance_limits():
    """Secondary-ray semantics: re-tracing from the hit points with the hit
    triangle skipped and a min distance, with per-ray max distances."""
    _, _, prec, scene, frame, o, d = _setup("colonnade", "bf16")
    first = trace_rays_dense(scene, frame, o, d, prec=prec)
    p = o + first.t[:, None] * d
    maxd = jnp.where(jnp.arange(o.shape[0]) % 3 == 0, 0.5, 1e5).astype(jnp.float32)
    kw = dict(prec=prec, skip_tri=first.tri, min_dist=1e-3, max_dist=maxd)
    ref = trace_rays_dense(scene, frame, p, d, **kw)
    got = trace_rays_dense_triton(scene, frame, p, d, interpret=True, **kw)
    _assert_matches(ref, got)
    t = np.asarray(got.t)[np.asarray(got.tri) >= 0]
    assert (t > 1e-3).all()
    hit = np.asarray(got.tri) >= 0
    assert (np.asarray(got.t)[hit] < np.asarray(maxd)[hit]).all()


def test_all_miss():
    """Rays pointing away from every triangle: the miss encoding."""
    _, _, prec, scene, frame, o, d = _setup("cornell", "bf16")
    far = o + 100.0 * jnp.asarray([0.0, 0.0, 1.0])
    away = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), o.shape)
    got = trace_rays_dense_triton(scene, frame, far, away, prec=prec, interpret=True)
    assert (np.asarray(got.tri) == -1).all() and (np.asarray(got.obj) == -1).all()
    assert (np.asarray(got.t) == 1e5).all()
    assert (np.asarray(got.u) == 0).all() and (np.asarray(got.v) == 0).all()
    none = trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True,
                                   max_dist=0.0)
    assert (np.asarray(none.tri) == -1).all()


@pytest.mark.parametrize("block_tris", [1, 2])
def test_exact_ties_go_to_lowest_row(block_tris):
    """Two instances of the same triangle at the same place tie exactly in
    t; like jnp.argmin, the kernel keeps the lower table row, whether the
    tied rows share a block column (block_tris=1) or not (2)."""
    _, _, prec, scene, frame, o, d = _setup("twin", "fp32", res=(8, 8))
    ref = trace_rays_dense(scene, frame, o, d, prec=prec)
    got = trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True,
                                  block_tris=block_tris)
    hit = np.asarray(ref.tri) >= 0
    assert hit.any()
    first_obj = int(np.asarray(frame.dense_obj)[0])
    assert (np.asarray(ref.obj)[hit] == first_obj).all()
    np.testing.assert_array_equal(np.asarray(got.obj), np.asarray(ref.obj))


def test_kernel_under_cpu_mesh_shard_map():
    """Rays partitioned over a 4-device virtual CPU mesh, scene replicated:
    each shard runs the kernel on its own rays and the result equals the
    one-device launch."""
    from jax.sharding import PartitionSpec as P

    from low_precision_raytracer.ops.traversal import Hit
    from low_precision_raytracer.parallel.tiling import make_pixel_mesh

    _, _, prec, scene, frame, o, d = _setup("colonnade", "bf16")
    mesh = make_pixel_mesh(4)
    ray = P(mesh.axis_names[0])
    rep = jax.tree.map(lambda _: P(), frame)

    def local(frame, o, d):
        return trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True)

    sharded = jax.shard_map(
        local, mesh=mesh, in_specs=(rep, ray, ray),
        out_specs=Hit(t=ray, u=ray, v=ray, tri=ray, obj=ray), check_vma=False,
    )(frame, o, d)
    one = trace_rays_dense_triton(scene, frame, o, d, prec=prec, interpret=True)
    for a, b in zip(one, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_cpu_backend_without_interpret_is_refused():
    _, _, prec, scene, frame, o, d = _setup("cornell", "fp32")
    with pytest.raises(ValueError, match="dense_triton.*CUDA kernel"):
        trace_rays_dense_triton(scene, frame, o, d, prec=prec)


@pytest.mark.parametrize("prec_name,rows", [("fp32", 12), ("bf16", 18)])
def test_coefficient_table_layout(prec_name, rows):
    """fp32 needs no re-test rows; sub-fp32 modes carry the f32 x/y rows,
    and the dtype rows hold exactly the dtype table's values."""
    _, _, prec, _, frame, _, _ = _setup("cornell", prec_name)
    tab = np.asarray(coefficient_table(frame, prec))
    ti = frame.dense_n.shape[0]
    assert tab.shape == (rows, ti)
    np.testing.assert_array_equal(
        tab[0:6].T, np.asarray(frame.dense_n, np.float32).reshape(ti, 9)[:, 0:6]
    )
    np.testing.assert_array_equal(tab[9:12].T, np.asarray(frame.dense_e))
