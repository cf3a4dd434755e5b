"""Per-frame host flatten caches (models/scene.py, models/hierarchy.py).

The reference rebuilds its TLAS + per-frame constants on the host every
frame (`rt/rtrt/cuda.hpp:662-710`); this framework additionally rebuilds
the dense-backend world-space coefficient table.  The byte-keyed caches
must (a) make unchanged frames free — same DEVICE arrays back, no
re-upload — and (b) stay bitwise identical to a fresh, cache-less
recompute when anything moves.
"""

import numpy as np

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.hierarchy import MeshObject
from low_precision_raytracer.models.procedural import (
    animated_cornell_scene,
    cornell_box_scene,
)
from low_precision_raytracer.models.scene import flatten_frame

CFG = dict(max_direct_lights=4, width=64, height=64)

DENSE_FIELDS = (
    "dense_n", "dense_n_f32", "dense_e", "dense_tri",
    "dense_obj", "dense_center",
)


def _prec():
    return RenderConfig(precision="bf16").prec


def test_static_frame_reuses_device_tables():
    host = cornell_box_scene()
    f0 = flatten_frame(host, _prec(), time=0.0, **CFG)
    f1 = flatten_frame(host, _prec(), time=0.0, **CFG)
    # the whole coefficient dict must be the SAME device arrays (no
    # rebuild, no re-upload), and the TLAS the same host tree
    for nm in DENSE_FIELDS:
        assert getattr(f1, nm) is getattr(f0, nm), nm
    np.testing.assert_array_equal(
        np.asarray(f0.tlas_parent), np.asarray(f1.tlas_parent)
    )


def test_moved_object_matches_fresh_recompute():
    host = cornell_box_scene()
    flatten_frame(host, _prec(), time=0.0, **CFG)  # warm the caches
    meshes = [n for n in host.root.walk() if isinstance(n, MeshObject)]
    meshes[1].translation = meshes[1].translation + np.float32(0.25)
    cached = flatten_frame(host, _prec(), time=0.0, **CFG)

    fresh_host = cornell_box_scene()
    fm = [n for n in fresh_host.root.walk() if isinstance(n, MeshObject)]
    fm[1].translation = fm[1].translation + np.float32(0.25)
    fresh = flatten_frame(fresh_host, _prec(), time=0.0, **CFG)

    for nm in DENSE_FIELDS + ("obj_l2w_f32", "obj_w2l_f32", "tlas_lo",
                              "tlas_hi", "obj_aabb_lo", "obj_aabb_hi"):
        a = np.asarray(getattr(cached, nm), np.float32)
        b = np.asarray(getattr(fresh, nm), np.float32)
        np.testing.assert_array_equal(a, b, err_msg=nm)
    # and the table really changed vs the pre-move frame
    pre = flatten_frame(cornell_box_scene(), _prec(), time=0.0, **CFG)
    assert not np.array_equal(
        np.asarray(cached.dense_e), np.asarray(pre.dense_e)
    )


def test_animation_invalidates_and_matches():
    host = animated_cornell_scene()
    flatten_frame(host, _prec(), time=0.0, **CFG)
    cached = flatten_frame(host, _prec(), time=0.37, **CFG)
    fresh = flatten_frame(animated_cornell_scene(), _prec(), time=0.37, **CFG)
    for nm in DENSE_FIELDS + ("obj_l2w_f32", "tlas_lo"):
        a = np.asarray(getattr(cached, nm), np.float32)
        b = np.asarray(getattr(fresh, nm), np.float32)
        np.testing.assert_array_equal(a, b, err_msg=nm)


def test_transform_matrix_cache_tracks_mutation():
    node = MeshObject(name="n")
    m0 = node.transform_matrix()
    assert node.transform_matrix() is m0  # cache hit returns shared matrix
    node.translation = np.array([1.0, 2.0, 3.0], np.float32)
    m1 = node.transform_matrix()
    np.testing.assert_allclose(m1[:3, 3], [1.0, 2.0, 3.0])
    node.rotation = np.array([0.0, 0.7, 0.0, 0.7], np.float32)  # unnormalized
    m2 = node.transform_matrix()
    # normalization applied on the fresh compute path
    np.testing.assert_allclose(
        np.linalg.det(m2[:3, :3]), 1.0, rtol=1e-5
    )


def test_geometry_edit_invalidates_m_cache():
    """The frame-independent M-matrix cache keys on mesh array IDENTITY and
    freezes the arrays: replacing a mesh's vertices re-keys the cache,
    while an in-place edit raises instead of serving stale M matrices."""
    import pytest

    from low_precision_raytracer.models.scene import _host_m_cache

    host = cornell_box_scene()
    m0, v20 = _host_m_cache(host)
    # in-place mutation is rejected (arrays frozen on first cache)
    with pytest.raises(ValueError):
        host.meshes[0].positions[0, 0] = 99.0
    # replacing the array re-keys: new M matrices, not the cached ones
    mesh = host.meshes[0]
    moved = mesh.positions.copy()
    moved[:, 0] += 0.25
    mesh.positions = moved
    m1, v21 = _host_m_cache(host)
    assert not np.array_equal(m0, m1)
    assert not np.array_equal(v20, v21)
