"""Native C++ builder vs numpy builder: bit-identical arrays."""

import numpy as np
import pytest

from low_precision_raytracer.models.bvh import build_bvh, triangle_aabbs
from low_precision_raytracer.models.native import (
    get_library,
    native_build_bvh,
    native_triangle_aabbs,
)
from low_precision_raytracer.models.procedural import icosphere_mesh

needs_native = pytest.mark.skipif(get_library() is None, reason="no native lib")


@needs_native
@pytest.mark.parametrize("leaf_size", [1, 4, 8])
def test_native_matches_numpy(leaf_size):
    mesh = icosphere_mesh(2)
    lo, hi, key = triangle_aabbs(mesh.positions, mesh.indices)
    py = build_bvh(lo, hi, key, leaf_size=leaf_size, use_native=False)
    nat = native_build_bvh(lo, hi, key, leaf_size)
    assert nat is not None
    np.testing.assert_array_equal(py.parent, nat["parent"])
    np.testing.assert_array_equal(py.lc, nat["lc"])
    np.testing.assert_array_equal(py.rc, nat["rc"])
    np.testing.assert_array_equal(py.leaf_offset, nat["leaf_offset"])
    np.testing.assert_array_equal(py.leaf_count, nat["leaf_count"])
    np.testing.assert_array_equal(py.prim, nat["prim"])
    np.testing.assert_array_equal(py.aabb_lo, nat["aabb_lo"])
    np.testing.assert_array_equal(py.aabb_hi, nat["aabb_hi"])


@needs_native
def test_native_triangle_aabbs():
    mesh = icosphere_mesh(1)
    lo, hi, key = triangle_aabbs(mesh.positions, mesh.indices)
    nlo, nhi, nkey = native_triangle_aabbs(mesh.positions, mesh.indices)
    np.testing.assert_array_equal(lo, nlo)
    np.testing.assert_array_equal(hi, nhi)
    np.testing.assert_array_equal(key, nkey)
