import numpy as np
import pytest

from low_precision_raytracer.models.bvh import (
    build_blas,
    build_tlas,
    pack_blas,
)
from low_precision_raytracer.models.procedural import cube_mesh, icosphere_mesh
from low_precision_raytracer.utils.dtypes import cast_round_down, cast_round_up


def check_bvh_invariants(bvh, n_prims):
    n = bvh.n_nodes
    assert bvh.parent[0] == -1
    seen_prims = []
    for i in range(n):
        if bvh.leaf_count[i] > 0:  # leaf
            assert bvh.lc[i] == -1 and bvh.rc[i] == -1
            sl = slice(bvh.leaf_offset[i], bvh.leaf_offset[i] + bvh.leaf_count[i])
            seen_prims.extend(bvh.prim[sl].tolist())
        else:
            lc, rc = bvh.lc[i], bvh.rc[i]
            assert lc >= 0 and rc >= 0
            assert bvh.parent[lc] == i and bvh.parent[rc] == i
            # child AABBs inside parent AABB
            for c in (lc, rc):
                assert np.all(bvh.aabb_lo[c] >= bvh.aabb_lo[i] - 1e-6)
                assert np.all(bvh.aabb_hi[c] <= bvh.aabb_hi[i] + 1e-6)
    assert sorted(seen_prims) == list(range(n_prims))


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_blas_invariants(leaf_size):
    mesh = icosphere_mesh(2)
    bvh = build_blas(mesh.positions, mesh.indices, leaf_size=leaf_size)
    check_bvh_invariants(bvh, mesh.n_triangles)
    # node AABBs contain their triangles
    tris = mesh.positions[mesh.indices]
    for i in range(bvh.n_nodes):
        if bvh.leaf_count[i] > 0:
            sl = bvh.prim[bvh.leaf_offset[i] : bvh.leaf_offset[i] + bvh.leaf_count[i]]
            t = tris[sl]
            assert np.all(t.min(axis=(0, 1)) >= bvh.aabb_lo[i] - 1e-6)
            assert np.all(t.max(axis=(0, 1)) <= bvh.aabb_hi[i] + 1e-6)


def test_blas_reference_topology_leaf1():
    """leaf_size=1 reproduces the reference's structure: 2*T-1 nodes."""
    mesh = cube_mesh()
    bvh = build_blas(mesh.positions, mesh.indices, leaf_size=1)
    assert bvh.n_nodes == 2 * mesh.n_triangles - 1
    assert bvh.prim.shape[0] == mesh.n_triangles


def test_tlas_single_object():
    lo = np.array([[0, 0, 0]], np.float32)
    hi = np.array([[1, 1, 1]], np.float32)
    bvh = build_tlas(lo, hi)
    assert bvh.n_nodes == 1
    assert bvh.leaf_count[0] == 1
    assert bvh.prim[0] == 0


def test_pack_blas_globalizes():
    m1 = cube_mesh()
    m2 = icosphere_mesh(1)
    b1 = build_blas(m1.positions, m1.indices, leaf_size=2)
    b2 = build_blas(m2.positions, m2.indices, leaf_size=2)
    packed = pack_blas([b1, b2], [0, m1.n_triangles])
    assert packed.root[0] == 0
    assert packed.root[1] == b1.n_nodes
    # second tree's prim ids offset by m1 triangle count
    total = m1.n_triangles + m2.n_triangles
    assert sorted(packed.prim.tolist()) == list(range(total))
    # roots have parent -1
    assert packed.parent[packed.root[0]] == -1
    assert packed.parent[packed.root[1]] == -1


def test_conservative_widening_bf16():
    import ml_dtypes

    rng = np.random.default_rng(3)
    x = rng.normal(size=10000).astype(np.float32) * 100
    lo = cast_round_down(x, ml_dtypes.bfloat16)
    hi = cast_round_up(x, ml_dtypes.bfloat16)
    assert np.all(lo.astype(np.float32) <= x)
    assert np.all(hi.astype(np.float32) >= x)
    # and tight: within 1 ulp
    assert np.all(hi.astype(np.float32) - lo.astype(np.float32) <= np.abs(x) * 2**-7 + 1e-30)
