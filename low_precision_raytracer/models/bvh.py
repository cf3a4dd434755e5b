"""Two-level BVH builder (reference L2: `rt/trace/object_bvh.hpp`,
`rt/trace/scene_bvh.hpp`) producing parent-linked SoA node arrays.

Topology rules match the reference:
- binary median split (size/2) on the widest axis of the node AABB
  (`rt/trace/object_bvh.hpp:110-127`);
- BLAS split keys are the *first vertex* of each triangle
  (`rt/trace/object_bvh.hpp:120-123`), TLAS keys the AABB lower bound
  (`rt/trace/scene_bvh.hpp:117-119`);
- nodes carry parent links for stackless traversal
  (`rt/trace/object_bvh.hpp:33-34`);
- AABBs computed in fp32, stored per-dtype (here with conservative widening).

Deviation from the reference: leaf size is configurable (the reference
hardcodes 1 triangle/leaf, `rt/trace/object_bvh.hpp:75`).  Larger leaves
trade traversal steps for vectorized leaf tests — the right trade on a
vector machine.  The partial-sort `std::nth_element` becomes a *stable full
sort*, which makes the builder deterministic (and lets a future native C++
builder reproduce the arrays bit-for-bit).

The builder runs on the host, like the reference's (BLAS once at load;
TLAS every frame over a handful of object AABBs — SURVEY.md 2.4).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from low_precision_raytracer.utils.dtypes import widen_aabb

INVALID = np.int32(-1)


@dataclass
class BVHArrays:
    """Parent-linked BVH as SoA numpy arrays.

    nodes: aabb_lo/aabb_hi (N,3) f32, parent/lc/rc (N,) i32 (-1 = none),
    leaf_offset/leaf_count (N,) i32 (leaf_count == 0 => internal node),
    prim (P,) i32: primitive ids in leaf order (`geometry_offset` analogue).
    Root is node 0.
    """

    aabb_lo: np.ndarray
    aabb_hi: np.ndarray
    parent: np.ndarray
    lc: np.ndarray
    rc: np.ndarray
    leaf_offset: np.ndarray
    leaf_count: np.ndarray
    prim: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.aabb_lo.shape[0]


def build_bvh(prim_lo, prim_hi, split_key, leaf_size=1, use_native=True) -> BVHArrays:
    """Build a median-split BVH over primitives.

    prim_lo/prim_hi: (P, 3) fp32 per-primitive AABBs (node AABBs are unions).
    split_key: (P, 3) fp32 per-primitive sort key (first vertex for BLAS,
    AABB lower bound for TLAS).

    Uses the native C++ builder (native/bvh_builder.cpp) when available —
    identical topology by construction (both stable-sort median splits);
    falls back to this numpy implementation.
    """
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)
    split_key = np.asarray(split_key, np.float32)
    n = prim_lo.shape[0]
    assert n > 0, "cannot build a BVH over zero primitives"

    if use_native and n > 64:  # builder overhead only pays off beyond tiny inputs
        from low_precision_raytracer.models.native import native_build_bvh

        out = native_build_bvh(prim_lo, prim_hi, split_key, leaf_size)
        if out is not None:
            return BVHArrays(**out)

    order = np.arange(n, dtype=np.int64)

    aabb_lo, aabb_hi = [], []
    parent, lc, rc = [], [], []
    leaf_offset, leaf_count = [], []
    prim_out = []

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def rec(idx: np.ndarray, parent_id: int) -> int:
        size = idx.shape[0]
        if size == 0:
            return int(INVALID)
        lo = prim_lo[idx].min(axis=0)
        hi = prim_hi[idx].max(axis=0)
        node = len(parent)
        aabb_lo.append(lo)
        aabb_hi.append(hi)
        parent.append(parent_id)
        lc.append(int(INVALID))
        rc.append(int(INVALID))
        leaf_offset.append(0)
        leaf_count.append(0)
        if size <= leaf_size:
            leaf_offset[node] = len(prim_out)
            leaf_count[node] = size
            prim_out.extend(int(i) for i in idx)
        else:
            width = hi - lo
            # widest-axis rule with the reference's exact tie-breaking
            # (`rt/trace/object_bvh.hpp:112-119`: strict > comparisons, x wins ties)
            if width[1] > width[0] and width[1] > width[2]:
                axis = 1
            elif width[2] > width[0] and width[2] > width[1]:
                axis = 2
            else:
                axis = 0
            keys = split_key[idx, axis]
            # stable sort (key, original id) — deterministic nth_element
            srt = idx[np.lexsort((idx, keys))]
            half = size // 2
            lc[node] = rec(srt[:half], node)
            rc[node] = rec(srt[half:], node)
        return node

    rec(order, int(INVALID))

    return BVHArrays(
        aabb_lo=np.asarray(aabb_lo, np.float32),
        aabb_hi=np.asarray(aabb_hi, np.float32),
        parent=np.asarray(parent, np.int32),
        lc=np.asarray(lc, np.int32),
        rc=np.asarray(rc, np.int32),
        leaf_offset=np.asarray(leaf_offset, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        prim=np.asarray(prim_out, np.int32),
    )


def triangle_aabbs(positions, indices):
    """Per-triangle fp32 AABBs + first-vertex split keys.

    positions: (V, 3) fp32; indices: (T, 3) i32.
    """
    from low_precision_raytracer.models.native import native_triangle_aabbs

    nat = native_triangle_aabbs(positions, indices)
    if nat is not None:  # C++ path: no (T, 3, 3) fancy-index temporary
        return nat
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices)
    tri = positions[indices]  # (T, 3, 3)
    return tri.min(axis=1), tri.max(axis=1), tri[:, 0, :]


def build_blas(positions, indices, leaf_size=1) -> BVHArrays:
    """Per-mesh BLAS (`ObjectBVH`, `rt/trace/object_bvh.hpp:49-63`)."""
    lo, hi, key = triangle_aabbs(positions, indices)
    return build_bvh(lo, hi, key, leaf_size=leaf_size)


def build_tlas(world_lo, world_hi) -> BVHArrays:
    """Scene BVH over per-object world AABBs, rebuilt every frame
    (`SceneBVH::update`, `rt/trace/scene_bvh.hpp:50-70`).  Leaf size 1."""
    world_lo = np.asarray(world_lo, np.float32)
    return build_bvh(world_lo, world_hi, world_lo, leaf_size=1)


@dataclass
class PackedBLAS:
    """All per-mesh BLAS trees concatenated into one SoA (node ids global).

    root[m] is mesh m's root node id; prim holds *global* triangle indices
    (mesh triangle offset folded in); each root's parent is -1.
    """

    aabb_lo: np.ndarray
    aabb_hi: np.ndarray
    parent: np.ndarray
    lc: np.ndarray
    rc: np.ndarray
    leaf_offset: np.ndarray
    leaf_count: np.ndarray
    prim: np.ndarray
    root: np.ndarray  # (n_meshes,) i32


def pack_blas(blas_list, tri_offsets) -> PackedBLAS:
    """Concatenate per-mesh BLAS arrays, globalizing node and triangle ids."""
    roots = []
    node_off = 0
    geom_off = 0
    outs = {k: [] for k in ("aabb_lo", "aabb_hi", "parent", "lc", "rc", "leaf_offset", "leaf_count", "prim")}
    for blas, tri_off in zip(blas_list, tri_offsets):
        roots.append(node_off)
        outs["aabb_lo"].append(blas.aabb_lo)
        outs["aabb_hi"].append(blas.aabb_hi)

        def shift(a, off):
            return np.where(a >= 0, a + off, a).astype(np.int32)

        outs["parent"].append(shift(blas.parent, node_off))
        outs["lc"].append(shift(blas.lc, node_off))
        outs["rc"].append(shift(blas.rc, node_off))
        outs["leaf_offset"].append(blas.leaf_offset + geom_off)
        outs["leaf_count"].append(blas.leaf_count)
        outs["prim"].append(blas.prim + tri_off)
        node_off += blas.n_nodes
        geom_off += blas.prim.shape[0]
    return PackedBLAS(
        aabb_lo=np.concatenate(outs["aabb_lo"]).astype(np.float32),
        aabb_hi=np.concatenate(outs["aabb_hi"]).astype(np.float32),
        parent=np.concatenate(outs["parent"]).astype(np.int32),
        lc=np.concatenate(outs["lc"]).astype(np.int32),
        rc=np.concatenate(outs["rc"]).astype(np.int32),
        leaf_offset=np.concatenate(outs["leaf_offset"]).astype(np.int32),
        leaf_count=np.concatenate(outs["leaf_count"]).astype(np.int32),
        prim=np.concatenate(outs["prim"]).astype(np.int32),
        root=np.asarray(roots, np.int32),
    )


def bvh_aabbs_for_dtype(aabb_lo, aabb_hi, np_dtype):
    """Cast node AABBs to the render dtype with conservative widening
    (reference stores round-to-nearest DataT, `rt/trace/object_bvh.hpp:99-100`;
    we widen so bf16 boxes always contain the geometry)."""
    return widen_aabb(aabb_lo, aabb_hi, np_dtype)
