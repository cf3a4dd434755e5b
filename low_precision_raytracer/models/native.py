"""ctypes binding to the native C++ host runtime (native/bvh_builder.cpp).

The reference's host-side work (BVH builds, per-triangle precompute) is C++;
here the hot host paths get the same treatment: a small C++ shared library,
built on demand with g++ and loaded via ctypes, with the numpy builder as a
behaviour-identical fallback (the two are tested to produce bit-identical
arrays — both use stable-sort median splits)."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from low_precision_raytracer.utils.log import get_logger

_log = get_logger("native")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "liblprt_native.so")

_lib = None
_tried = False


def _build_library() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO_PATH)
    except Exception as e:  # noqa: BLE001
        _log.debug("native build failed: %s", e)
        return False


def get_library():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH) and not _build_library():
        _log.info("native library unavailable; using numpy fallbacks")
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.lprt_build_bvh.restype = ctypes.c_int32
        lib.lprt_build_bvh.argtypes = [
            f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p,
        ]
        lib.lprt_triangle_aabbs.restype = None
        lib.lprt_triangle_aabbs.argtypes = [f32p, i32p, ctypes.c_int64, f32p, f32p, f32p]
        _lib = lib
    except OSError as e:  # pragma: no cover
        _log.warning("failed to load native library: %s", e)
        _lib = None
    return _lib


def native_build_bvh(prim_lo, prim_hi, split_key, leaf_size: int):
    """-> BVH SoA arrays via the C++ builder, or None if unavailable."""
    lib = get_library()
    if lib is None:
        return None
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    split_key = np.ascontiguousarray(split_key, np.float32)
    n = prim_lo.shape[0]
    cap = max(2 * n - 1, 1)
    aabb_lo = np.empty((cap, 3), np.float32)
    aabb_hi = np.empty((cap, 3), np.float32)
    parent = np.empty(cap, np.int32)
    lc = np.empty(cap, np.int32)
    rc = np.empty(cap, np.int32)
    leaf_offset = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    prim = np.empty(n, np.int32)
    n_nodes = lib.lprt_build_bvh(
        prim_lo, prim_hi, split_key, n, leaf_size,
        aabb_lo, aabb_hi, parent, lc, rc, leaf_offset, leaf_count, prim,
    )
    if n_nodes <= 0:
        return None
    s = slice(0, n_nodes)
    return dict(
        aabb_lo=aabb_lo[s].copy(),
        aabb_hi=aabb_hi[s].copy(),
        parent=parent[s].copy(),
        lc=lc[s].copy(),
        rc=rc[s].copy(),
        leaf_offset=leaf_offset[s].copy(),
        leaf_count=leaf_count[s].copy(),
        prim=prim,
    )


def native_triangle_aabbs(positions, indices):
    lib = get_library()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    n = indices.shape[0]
    lo = np.empty((n, 3), np.float32)
    hi = np.empty((n, 3), np.float32)
    key = np.empty((n, 3), np.float32)
    lib.lprt_triangle_aabbs(positions, indices.reshape(-1), n, lo, hi, key)
    return lo, hi, key
