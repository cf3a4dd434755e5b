"""Stackless two-level BVH traversal (`rt/rtrt/cuda.hpp:415-631`).

The reference walks the TLAS with a parent-link state machine and, at each
TLAS leaf, recursively walks that object's BLAS with the ray transformed into
object space (`scene_bvh.traversal` + `search_intersection_in_object`).

Restructuring: the nested walk is flattened into ONE lane-parallel
state machine driven by a single `lax.while_loop`.  Every ray lane carries a
``mode`` flag (0 = TLAS, 1 = BLAS); entering an object switches the lane to
BLAS mode (transforming the ray and advancing the TLAS cursor past the leaf
eagerly), and popping above a BLAS root switches back.  All lanes execute in
lockstep with masks — the vector-machine analogue of the reference's SIMT
divergence (SURVEY.md §7 hard part #1).

Notes on faithful semantics:
- the TLAS leaf re-test of `aabbs_W[i]` (`rt/rtrt/cuda.hpp:544-546`) is
  skipped: with leaf size 1 it is identical to the node AABB just tested;
- the `culling` template parameter is dead in the reference (the active
  M-shift triangle test ignores it), so it is dropped;
- `skip` geometry is a single *global triangle id* (equivalent to the
  reference's {vao_index, inobject_offset} pair since all instances of a
  mesh share triangles, `rt/rtrt/cuda.hpp:446-448`);
- best-hit ``t`` is kept in fp32 (the reference stores it as DataT; keeping
  fp32 only tightens the closest-hit compare).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import Precision
from low_precision_raytracer.ops.aabb import ray_aabb_object, ray_aabb_scene
from low_precision_raytracer.ops.triangle import ray_triangle

INVALID = -1  # plain int: module import must not touch the device


class Hit(NamedTuple):
    """Closest-hit record (`Intersection`, `rt/rtrt/cuda.hpp:50-57`)."""

    t: jnp.ndarray  # (R,) f32 (1e5 = miss)
    u: jnp.ndarray  # (R,) f32 barycentric (v0 weight)
    v: jnp.ndarray  # (R,) f32 barycentric (v1 weight)
    tri: jnp.ndarray  # (R,) i32 global triangle id (-1 = miss)
    obj: jnp.ndarray  # (R,) i32 inscene object id (-1 = miss)

    @property
    def hit(self):
        return self.tri >= 0

    @property
    def w(self):
        return 1.0 - self.u - self.v


def _take(arr, idx):
    return jnp.take(arr, idx, axis=0, mode="clip")


def _transform_ray(w2l, o, d):
    """`Ray::transformed` (`rt/rtrt/cuda.hpp:42-47`): w-divided point and
    w=0 direction transform, in the render dtype."""
    rot = w2l[..., :3, :3]
    o4 = (rot @ o[..., :, None])[..., 0] + w2l[..., :3, 3]
    ww = jnp.sum(w2l[..., 3, :3] * o, axis=-1) + w2l[..., 3, 3]
    o_loc = o4 / ww[..., None]
    d_loc = (rot @ d[..., :, None])[..., 0]
    return o_loc, d_loc


@partial(
    jax.jit,
    static_argnames=("prec", "find_any", "fallback", "leaf_size"),
)
def trace_rays(
    scene,
    frame,
    origins,
    directions,
    *,
    prec: Precision,
    find_any: bool = False,
    fallback: str = "both",
    leaf_size: int | None = None,
    skip_tri=None,
    min_dist=0.0,
    max_dist=1e5,
) -> Hit:
    """Trace a flat batch of rays -> closest (or any) Hit.

    origins/directions: (R, 3) in the render dtype (world space).
    skip_tri: (R,) i32 global triangle ids to exclude (self-intersection
    control, SURVEY.md 2.8) or None.
    min_dist/max_dist: scalars or (R,) f32.
    """
    # the leaf loop must cover every triangle of the leaves the scene was
    # BUILT with — a smaller caller value would silently test only the
    # first k prims of each leaf (missed hits, no error)
    if leaf_size is None:
        leaf_size = scene.leaf_size
    assert leaf_size >= scene.leaf_size, (
        f"leaf_size {leaf_size} < scene build leaf_size {scene.leaf_size}"
    )
    dt = prec.dtype
    f32 = jnp.float32
    R = origins.shape[0]

    o_w = origins.astype(dt)
    d_w = directions.astype(dt)
    min_dist = jnp.broadcast_to(jnp.asarray(min_dist, f32), (R,))
    max_dist = jnp.broadcast_to(jnp.asarray(max_dist, f32), (R,))
    if skip_tri is None:
        skip_tri = jnp.full((R,), INVALID)
    min_dist_dt = min_dist.astype(dt)
    max_dist_dt = max_dist.astype(dt)

    n_tlas = frame.tlas_parent.shape[0]
    n_blas = scene.blas_parent.shape[0]
    # iteration bound: a ray re-walks a SHARED BLAS once per entered
    # instance, so the bound must scale with the instance count, not the
    # unique-mesh node total — 3*(n_tlas + n_blas) truncated grazing rays
    # on instanced scenes (e.g. 64 icospheres sharing one BLAS), silently
    # dropping hits.  The while_loop exits as soon as every lane is done,
    # so a generous static bound costs converged launches nothing.
    n_instances = max(len(frame.obj_layout), 1)
    max_iters = 3 * (n_tlas + n_instances * n_blas) + 64

    class S(NamedTuple):
        it: jnp.ndarray
        mode: jnp.ndarray  # (R,) i32: 0 TLAS / 1 BLAS
        tl: jnp.ndarray  # TLAS last / current node
        tc: jnp.ndarray
        bl: jnp.ndarray  # BLAS last / current node (global ids)
        bc: jnp.ndarray
        obj: jnp.ndarray  # current object while in BLAS mode
        o_loc: jnp.ndarray  # (R, 3) dtype local ray
        d_loc: jnp.ndarray
        best_t: jnp.ndarray  # f32
        best_u: jnp.ndarray
        best_v: jnp.ndarray
        best_tri: jnp.ndarray
        best_obj: jnp.ndarray
        done: jnp.ndarray  # bool (find_any early-out)

    s0 = S(
        it=jnp.int32(0),
        mode=jnp.zeros((R,), jnp.int32),
        tl=jnp.full((R,), INVALID),
        tc=jnp.zeros((R,), jnp.int32),
        bl=jnp.full((R,), INVALID),
        bc=jnp.full((R,), INVALID),
        obj=jnp.zeros((R,), jnp.int32),
        o_loc=o_w,
        d_loc=d_w,
        best_t=jnp.full((R,), 1e5, f32),
        best_u=jnp.zeros((R,), f32),
        best_v=jnp.zeros((R,), f32),
        best_tri=jnp.full((R,), INVALID),
        best_obj=jnp.full((R,), INVALID),
        done=jnp.zeros((R,), jnp.bool_),
    )

    def active_mask(s):
        return (~s.done) & ~((s.mode == 0) & (s.tc < 0))

    def cond(s):
        return jnp.any(active_mask(s)) & (s.it < max_iters)

    def body(s):
        act = active_mask(s)
        tlas_m = act & (s.mode == 0)
        blas_m = act & (s.mode == 1)

        # ------------------------------------------------ TLAS phase
        ti = jnp.where(tlas_m, s.tc, 0)
        t_lo = _take(frame.tlas_lo, ti)
        t_hi = _take(frame.tlas_hi, ti)
        t_parent = _take(frame.tlas_parent, ti)
        t_lc = _take(frame.tlas_lc, ti)
        t_rc = _take(frame.tlas_rc, ti)
        t_leaf_off = _take(frame.tlas_leaf_offset, ti)
        t_leaf_cnt = _take(frame.tlas_leaf_count, ti)

        t_hit, t_tmin, t_tmax = ray_aabb_scene(
            o_w, d_w, t_lo, t_hi, prec.scene_aabb_slop
        )
        # `temp_min_t < max_distance && temp_max_t > min_distance`
        # (`rt/rtrt/cuda.hpp:536-537`, DataT compares)
        t_hit = t_hit & (t_tmin < max_dist_dt) & (t_tmax > min_dist_dt)

        from_parent = s.tl == t_parent
        is_leaf = t_leaf_cnt > 0
        enter_obj = tlas_m & from_parent & t_hit & is_leaf
        descend = tlas_m & from_parent & t_hit & ~is_leaf
        from_lc = tlas_m & ~from_parent & (s.tl == t_lc)

        desc_target = jnp.where(
            t_lc >= 0, t_lc, jnp.where(t_rc >= 0, t_rc, t_parent)
        )
        fromlc_target = jnp.where(t_rc >= 0, t_rc, t_parent)
        next_tc = jnp.where(
            descend,
            desc_target,
            jnp.where(from_lc, fromlc_target, t_parent),
        )
        # (enter_obj also advances past the leaf eagerly: tc = parent)
        new_tc = jnp.where(tlas_m, next_tc, s.tc)
        new_tl = jnp.where(tlas_m, s.tc, s.tl)

        # entering an object: transform ray, point at the mesh BLAS root
        obj_new = _take(frame.tlas_prim, t_leaf_off)
        ei = jnp.where(enter_obj, obj_new, 0)
        w2l = _take(frame.obj_w2l, ei)
        o_loc_new, d_loc_new = _transform_ray(w2l, o_w, d_w)
        mesh_new = _take(frame.obj_mesh, ei)
        root_new = _take(scene.blas_root, mesh_new)

        new_mode = jnp.where(enter_obj, 1, s.mode)
        new_obj = jnp.where(enter_obj, obj_new, s.obj)
        new_o_loc = jnp.where(enter_obj[:, None], o_loc_new, s.o_loc)
        new_d_loc = jnp.where(enter_obj[:, None], d_loc_new, s.d_loc)
        new_bc = jnp.where(enter_obj, root_new, s.bc)
        new_bl = jnp.where(enter_obj, INVALID, s.bl)

        # ------------------------------------------------ BLAS phase
        bi = jnp.where(blas_m, s.bc, 0)
        b_lo = _take(scene.blas_lo, bi)
        b_hi = _take(scene.blas_hi, bi)
        b_parent = _take(scene.blas_parent, bi)
        b_lc = _take(scene.blas_lc, bi)
        b_rc = _take(scene.blas_rc, bi)
        b_leaf_off = _take(scene.blas_leaf_offset, bi)
        b_leaf_cnt = _take(scene.blas_leaf_count, bi)

        b_hit, b_tmin, b_tmax = ray_aabb_object(
            s.o_loc, s.d_loc, b_lo, b_hi, prec.object_aabb_slop
        )
        # `temp_min_t < intersection.t && ...` (`rt/rtrt/cuda.hpp:436-437`)
        b_hit = (
            b_hit
            & (b_tmin.astype(f32) < s.best_t)
            & (b_tmin < max_dist_dt)
            & (b_tmax > min_dist_dt)
        )

        b_from_parent = s.bl == b_parent
        b_is_leaf = b_leaf_cnt > 0
        proc_leaf = blas_m & b_from_parent & b_hit & b_is_leaf
        b_descend = blas_m & b_from_parent & b_hit & ~b_is_leaf
        b_from_lc = blas_m & ~b_from_parent & (s.bl == b_lc)

        best_t, best_u, best_v = s.best_t, s.best_u, s.best_v
        best_tri, best_obj = s.best_tri, s.best_obj
        done = s.done
        for k in range(leaf_size):
            tri = _take(scene.blas_prim, b_leaf_off + k)
            k_valid = proc_leaf & (k < b_leaf_cnt) & (tri != skip_tri) & ~done
            gi = jnp.where(k_valid, tri, 0)
            v2 = _take(scene.tri_v2, gi)
            mM = _take(scene.tri_m, gi)
            v2f = _take(scene.tri_v2_f32, gi)
            mMf = _take(scene.tri_m_f32, gi)
            th = ray_triangle(
                s.o_loc,
                s.d_loc,
                v2,
                mM,
                v2f,
                mMf,
                best_t,
                min_dist,
                max_dist,
                prec,
                fallback=fallback,
            )
            upd = k_valid & th.accept
            best_t = jnp.where(upd, th.t, best_t)
            best_u = jnp.where(upd, th.u, best_u)
            best_v = jnp.where(upd, th.v, best_v)
            best_tri = jnp.where(upd, tri, best_tri)
            best_obj = jnp.where(upd, s.obj, best_obj)
            if find_any:
                done = done | upd

        b_desc_target = jnp.where(
            b_lc >= 0, b_lc, jnp.where(b_rc >= 0, b_rc, b_parent)
        )
        b_fromlc_target = jnp.where(b_rc >= 0, b_rc, b_parent)
        b_next = jnp.where(
            b_descend,
            b_desc_target,
            jnp.where(b_from_lc, b_fromlc_target, b_parent),
        )
        new_bc = jnp.where(blas_m, b_next, new_bc)
        new_bl = jnp.where(blas_m, s.bc, new_bl)
        # popped above the BLAS root -> back to TLAS mode
        exit_blas = blas_m & (new_bc < 0)
        new_mode = jnp.where(exit_blas, 0, new_mode)

        return S(
            it=s.it + 1,
            mode=new_mode,
            tl=new_tl,
            tc=new_tc,
            bl=new_bl,
            bc=new_bc,
            obj=new_obj,
            o_loc=new_o_loc,
            d_loc=new_d_loc,
            best_t=best_t,
            best_u=best_u,
            best_v=best_v,
            best_tri=best_tri,
            best_obj=best_obj,
            done=done,
        )

    s = jax.lax.while_loop(cond, body, s0)
    return Hit(t=s.best_t, u=s.best_u, v=s.best_v, tri=s.best_tri, obj=s.best_obj)
