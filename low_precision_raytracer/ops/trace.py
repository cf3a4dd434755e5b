"""Trace dispatcher: picks the intersection backend per cfg + scene size.

- 'dense'       : XLA all-pairs (ops/dense.py) — the plain reference, and
                  the route on backends without a GPU;
- 'dense_triton': the same all-pairs test as one fused GPU kernel
                  (ops/dense_triton.py);
- 'jax'         : lane-parallel two-level BVH walk (ops/traversal.py);
- 'auto'        : all-pairs for small scenes (the kernel on a GPU, XLA
                  elsewhere), the BVH walk otherwise.

Scene size is static (array shapes), so the choice is made at trace time
and baked into the compiled program.
"""

from __future__ import annotations

import jax

from low_precision_raytracer.config import Precision, RenderConfig
from low_precision_raytracer.models.scene import DENSE_MAX_OBJECTS, DENSE_MAX_TRIS
from low_precision_raytracer.ops.dense import trace_rays_dense
from low_precision_raytracer.ops.traversal import Hit, trace_rays


def _instance_tris(frame) -> int:
    return int(sum(t1 - t0 for _m, t0, t1 in frame.obj_layout))


def resolve_impl(scene, frame, cfg: RenderConfig) -> str:
    """Resolve 'auto' to a concrete backend from the static instance layout
    and the backend JAX runs on."""
    impl = cfg.traversal_impl
    if impl != "auto":
        return impl
    n_obj = len(frame.obj_layout)
    if 0 < n_obj <= DENSE_MAX_OBJECTS and _instance_tris(frame) <= DENSE_MAX_TRIS:
        return "dense_triton" if jax.default_backend() == "gpu" else "dense"
    return "jax"


def resolve_cfg(scene, frame, cfg: RenderConfig) -> RenderConfig:
    if cfg.traversal_impl == "auto":
        return cfg.replace(traversal_impl=resolve_impl(scene, frame, cfg))
    return cfg


def trace(
    scene,
    frame,
    origins,
    directions,
    *,
    prec: Precision,
    cfg: RenderConfig,
    find_any: bool = False,
    skip_tri=None,
    min_dist=0.0,
    max_dist=1e5,
) -> Hit:
    """Closest hit (or any hit) for (R, 3) rays.

    With `cfg.mesh` set (several devices, parallel/tiling.py), the whole
    launch runs under `shard_map`: rays partition over the mesh's pixel
    axis and the scene/frame stay replicated, so a kernel executes per
    shard by construction (never GSPMD-replicated).  Any contiguous ray
    partition is valid — the trace is ray-wise independent."""
    import jax.numpy as jnp

    if cfg.mesh is not None:
        from jax.sharding import PartitionSpec as P

        mesh = cfg.mesh
        n_dev = int(mesh.devices.size)
        R = origins.shape[0]
        assert R % n_dev == 0, f"{R} rays not divisible by {n_dev} devices"
        if skip_tri is None:
            skip_tri = jnp.full((R,), -1, jnp.int32)
        min_dist = jnp.broadcast_to(jnp.asarray(min_dist, jnp.float32), (R,))
        max_dist = jnp.broadcast_to(jnp.asarray(max_dist, jnp.float32), (R,))
        cfg_local = cfg.replace(mesh=None)

        def local_trace(scene, frame, o, d, s, mn, mx):
            return trace(
                scene, frame, o, d, prec=prec, cfg=cfg_local,
                find_any=find_any, skip_tri=s, min_dist=mn, max_dist=mx,
            )

        rep = lambda tree: jax.tree.map(lambda _: P(), tree)
        ray = P(mesh.axis_names[0])
        return jax.shard_map(
            local_trace,
            mesh=mesh,
            in_specs=(rep(scene), rep(frame), ray, ray, ray, ray, ray),
            out_specs=Hit(t=ray, u=ray, v=ray, tri=ray, obj=ray),
            check_vma=False,
        )(scene, frame, origins, directions, skip_tri, min_dist, max_dist)

    impl = resolve_impl(scene, frame, cfg)
    fallback = "both" if cfg.triangle_fallback == "auto" else cfg.triangle_fallback
    kw = dict(
        prec=prec, fallback=fallback, skip_tri=skip_tri, min_dist=min_dist,
        max_dist=max_dist, find_any=find_any,
    )
    if impl == "dense":
        return trace_rays_dense(scene, frame, origins, directions, **kw)
    if impl == "dense_triton":
        from low_precision_raytracer.ops.dense_triton import (
            trace_rays_dense_triton,
        )

        return trace_rays_dense_triton(scene, frame, origins, directions, **kw)
    return trace_rays(
        scene, frame, origins, directions, leaf_size=cfg.bvh_leaf_size, **kw
    )
