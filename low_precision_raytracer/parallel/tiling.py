"""Pixel-tile sharding of the render step.

Design (SURVEY.md §5.8): shard the image row dimension across devices;
replicate the scene (BVH, vertices, materials, textures — they are read-only
per frame).  The carried FrameState's pixel arrays shard the same way, so
temporal state stays tile-local; reprojection gathers that cross tile
boundaries and SVGF stencil halos lower to XLA collectives automatically
under GSPMD sharding propagation.  Zero per-frame communication otherwise.
The mesh is flat and 1-D: on GPUs joined all to all by NVLink every card
reaches every other at the same rate, so no device order is preferred.
"""

from __future__ import annotations



import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.render.renderer import render_frame

PIXEL_AXIS = "px"


def make_pixel_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (PIXEL_AXIS,))


def _state_spec(state):
    """Rows-sharded spec for pixel-shaped FrameState leaves, replicated for
    scene-shaped ones (last_l2w, last_w2c)."""
    from low_precision_raytracer.ops.svgf import SVGFState
    from low_precision_raytracer.render.framestate import FrameState

    row = P(PIXEL_AXIS)
    rep = P()
    return FrameState(
        svgf_colored=SVGFState(miu1=row, miu2=row, color_history=row),
        svgf_white=SVGFState(miu1=row, miu2=row, color_history=row),
        taa_history=row,
        svgf_frame_count=row,
        last_mesh_id=row,
        last_prim=row,
        last_l2w=rep,
        last_w2c=rep,
    )


def shard_specs(scene, frame, state):
    """(scene_spec, frame_spec, state_spec) PartitionSpec pytrees."""
    rep = P()
    scene_spec = jax.tree.map(lambda _: rep, scene)
    frame_spec = jax.tree.map(lambda _: rep, frame)
    return scene_spec, frame_spec, _state_spec(state)


def render_frame_sharded(mesh: Mesh, scene, frame, state, cfg: RenderConfig, key):
    """Jit the full render step with pixel rows sharded over the mesh.

    The trace stages run under `shard_map` (rays partitioned over the pixel
    axis, scene replicated — see ops/trace.py) so a trace kernel executes
    per shard by construction; the elementwise/stencil stages stay under
    GSPMD propagation, where the cross-tile reads (reprojection history
    taps, SVGF wavelet halos) lower to XLA-inserted collectives.  The SVGF
    stencils take their unrolled-tap form under a mesh (ops/svgf.py), whose
    static slice offsets GSPMD partitions into bounded row-halo
    collective-permutes instead of all-gathers; the temporal fetch uses the
    explicit halo exchange in ops/reproject.py.  Halo payload scales with
    image WIDTH times the per-stencil halo rows (<= 16 rows + the temporal
    window), not with shard height or device count.

    cfg.height must be divisible by the mesh size."""
    assert cfg.height % mesh.devices.size == 0, (
        f"height {cfg.height} not divisible by {mesh.devices.size} devices"
    )
    if cfg.mesh is None:
        cfg = cfg.replace(mesh=mesh)
    scene_spec, frame_spec, state_spec = shard_specs(scene, frame, state)
    ns = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec)

    scene_s = jax.device_put(scene, ns(scene_spec))
    frame_s = jax.device_put(frame, ns(frame_spec))
    state_s = jax.device_put(state, ns(state_spec))

    # jit caches by callable IDENTITY: a fresh lambda per call would retrace
    # and recompile the whole pipeline EVERY frame.  Cache the jitted step
    # per (mesh, cfg) — frames 2+ of a sharded run hit the compiled program.
    fn = _sharded_step(mesh, cfg, jax.tree.structure(scene), jax.tree.structure(state))
    return fn(scene_s, frame_s, state_s, key)


import functools as _functools


@_functools.lru_cache(maxsize=8)
def _sharded_step(mesh, cfg, _scene_treedef, _state_treedef):
    """Jitted sharded render step, cached on (mesh, cfg) — the treedefs key
    structural changes (e.g. different FrameState versions) without holding
    array references."""
    ns = lambda spec: jax.tree.map(lambda s: NamedSharding(mesh, s), spec)
    rep = P()  # scene/frame are fully replicated: one prefix sharding each
    state_spec = _state_spec(None)
    return jax.jit(
        lambda scene, frame, state, key: render_frame(scene, frame, state, cfg, key),
        in_shardings=(
            NamedSharding(mesh, rep),
            NamedSharding(mesh, rep),
            ns(state_spec),
            None,
        ),
        out_shardings=(
            NamedSharding(mesh, P(PIXEL_AXIS)),
            None,
            ns(state_spec),
        ),
    )
