"""The carried frame state pytree (SURVEY.md §3.5): everything the reference
hands from frame N to frame N+1 through persistent device buffers."""

from __future__ import annotations

import jax.numpy as jnp

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.scene import pytree_dataclass
from low_precision_raytracer.ops.svgf import SVGFState, init_svgf_state


@pytree_dataclass(meta=())
class FrameState:
    # SVGF per-instance temporal state (colored / white demodulated channels,
    # run twice per frame like the reference, `rt/gui/imgui_window.cu:231-239`)
    svgf_colored: SVGFState
    svgf_white: SVGFState
    # TAA history colour (`buffer.taa_history_color`)
    taa_history: jnp.ndarray  # (H, W, 3) dtype
    # committed SVGF temporal-map frame counts (`svgf_temporal_map.frame_count`)
    svgf_frame_count: jnp.ndarray  # (H, W) i32
    # last frame's per-pixel mesh id / primitive (`LastFramePixelID`)
    last_mesh_id: jnp.ndarray  # (H, W) i32, -1 = empty
    last_prim: jnp.ndarray  # (H, W) i32
    # last frame's per-OBJECT L2W.  Deliberate deviation from the reference:
    # its backup key (`buffer.last_frame_L2W[objectid]`,
    # `rt/rtrt/cuda.hpp:2253-2263`) is the shared mesh/VAO index (set per
    # mesh at `rt/rtrt/loader.cu:634`, used as vao_index at
    # `rt/rtrt/cuda.hpp:549,967,2107`), so the reference collides instances
    # of a shared mesh last-writer-wins — every instance reprojects through
    # the last writer's transform, rejecting history in instanced scenes.
    # Keying per drawn OBJECT fixes that.  fp32: the reprojection matrix
    # chain is precision-critical.
    last_l2w: jnp.ndarray  # (n_objects, 4, 4) f32
    # last frame's world-to-clip (`buffer.last_frame_transform_W2C`)
    last_w2c: jnp.ndarray  # (4, 4) f32


def init_frame_state(cfg: RenderConfig, n_objects: int) -> FrameState:
    dt = cfg.dtype
    H, W = cfg.height, cfg.width
    # SVGF state rides in fp32 under svgf.state_f32 (the default): bf16
    # history requantisation costs ~3 dB of converged quality (see
    # config.SVGFConfig.state_f32)
    sdt = jnp.float32 if cfg.svgf.state_f32 else dt
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n_objects, 4, 4))
    return FrameState(
        svgf_colored=init_svgf_state(H, W, sdt),
        svgf_white=init_svgf_state(H, W, sdt),
        # TAA history is carried state like the SVGF planes: a bf16 history
        # re-rounds the displayed image every blend (random-walk of rounding
        # error through the 0.8*hist recursion), so it follows state_f32
        taa_history=jnp.zeros((H, W, 3), sdt),
        svgf_frame_count=jnp.zeros((H, W), jnp.int32),
        last_mesh_id=jnp.full((H, W), -1, jnp.int32),
        last_prim=jnp.zeros((H, W), jnp.int32),
        last_l2w=eye,
        last_w2c=jnp.eye(4, dtype=jnp.float32),
    )
