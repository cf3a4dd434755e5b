"""Checkpoint / resume (SURVEY.md §5.4).

The reference persists nothing (its temporal state is intra-session only).
Here the carried FrameState pytree + RNG key + frame index serialize to one
.npz so animated sequences resume deterministically."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from low_precision_raytracer.ops.svgf import SVGFState
from low_precision_raytracer.render.framestate import FrameState

# single source of the 12 checkpoint fields: save and load both walk these
# dotted paths, so adding a FrameState leaf is a one-line change
_FIELDS = [
    "svgf_colored.miu1", "svgf_colored.miu2", "svgf_colored.color_history",
    "svgf_white.miu1", "svgf_white.miu2", "svgf_white.color_history",
    "taa_history", "svgf_frame_count", "last_mesh_id", "last_prim",
    "last_l2w", "last_w2c",
]


def _get_path(obj, dotted: str):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def save_checkpoint(path: str, state: FrameState, key, frame_index: int) -> None:
    arrays = {}
    dtypes = {}
    for k in _FIELDS:
        a = np.asarray(_get_path(state, k))
        dtypes[k] = str(a.dtype)
        # bf16 has no portable npz dtype; store as f32 + original dtype tag
        arrays[k] = a.astype(np.float32) if "bfloat16" in dtypes[k] else a
    # the PRNG implementation is part of the key's identity: a typed `rbg`
    # key has 4-word data while the default wrap_key_data impl is
    # threefry2x32 (2-word) — dropping it would resume with a wrong-shaped
    # (and wrong-stream) key.  Legacy raw uint32 PRNGKeys round-trip as-is.
    if jnp.issubdtype(jnp.asarray(key).dtype, jax.dtypes.prng_key):
        key_data = np.asarray(jax.random.key_data(key))
        key_impl = str(jax.random.key_impl(key))
    else:
        key_data = np.asarray(key)
        key_impl = "__raw__"
    np.savez(
        path,
        __key__=key_data,
        __key_impl__=np.asarray(key_impl),
        __frame_index__=np.asarray(frame_index),
        __dtypes__=np.asarray(list(f"{k}|{dtypes[k]}" for k in _FIELDS)),
        **arrays,
    )


def load_checkpoint(path: str):
    """-> (FrameState, key, frame_index)."""
    import ml_dtypes

    z = np.load(path, allow_pickle=False)
    dtypes = dict(s.split("|") for s in z["__dtypes__"].tolist())

    def get(k):
        a = z[k]
        if "bfloat16" in dtypes[k]:
            a = a.astype(ml_dtypes.bfloat16)
        return jnp.asarray(a)

    vals = {k: get(k) for k in _FIELDS}
    state = FrameState(
        svgf_colored=SVGFState(
            miu1=vals["svgf_colored.miu1"],
            miu2=vals["svgf_colored.miu2"],
            color_history=vals["svgf_colored.color_history"],
        ),
        svgf_white=SVGFState(
            miu1=vals["svgf_white.miu1"],
            miu2=vals["svgf_white.miu2"],
            color_history=vals["svgf_white.color_history"],
        ),
        **{k: vals[k] for k in _FIELDS if "." not in k},
    )
    impl = str(z["__key_impl__"]) if "__key_impl__" in z.files else ""
    kd = jnp.asarray(z["__key__"])
    if impl == "__raw__":
        key = kd  # legacy raw uint32 PRNGKey
    elif impl:
        key = jax.random.wrap_key_data(kd, impl=impl)
    else:  # pre-impl-tag checkpoint: the old default (threefry2x32)
        key = jax.random.wrap_key_data(kd)
    return state, key, int(z["__frame_index__"])
