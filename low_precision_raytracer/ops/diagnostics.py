"""Low-precision diagnostics (SURVEY.md §5.5): metrics the reference cannot
observe but this framework should, chiefly the **fp32-fallback rate** — the
fraction of dtype triangle tests that land inside the rounding-error
ambiguity band and are re-run in fp32.  It quantifies the low-precision
hypothesis per scene/precision."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from low_precision_raytracer.config import Precision

F32 = jnp.float32

# rays per chunk: bounds the (chunk, TI) fp32 intermediates this diagnostic
# materializes (~14 of them) — at the 4M-tri dense-coefficient ceiling a
# full 1080p ray grid against TI would need terabytes un-chunked
CHUNK = 8192


def _mm(a, b):
    return jnp.dot(a, b, preferred_element_type=F32)


def _mm_bound(a, b):
    """Error-BOUND matmul at explicit DEFAULT precision, as the reference
    route computes it (ops/dense.py:_mm_bound); the config pins the global
    default to HIGHEST, so a bare dot here would classify band edges
    differently from what the trace actually does."""
    return jnp.dot(
        a, b, preferred_element_type=F32, precision=jax.lax.Precision.DEFAULT
    )


def _fallback_counts(frame, origins, directions, prec: Precision):
    """One ray chunk -> (tested, ambiguous) device scalars."""
    dt = prec.dtype
    c = frame.dense_center
    o = (origins.astype(F32) - c).astype(dt)
    d = directions.astype(dt)

    TI = frame.dense_n.shape[0]
    n_dt = frame.dense_n.reshape(TI, 9)
    e = frame.dense_e
    n0 = n_dt[:, 0:3].T
    n1 = n_dt[:, 3:6].T
    n2f = frame.dense_n_f32.reshape(TI, 9)[:, 6:9].T

    Ox = _mm(o, n0) + e[:, 0]
    Dx = _mm(d, n0)
    Oy = _mm(o, n1) + e[:, 1]
    Dy = _mm(d, n1)
    Oz = _mm(o.astype(F32), n2f) + e[:, 2]
    Dz = _mm(d.astype(F32), n2f)
    t = -Oz / Dz
    u = Ox + t * Dx
    v = Oy + t * Dy

    # KEEP IN SYNC with the canonical band algebra in ops/triangle.py
    # (:103-115) — this diagnostic re-states it in the dense matmul form
    # (like ops/dense.py) because it must count ALL (ray, tri) tests, not
    # the per-hit scalar path; if the 0.2 scale, the one-sided band, or the
    # delta propagation changes there, change it here or the reported
    # fp32-fallback rate stops measuring what the kernels actually do
    d1 = jnp.asarray(prec.delta1, F32)
    d2 = jnp.asarray(prec.delta2, F32)
    d12 = d1 + d2
    s_ox = _mm_bound(jnp.abs(o), jnp.abs(n0)) + jnp.abs(e[:, 0])
    s_dx = _mm_bound(jnp.abs(d), jnp.abs(n0))
    s_oy = _mm_bound(jnp.abs(o), jnp.abs(n1)) + jnp.abs(e[:, 1])
    s_dy = _mm_bound(jnp.abs(d), jnp.abs(n1))
    error_u = (d12 * s_ox + t * d12 * s_dx + d1 * (jnp.abs(Ox) + 3 * jnp.abs(u - Ox))) * 0.2
    error_v = (d12 * s_oy + t * d12 * s_dy + d1 * (jnp.abs(Oy) + 3 * jnp.abs(v - Oy))) * 0.2

    w = 1.0 - u - v
    in_band = lambda x, err: (x >= -err) & (x <= 0)
    # only forward, finite tests count (the reference's outer `if`)
    valid = jnp.isfinite(t) & (t > 0)
    ambiguous = (
        in_band(u, error_u) | in_band(v, error_v) | in_band(w, error_u + error_v)
    ) & valid
    # per-RAY counts (<= TI each, int32-safe); the chunk total can overflow
    # int32 at large TI, so the caller sums these exactly on the host
    return jnp.sum(valid, axis=1), jnp.sum(ambiguous, axis=1)


def fallback_rate(frame, origins, directions, prec: Precision, chunk: int = CHUNK):
    """-> dict(tested, ambiguous, rate): counts over all (ray, instance-
    triangle) dtype tests for the given ray batch (dense-mode scenes).
    Rays are processed in `chunk`-sized slices like ops/dense.py so the
    (chunk, TI) intermediates stay bounded at any scene size."""
    assert frame.dense_n is not None, "fallback_rate needs dense coefficients"
    R = origins.shape[0]
    # accumulate exact host ints: a chunk's count alone (chunk * TI) can
    # exceed int32, and this is an eager one-shot diagnostic anyway
    import numpy as np

    tested = 0
    amb = 0
    for r0 in range(0, R, chunk):
        tc, ac = _fallback_counts(
            frame, origins[r0 : r0 + chunk], directions[r0 : r0 + chunk], prec
        )
        tested += int(np.asarray(tc).sum(dtype=np.int64))
        amb += int(np.asarray(ac).sum(dtype=np.int64))
    return dict(tested=tested, ambiguous=amb, rate=amb / max(tested, 1))
