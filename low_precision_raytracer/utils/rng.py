"""Production RNG keys.

One helper so every production entry point (Renderer, bench, viewer, CLI)
draws from the same generator: threefry, deterministic across backends, so
golden images and cross-backend oracles do not depend on where a frame was
rendered.  The shade stage draws uniforms only (ops/sampling.py
`uniform_hemisphere_trig`), so the generator's cost is a few draws per
pixel per round.
"""

from __future__ import annotations

import jax


def render_key(seed: int = 0):
    """Frame-loop RNG key (threefry)."""
    return jax.random.PRNGKey(seed)
