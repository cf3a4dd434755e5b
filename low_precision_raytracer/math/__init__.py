"""Numerics layer (reference L0: `rt/math/number.hpp`, `rt/math/matrix.hpp`).

- :mod:`.hostmath` — numpy scene-building math (error-free transforms,
  analytic inverses, quaternions, camera matrices).  Runs at load / flatten
  time on the host, like the reference's host-side Matrix code.
- :mod:`.vec` — jnp device helpers over ``(..., 3)`` / ``(..., 4, 4)``
  arrays used inside jitted kernels.

There is no scalar `float16` wrapper class: the precision is a dtype
parameter (`jnp.bfloat16` / `jnp.float16` / `jnp.float32`) threaded through
every kernel (SURVEY.md 2.1).
"""

from low_precision_raytracer.math.hostmath import (
    cross_product_difference,
    difference_of_products,
    inverse_3x3_dop,
    look_at,
    perspective,
    quaternion_to_matrix,
    trs_matrix,
)
from low_precision_raytracer.math.vec import (
    dot,
    normalize,
    reflect,
    transform_dir,
    transform_point,
)

__all__ = [
    "cross_product_difference",
    "difference_of_products",
    "inverse_3x3_dop",
    "look_at",
    "perspective",
    "quaternion_to_matrix",
    "trs_matrix",
    "dot",
    "normalize",
    "reflect",
    "transform_dir",
    "transform_point",
]
