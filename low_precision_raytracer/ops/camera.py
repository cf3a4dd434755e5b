"""Primary-ray generation (`CUDARenderGISettings::get_primary_ray`,
`rt/rtrt/cuda.hpp:794-833`).

Pinhole rays in camera space ((x, y, -1) through the pixel center, y up,
-z forward), transformed by the camera's local-to-world.  Both reference
call sites pass ``omit_ar=true`` (aspect from width/height), so that is the
only mode implemented.  Row 0 of the (H, W) grid maps to normalized_y = -1
(image bottom); writers flip at export time.
"""

from __future__ import annotations

import jax.numpy as jnp

from low_precision_raytracer.math.vec import normalize


def primary_ray_grid(cam_l2w, fov_y, width: int, height: int, dtype):
    """-> origins (H, W, 3), directions (H, W, 3) in `dtype` (world space)."""
    dt = dtype
    x = (jnp.arange(width, dtype=jnp.float32) + 0.5) * (2.0 / width) - 1.0
    y = (jnp.arange(height, dtype=jnp.float32) + 0.5) * (2.0 / height) - 1.0
    nx, ny = jnp.meshgrid(x, y)  # (H, W)

    max_y = jnp.tan(jnp.asarray(fov_y, dt) / 2).astype(dt)
    yy = ny.astype(dt) * max_y
    xx = nx.astype(dt) * max_y * jnp.asarray(width / height, dt)

    d_local = jnp.stack([xx, yy, jnp.full_like(xx, -1.0)], axis=-1)
    d_local = normalize(d_local)

    m = cam_l2w.astype(dt)
    rot = m[:3, :3]
    d_w = normalize(d_local @ rot.T)
    o4 = m[:3, 3]
    w = m[3, 3]
    o_w = jnp.broadcast_to((o4 / w).astype(dt), d_w.shape)
    return o_w, d_w


def primary_ray_direction(cam_l2w, fov_y, width: int, height: int, dtype):
    """`get_primary_ray_direction` (`rt/rtrt/cuda.hpp:818-832`)."""
    _, d = primary_ray_grid(cam_l2w, fov_y, width, height, dtype)
    return d
