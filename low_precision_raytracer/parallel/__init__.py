"""Multi-device scaling (SURVEY.md §5.8).

The reference has no distributed backend — its parallelism is per-pixel SIMT.
The analogue here is pixel-tile DATA parallelism over a
`jax.sharding.Mesh`: each device owns a band of image rows, scene arrays are
replicated, and XLA/GSPMD inserts the halo exchanges for the SVGF stencils
and the collectives for cross-tile reprojection gathers.
No tensor/pipeline parallelism is meaningful for this workload
(SURVEY.md §2 'Parallelism & communication')."""

from low_precision_raytracer.parallel.tiling import (
    make_pixel_mesh,
    render_frame_sharded,
    shard_specs,
)

__all__ = ["make_pixel_mesh", "render_frame_sharded", "shard_specs"]
