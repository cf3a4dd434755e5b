"""Scene side of the framework (reference L1-L3': resources, acceleration
structures, hierarchy, asset ingestion)."""

from low_precision_raytracer.models.bvh import BVHArrays, build_bvh, build_blas, build_tlas
from low_precision_raytracer.models.materials import Material
from low_precision_raytracer.models.scene import (
    HostScene,
    Mesh,
    SceneArrays,
    SceneObject,
    build_scene_arrays,
)

__all__ = [
    "BVHArrays",
    "build_bvh",
    "build_blas",
    "build_tlas",
    "Material",
    "HostScene",
    "Mesh",
    "SceneArrays",
    "SceneObject",
    "build_scene_arrays",
]
