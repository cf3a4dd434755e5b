"""Utilities (reference Lx: `rt/utils/`)."""

from low_precision_raytracer.utils.log import get_logger, warn

__all__ = ["get_logger", "warn"]
