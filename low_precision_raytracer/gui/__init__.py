"""Interactive-viewer support (reference L6: `rt/gui/`).

The heavy UI (GLFW/ImGui) has no equivalent here; the headless CLI
(`low_precision_raytracer.cli`) is the primary interface.  This package
keeps the interaction logic that IS portable: the camera controllers."""

from low_precision_raytracer.gui.controller import (
    HoldRotateController,
    MoveController,
)

__all__ = ["MoveController", "HoldRotateController"]
