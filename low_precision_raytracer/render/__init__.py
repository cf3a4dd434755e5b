"""Frame orchestration (reference L5: `Renderer<DataT>`,
`rt/gui/imgui_window.cu:78-367`)."""

from low_precision_raytracer.render.framestate import FrameState, init_frame_state
from low_precision_raytracer.render.renderer import Renderer, render_frame

__all__ = ["FrameState", "init_frame_state", "Renderer", "render_frame"]
