"""Per-stage timing harness (reference §5.1: `Renderer::timing` +
the ImGui statistics tree, `rt/gui/imgui_window.cu:86-91, 492-500`).

Production frames run as one fused jit program; the profiler
(render/profile.py) re-runs the stages with `block_until_ready` between
them ONLY in profile mode, producing a timing dict keyed by the
reference's stage names."""

from __future__ import annotations

# the reference's 12 stage names (`rt/gui/imgui_window.cu:154-328`)
STAGE_NAMES = [
    "Primary Ray",
    "Generate Temporal Map",
    "Pixel Shade #1",
    "Trace DI Ray #1",
    "Accumulate DI #1",
    "Trace GI #1",
    "Shade #2",
    "Trace DI #2",
    "Accumulate DI #2",
    "SVGF",
    "TAA",
    "Backup Temporal Data",
]
