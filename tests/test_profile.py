"""Profiler harness smoke test (reference §5.1: the per-stage timing tree,
`rt/gui/imgui_window.cu:86-91, 492-500`).

profile_frame re-executes the production schedule as separately-jitted
stages; this guards (a) that it runs at all (it duplicates the renderer's
call sequence and silently rots when render_frame's signature shifts), and
(b) that every reported stage name comes from the canonical reference list
in utils/timing.py."""

from __future__ import annotations

from low_precision_raytracer.config import RenderConfig
from low_precision_raytracer.models.procedural import cornell_box_scene
from low_precision_raytracer.render.profile import profile_frame
from low_precision_raytracer.render.renderer import Renderer
from low_precision_raytracer.utils.timing import STAGE_NAMES


def test_profile_frame_stage_names_and_values():
    # taa_mix_weight<1 keeps TAA active; at the default weight 1 the stage is
    # statically elided (out = cur exactly) and must be absent (tested below).
    cfg = RenderConfig(
        width=32, height=24, precision="bf16", gi_on=True, taa_mix_weight=0.9
    )
    r = Renderer(cornell_box_scene(), cfg)
    r.render()  # one production frame first, so temporal state is warm
    stats = profile_frame(r)
    measured = {k for k in stats if k != "TOTAL (staged)"}
    assert measured <= set(STAGE_NAMES)
    # GI on, TAA active: the full 12-stage schedule must be present
    assert measured == set(STAGE_NAMES)
    assert all(v >= 0.0 for v in stats.values())
    assert stats["TOTAL (staged)"] == sum(
        v for k, v in stats.items() if k != "TOTAL (staged)"
    )


def test_profile_frame_taa_elided_at_weight_one():
    # At the default taa_mix_weight=1 the blend is `out = cur` bitwise, so the
    # renderer elides the stage and the profiler must not report it.
    cfg = RenderConfig(width=32, height=24, precision="bf16", gi_on=True)
    assert cfg.taa_mix_weight == 1.0
    r = Renderer(cornell_box_scene(), cfg)
    r.render()
    stats = profile_frame(r)
    measured = {k for k in stats if k != "TOTAL (staged)"}
    assert "TAA" not in measured
    assert measured == set(STAGE_NAMES) - {"TAA"}


def test_profile_frame_no_gi_subset():
    cfg = RenderConfig(width=32, height=24, precision="fp32", gi_on=False)
    r = Renderer(cornell_box_scene(), cfg)
    r.render()
    stats = profile_frame(r)
    measured = {k for k in stats if k != "TOTAL (staged)"}
    assert measured <= set(STAGE_NAMES)
    # the GI-round stages must be absent when gi_on=False
    assert "Trace GI #1" not in measured
    assert "Shade #2" not in measured
