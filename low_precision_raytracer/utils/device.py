"""The device a measurement ran on.

Every number this repository prints about speed names the device it came
from: JAX's platform, device kind and count, and the card's name and power
limit as `nvidia-smi` reports them (a card set below its maximum power runs
slower under load).  A measurement path that finds no GPU fails instead of
timing the CPU.
"""

from __future__ import annotations

import subprocess

import jax


def card_lines() -> list[str]:
    """`name, power.limit` of every card, one line each, as nvidia-smi
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def require_gpu() -> dict:
    """-> {platform, kind, count, card}; raises when JAX runs on no GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform!r} ({devs[0].device_kind}); "
            "device timings are only taken on a GPU"
        )
    lines = card_lines()
    return dict(
        platform=devs[0].platform,
        kind=devs[0].device_kind,
        count=len(devs),
        card=lines[0] if lines else "unknown",
    )
