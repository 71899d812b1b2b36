"""The accelerator a measurement runs on, named the way results record it.

A measurement (bench.py, chip_smoke.py) needs a GPU: it fails when JAX
finds none, and never falls back to the CPU.
"""

from __future__ import annotations

import subprocess

__all__ = ["nvidia_smi_name_power", "device_record"]


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of the devices JAX reports."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
