"""What a measurement records about the device it ran on."""

from __future__ import annotations

import shutil
import subprocess


def nvidia_smi_name_power() -> str | None:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (one line per card), or None where nvidia-smi is not installed."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, kind and count of JAX's devices, plus nvidia-smi's name
    and power limit: the fields every stored measurement carries."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": nvidia_smi_name_power()}
