"""Facts of the card a run used: its name, count and power limit."""

from __future__ import annotations

import subprocess

import torch


def power_limit_w() -> float | None:
    """The first card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(proc.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        return None


def facts(device: torch.device, count: int, peak_bytes: int) -> dict:
    """The result's ``device`` object."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak_bytes}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": peak_bytes,
        "power_limit_w": power_limit_w(),
    }
