"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import subprocess

import torch

__all__ = ["resolve_device", "device_info"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA. Raises when a CUDA device is asked for and absent:
    nothing falls back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "roreg_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_info(dev: torch.device) -> dict:
    """What a measurement names its device by: ``{"name": "cpu"}``, or the
    card's name and ``nvidia-smi``'s name and power limit line."""
    if dev.type != "cuda":
        return {"name": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(dev), "nvidia_smi": smi}
