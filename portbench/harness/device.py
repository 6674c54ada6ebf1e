"""The card a run uses: it is there or the run stops; its name, power limit
and memory peak go beside the numbers."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    """No CUDA device, or fewer than the cell asks for."""


def require(chips: int) -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"the cell needs {chips} CUDA device(s); this machine has {have}")
    return torch.device("cuda", 0)


def power_limit() -> str:
    """nvidia-smi's power limit of card 0, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def describe(device: torch.device, chips: int) -> dict:
    """The result's ``device`` entry, the peak read now."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
