"""Device selection.  The caller names the device; the port never picks
another one for it."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device, ``"cpu"`` -> the CPU.

    Raises RuntimeError when CUDA is asked for and absent: a run that asked
    for the card and silently ran on the CPU would report the wrong
    device's numbers.
    """
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is false"
            )
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}; expected 'cuda' or 'cpu'")


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card), e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``.
    Every time measured on the card is reported beside this line: a card
    set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]
