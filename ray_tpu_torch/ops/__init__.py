"""Compute ops of the PyTorch port (layers, attention, paged attention).

Device policy lives here. Every entry point of the port takes a `device`
argument that defaults to "cuda"; :func:`resolve_device` turns it into a
`torch.device` and raises when CUDA was asked for (explicitly or by
default) but is missing. The port never falls back to the CPU on its own:
a caller who wants the plain PyTorch versions passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def is_cuda_backend() -> bool:
    """True when PyTorch can launch work on a CUDA device."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """None / "cuda" / "cuda:N" / "cpu" / torch.device -> torch.device.

    Raises RuntimeError for a CUDA device when CUDA is unavailable: the
    caller must ask for "cpu" explicitly to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not is_cuda_backend():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
