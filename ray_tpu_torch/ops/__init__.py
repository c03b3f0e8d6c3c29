"""Compute ops of the PyTorch port (layers, attention, paged attention).

Device policy lives here. Every entry point of the port takes a `device`
argument that defaults to "cuda"; :func:`resolve_device` turns it into a
`torch.device` and raises when CUDA was asked for (explicitly or by
default) but is missing. The port never falls back to the CPU on its own:
a caller who wants the plain PyTorch versions passes ``device="cpu"``.
The host conversions (:func:`to_torch`, :func:`to_numpy`) carry weights
and KV pages between numpy (the JAX package's arrays) and the port.
"""

from __future__ import annotations

import numpy as np
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


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor, sharing its memory where it can."""
    # Writable + C-contiguous (np.asarray of a jax array is read-only);
    # copies only when the input is not already so.
    arr = np.require(arr, requirements=["C", "W"])
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what np.asarray of a jax bf16 array gives)
        # is refused by torch.from_numpy: reinterpret the 16-bit payload.
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array; bf16 (which numpy lacks) as its uint16
    bits."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()
