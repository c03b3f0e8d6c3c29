"""NVIDIA GPU detection and worker isolation.

The port's copy of ray_tpu/runtime/accelerators.py, with the NVIDIA GPU as
the one accelerator. Reference analog: python/ray/_private/accelerators/
nvidia_gpu.py. `detect_gpus` counts the node's cards; the raylet starts a
worker whose lease holds cards with `visibility_env` (CUDA_VISIBLE_DEVICES
set to the lease's card ids). The JAX package's manager registry, its TPU
manager and its slice labels are not ported.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import Dict, Tuple


def _nvidia_smi_count() -> int:
    """Cards `nvidia-smi -L` lists, 0 without the tool (or if it fails)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return 0
    try:
        out = subprocess.run([exe, "-L"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def detect_gpus() -> int:
    """Number of NVIDIA cards this node offers (0 = none).
    RAY_TPU_TORCH_FAKE_GPUS overrides the count (CPU tests)."""
    fake = os.environ.get("RAY_TPU_TORCH_FAKE_GPUS")
    if fake:
        return int(fake)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return len([d for d in visible.split(",") if d.strip() != ""])
    if shutil.which("nvidia-smi"):
        # The driver's own list: a container may hold device nodes
        # (/dev/nvidiaN) of cards it cannot use.
        return _nvidia_smi_count()
    return len(glob.glob("/dev/nvidia[0-9]*"))


def visibility_env(device_ids: Tuple[int, ...]) -> Dict[str, str]:
    """Env vars isolating a worker to `device_ids`. Card ids index this
    process's own visible cards: where it was itself confined
    (CUDA_VISIBLE_DEVICES), id i is the i-th of them."""
    parent = [d.strip() for d in os.environ.get(
        "CUDA_VISIBLE_DEVICES", "").split(",") if d.strip()]
    names = [parent[i] if i < len(parent) else str(i) for i in device_ids]
    return {"CUDA_VISIBLE_DEVICES": ",".join(names)}
