"""Node resource detection, GPU-first.

The port's copy of ray_tpu/runtime/resources.py, with the NVIDIA GPU in
the place the JAX package gives the TPU: a node advertises {"CPU",
"memory", "GPU", ...}, the GPU count from `detect_gpus`
(runtime/accelerators.py) unless `num_gpus` says otherwise. The TPU chip
detection, the slice labels and the TPU-{pod}-head resource are not
ported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def whole_gpus(num_gpus: float, what: str = "num_gpus") -> float:
    """A GPU demand as a float, refused unless it is a whole number of
    cards: a lease's cards are isolated per worker (CUDA_VISIBLE_DEVICES),
    so a fraction of a card cannot be handed out."""
    if num_gpus < 0 or float(num_gpus) != int(num_gpus):
        raise ValueError(f"{what} must be a whole number of cards, "
                         f"got {num_gpus!r}")
    return float(num_gpus)


def node_resources(num_cpus: Optional[float] = None,
                   num_gpus: Optional[float] = None,
                   memory: Optional[int] = None,
                   resources: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    from ray_tpu_torch.runtime import accelerators as accel_mod

    out: Dict[str, float] = {}
    if num_cpus is None:
        num_cpus = float(os.cpu_count() or 1)
    out["CPU"] = float(num_cpus)
    if num_gpus is None:
        num_gpus = float(accel_mod.detect_gpus())
    if num_gpus:
        out["GPU"] = whole_gpus(num_gpus)
    if memory is None:
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        memory = int(line.split()[1]) * 1024
                        break
        except OSError:
            memory = 0
    if memory:
        out["memory"] = float(memory)
    for k, v in (resources or {}).items():
        out[k] = float(v)
    return out
