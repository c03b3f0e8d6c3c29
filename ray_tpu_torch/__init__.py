"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, beside the JAX package.

The port imports torch, numpy and the standard library only — never jax
and never a `ray_tpu.` module; it keeps its own copy of what it needs.
It serves Llama-3 through the unified ragged tick and the split path
(`ray_tpu_torch.llm`), with ragged paged attention as CUDA kernels
written for Hopper (`ray_tpu_torch.ops.csrc.paged_attention`), and trains
a Llama on one card (`ray_tpu_torch.train`) through flash attention's
forward, dQ and dK/dV kernels (`ray_tpu_torch.ops.csrc.flash_attention`).
"""

from ray_tpu_torch.ops import is_cuda_backend, resolve_device

__all__ = ["is_cuda_backend", "resolve_device"]
