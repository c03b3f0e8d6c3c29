"""AdamW with the semantics of `optax.adamw` as the JAX package's bench
uses it (`optax.adamw(1e-4, b1=0.9, b2=0.95, mu_dtype=jnp.bfloat16)`).

State per leaf: `mu` in `mu_dtype` (the leaf's dtype when None) and `nu`
in the leaf's dtype (optax's `scale_by_adam.init_fn` builds it with
`zeros_like(params)`, so bf16 params keep a bf16 second moment), plus one
step `count` from 0. Weight decay applies to every leaf, norms and the
embedding included, as optax does without a mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def _weak(x: float, t: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing applies it to t: rounded to
    t's dtype first (optax's b1·mu with a bf16 mu multiplies by
    bf16(0.9) = 0.8984375)."""
    return torch.tensor(x, dtype=t.dtype).item()


def leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor of a nested dict, in key order."""
    if isinstance(tree, torch.Tensor):
        return [("", tree)]
    out = []
    for key in sorted(tree):
        for path, t in leaves(tree[key]):
            out.append((f"{key}/{path}" if path else key, t))
    return out


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.adamw` with the same arguments and defaults (no eps_root, no
    mask, no Nesterov): `init(params)` -> state, `update(params, grads,
    state)` in place."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for _, p in leaves(params)],
                "nu": [torch.zeros_like(p) for _, p in leaves(params)]}

    @torch.no_grad()
    def update(self, params, grads: Iterable[torch.Tensor],
               state: Dict) -> None:
        """One step, IN PLACE: optax is functional and returns new params
        and state; here the parameters, `mu` and `nu` are overwritten, so
        a step holds no second copy of them. `grads` follow the order of
        `leaves(params)`.

        Per leaf, in the dtypes optax computes in: mu' = (1-b1)·g + b1·mu,
        nu' = (1-b2)·g² + b2·nu, count += 1, u = (mu'/(1-b1^count)) /
        (sqrt(nu'/(1-b2^count)) + eps) + wd·p, p += −lr·u (cast back to
        p's dtype); mu' is stored in mu_dtype after the update used it.
        Each scalar is taken in the dtype of the tensor it meets, as in
        optax."""
        state["count"] += 1
        count = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** count)
        for (_, p), g, mu, nu in zip(leaves(params), grads, state["mu"],
                                     state["nu"]):
            m = g * _weak(1 - self.b1, g) + mu * _weak(self.b1, mu)
            v = g * g * _weak(1 - self.b2, g) + nu * _weak(self.b2, nu)
            u = (m / _weak(bc1, m)) / (torch.sqrt(v / _weak(bc2, v))
                                        + _weak(self.eps, v))
            u = (u + p * _weak(self.weight_decay, p)) * _weak(-self.lr, u)
            p.copy_(p + u)
            mu.copy_(m)
            nu.copy_(v)


adamw = AdamW   # adamw(lr, b1, b2, eps, weight_decay, mu_dtype), as optax
