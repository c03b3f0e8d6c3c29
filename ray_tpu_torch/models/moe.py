"""Mixtral-family sparse MoE decoder with expert parallelism (port of
ray_tpu/models/moe.py).

Llama-3 attention (`llama.attention_sublayer`) with the dense SwiGLU MLP
replaced by a top-k softmax router and E SwiGLU experts (Mixtral: top-k
gates renormalised to sum to 1). Routing is the JAX package's static-
capacity dense dispatch: per (batch row, expert) a queue of C slots,
filled choice-rank-major (every top-1 route before any top-2 route), so
over-capacity drops hit lower-ranked choices first; dropped tokens add
nothing and the residual carries them. Aux losses: switch-style load
balancing and the router z-loss.

Under a mesh (`parallel.mesh.use_mesh`) experts are a stacked weight dim
sharded over `ep` ("expert"): the dispatched slots (E, b, C, d) go to the
ranks holding their experts by an all-to-all over ep (batch gathered,
experts split) and come back by the inverse all-to-all before the
combine, which is what GSPMD makes of the JAX package's all-gather over ep
before the dispatch and slice after the combine. With the sequence over
sp, each rank fills its tokens' slots of the global queue (per-shard
counts all-gathered over sp); with the expert width over tp, f is on the
dispatched tokens and the gates and g on the combined output.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import resolve_device, to_torch
from ray_tpu_torch.ops.layers import rms_norm, swiglu
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import current_mesh
from ray_tpu_torch.parallel.sharding import axes_of

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
              "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 4096            # per-expert FFN width
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attention_impl: str = "auto"
    sp_axis: str = "sp"
    balance_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def capacity(self, seq: int) -> int:
        """Static per-expert token capacity for a (batch-row, seq) shard."""
        cap = self.capacity_factor * self.top_k * seq / self.n_experts
        return max(1, math.ceil(cap))

    @staticmethod
    def mixtral_8x7b(**overrides) -> "MoEConfig":
        base = dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                    n_kv_heads=8, d_ff=14336, n_experts=8, top_k=2,
                    rope_theta=1e6)
        base.update(overrides)
        return MoEConfig(**base)

    @staticmethod
    def tiny(**overrides) -> "MoEConfig":
        base = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, d_ff=96, n_experts=4, top_k=2, max_seq=128)
        base.update(overrides)
        return MoEConfig(**base)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def num_params(self) -> int:
        d, f, v, L, E = (self.d_model, self.d_ff, self.vocab_size,
                         self.n_layers, self.n_experts)
        moe = d * E + 3 * E * d * f
        return v * d + L * (self._attn_params() + moe + 2 * d) + d + d * v

    def active_params(self) -> int:
        """Parameters touched per token (top-k of E experts)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        moe = d * self.n_experts + 3 * self.top_k * d * f
        return (self.vocab_size * d + L * (self._attn_params() + moe + 2 * d)
                + d + d * self.vocab_size)

    def flops_per_token(self, seq: int) -> float:
        n = self.active_params() - self.vocab_size * self.d_model
        return 6.0 * n + 12 * self.n_layers * self.d_model * seq


# ---------------------------------------------------------------- parameters

def init_params(config: MoEConfig, generator: torch.Generator,
                device="cuda") -> Dict:
    """Random weights with the JAX package's scales and layouts (the router
    in fp32: routing decisions are precision-sensitive). The generator
    must live on `device`."""
    dev = resolve_device(device)
    d, f, v = config.d_model, config.d_ff, config.vocab_size
    hd, H, K = config.head_dim, config.n_heads, config.n_kv_heads
    L, E = config.n_layers, config.n_experts

    def dense(shape, fan_in):
        return llama._dense(shape, fan_in, config, generator, dev)

    def ones(shape):
        return torch.ones(shape, dtype=config.dtype, device=dev)

    router = torch.randn((L, d, E), generator=generator, dtype=torch.float32,
                         device=dev) * (1.0 / math.sqrt(d))
    return {
        "embed": dense((v, d), d),
        "layers": {
            "attn_norm": ones((L, d)),
            "wq": dense((L, d, H * hd), d),
            "wk": dense((L, d, K * hd), d),
            "wv": dense((L, d, K * hd), d),
            "wo": dense((L, H * hd, d), H * hd),
            "mlp_norm": ones((L, d)),
            "router": router,
            "w_gate": dense((L, E, d, f), d),
            "w_up": dense((L, E, d, f), d),
            "w_down": dense((L, E, f, d), f),
        },
        "final_norm": ones((d,)),
        "lm_head": dense((d, v), d),
    }


def params_from_numpy(tree: Dict, config: MoEConfig, device="cuda") -> Dict:
    """Convert `jax.tree.map(np.asarray, moe.init_params(...))` of the JAX
    package into this port's params on `device`: config.dtype, the router
    kept in fp32."""
    dev = resolve_device(device)

    def conv(a, dtype=config.dtype):
        return to_torch(np.asarray(a)).to(device=dev, dtype=dtype)

    layers = {k: conv(tree["layers"][k]) for k in LAYER_KEYS
              if k != "router"}
    layers["router"] = conv(tree["layers"]["router"], torch.float32)
    return {"embed": conv(tree["embed"]), "layers": layers,
            "final_norm": conv(tree["final_norm"]),
            "lm_head": conv(tree["lm_head"])}


def param_logical_axes(config: Optional[MoEConfig] = None) -> Dict:
    axes = llama.param_logical_axes()
    axes["layers"].update({
        # Router is tiny; replicate so every shard routes locally.
        "router": ("layers", "embed", None),
        "w_gate": ("layers", "expert", "embed", "mlp"),
        "w_up": ("layers", "expert", "embed", "mlp"),
        "w_down": ("layers", "expert", "mlp", "embed"),
    })
    return axes


# ---------------------------------------------------------------- MoE block

def _route(config: MoEConfig, logits: torch.Tensor):
    """(probs, renormalised top-k gates, expert ids) of router logits."""
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, config.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def dispatch_masks(config: MoEConfig, expert_idx: torch.Tensor,
                   gate_vals: torch.Tensor, seq: int):
    """The static-capacity masks of the JAX package's moe_block, for this
    rank's (b, s_local, k) routes of a `seq`-token sequence:
    dispatch[b, s, e, c] = 1 iff token s goes to expert e at slot c, and
    combine[b, s, e, c] its gate there (both fp32). A route's slot is its
    place in its expert's queue, choice-rank-major; a route past the
    capacity C, and the one_hot of a slot of -1 or >= C, is zero."""
    b, s, k = expert_idx.shape
    E, C = config.n_experts, config.capacity(seq)
    sel = F.one_hot(expert_idx, E).float()               # (b, s, k, E)
    by_rank = sel.transpose(1, 2)                        # (b, k, s, E)
    counts = by_rank.sum(2)                              # (b, k, E)
    mesh, seq_axes = current_mesh(), axes_of("seq")
    before = torch.zeros_like(counts)
    if col.axes_size(mesh, seq_axes) > 1:
        # Routes of earlier sequence shards queue first within a choice
        # rank: gather every shard's counts.
        shards = col.gather_global(counts[None], mesh, 0, seq_axes)
        before = shards[:col.linear_index(mesh, seq_axes)].sum(0)
        counts = shards.sum(0)
    lower = torch.cumsum(counts, dim=1) - counts         # ranks < k, all s
    pos = (torch.cumsum(by_rank, dim=2) + (before + lower)[:, :, None]
           - 1.0).transpose(1, 2)                        # (b, s, k, E)
    sel = sel * (pos < C)
    slot = (pos[..., None] == torch.arange(C, device=pos.device)).float()
    masked_slot = slot * sel[..., None]                  # (b, s, k, E, C)
    dispatch = masked_slot.sum(dim=2)
    combine = torch.einsum("bsk,bskec->bsec", gate_vals, masked_slot)
    return dispatch, combine


def moe_block(config: MoEConfig, x: torch.Tensor, router: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Top-k routed expert FFN with static capacity.

    x: (b, s, d); router: (d, E); w_gate/w_up: (E, d, f); w_down: (E, f, d)
    (under a mesh: this rank's experts and mlp columns). Returns (out
    (b, s, d), aux losses dict of the global batch)."""
    mesh = current_mesh()
    b, s, _ = x.shape
    E, k = config.n_experts, config.top_k
    seq = s * col.axes_size(mesh, axes_of("seq"))
    expert_axes, mlp = col.live_axes(mesh, axes_of("expert")), axes_of("mlp")
    if len(expert_axes) > 1 or not set(expert_axes) <= set(axes_of("batch")):
        raise ValueError(f"expert axes {expert_axes} must be one axis of the "
                         f"batch's {axes_of('batch')}")

    logits = x.float() @ router                          # (b, s, E)
    probs, gate_vals, expert_idx = _route(config, logits)
    dispatch, combine = dispatch_masks(
        config, expert_idx, col.copy_to(gate_vals, mesh, mlp), seq)
    xin = torch.einsum("bsec,bsd->ebcd", dispatch,
                       col.copy_to(x, mesh, mlp).float()).to(config.dtype)
    for a in expert_axes:   # (E, b, C, d) -> (E/ep, b*ep, C, d)
        xin = col.all_to_all(xin, mesh, a, split_dim=0, concat_dim=1)
    h = swiglu(torch.einsum("ebcd,edf->ebcf", xin, w_gate),
               torch.einsum("ebcd,edf->ebcf", xin, w_up))
    out_e = torch.einsum("ebcf,efd->ebcd", h, w_down)
    for a in expert_axes:   # back to (E, b, C, d)
        out_e = col.all_to_all(out_e, mesh, a, split_dim=1, concat_dim=0)
    out = torch.einsum("bsec,ebcd->bsd", combine, out_e.float()).to(x.dtype)
    out = col.reduce_from(out, mesh, mlp)

    # Switch-transformer load-balancing loss: E * sum_e f_e * P_e, with f_e
    # the fraction of (token, choice) pairs routed to e and P_e the mean
    # router probability, both over the global batch.
    data = llama.data_axes()
    n = b * s * col.axes_size(mesh, data)
    f_e = col.all_reduce(F.one_hot(expert_idx, E).float().sum((0, 1, 2)),
                         mesh, data) / (n * k)
    p_e = col.reduce_from(probs.sum((0, 1)), mesh, data) / n
    z = col.reduce_from((torch.logsumexp(logits, dim=-1) ** 2).sum(), mesh,
                        data) / n
    routed = col.all_reduce(dispatch.sum(), mesh, data)
    aux = {"balance_loss": E * torch.sum(f_e * p_e), "router_z_loss": z,
           "dropped_frac": 1.0 - routed / (n * k)}
    return out, aux


# ---------------------------------------------------------------- forward

_LAYER_AXES = llama.per_layer_axes(param_logical_axes())
# Expert weights keep their ep (and tp on mlp) sharding and gather only
# the fsdp (embed) factor.
_EXTRA_GATHER_AXES = {
    "router": (None, None),
    "w_gate": ("expert", None, "mlp"),
    "w_up": ("expert", None, "mlp"),
    "w_down": ("expert", "mlp", None),
}


def _layer(config: MoEConfig, x, p, cos, sin):
    p = llama.gather_layer_params(p, _LAYER_AXES, _EXTRA_GATHER_AXES)
    x = llama.attention_sublayer(config, x, p, cos, sin)
    h = rms_norm(x, p["mlp_norm"], config.norm_eps)
    out, aux = moe_block(config, h, p["router"], p["w_gate"], p["w_up"],
                         p["w_down"])
    return x + out, aux


def forward(params: Dict, tokens: torch.Tensor,
            config: MoEConfig) -> Tuple[torch.Tensor, Dict]:
    """tokens: (b, s) int -> (logits (b, s, vocab) fp32, aux losses as the
    mean over layers). Each layer is fully checkpointed when config.remat
    is set and grad is enabled (the JAX package's nothing_saveable)."""
    cos, sin = llama.rope_tables(config, tokens.shape[1],
                                 params["embed"].device)
    x = llama.embed(params["embed"], tokens, config)
    layer = llama.layer_fn(partial(_layer, config), config.remat)
    stacked = {k: params["layers"][k].unbind(0) for k in LAYER_KEYS}
    auxes = []
    for li in range(config.n_layers):
        x, aux = layer(x, {k: stacked[k][li] for k in LAYER_KEYS}, cos, sin)
        auxes.append(aux)
    aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return llama.logits_of(x, params["lm_head"]), aux


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
            config: MoEConfig) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE + balance/z aux losses. batch: {"tokens": (b, s+1)}
    (under a mesh: this rank's batch shard, the whole sequence)."""
    inputs, targets, mask = llama.shift_tokens(batch,
                                               params["embed"].device)
    logits, aux = forward(params, inputs, config)
    ce = llama.next_token_ce(logits, targets, mask)
    loss = (ce + config.balance_loss_coef * aux["balance_loss"]
            + config.z_loss_coef * aux["router_z_loss"])
    metrics = {"loss": ce, "total_loss": loss,
               "tokens": llama.token_count(targets), **aux}
    return loss, metrics
