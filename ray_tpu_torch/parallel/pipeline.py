"""Pipeline parallelism in one process: layer-partitioned stages on the
cards of one process and the 1F1B microbatch schedules (port of the JAX
package's parallel/pipeline.py, its in-process half).

Stages are separate programs on separate devices of one process
(`LocalPipeline`); a device may hold several stages (a repeated entry in
`devices`). Activations and their gradients move between cards with
`.to(device)`. Every op is issued from one host thread: the cards overlap
only while the host never waits on them, so nothing inside a step reads a
value back (the losses stay device tensors until the step ends).

Memory model: full activation recomputation. `fwd` runs without an
autograd graph; `bwd` re-runs the stage forward from the saved stage
INPUT with grad enabled, so live memory per stage is bounded by the 1F1B
in-flight microbatch count, independent of model depth.

The actor half (`build_stage_plans`, `PipelineStageActor`,
`ActorPipeline`) needs the runtime and is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import resolve_device
from ray_tpu_torch.ops.layers import rms_norm
from ray_tpu_torch.train.optim import AdamW, leaves
from ray_tpu_torch.util.tracing import profile_range


# ------------------------------------------------------------- partitioning

def stage_layer_ranges(n_layers: int, n_stages: int) -> List[Tuple[int, int]]:
    """Split layers into contiguous per-stage ranges (balanced, remainder to
    the earlier stages which also don't carry the lm_head)."""
    base, extra = divmod(n_layers, n_stages)
    ranges, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        ranges.append((start, start + size))
        start += size
    return ranges


def split_params(params: Dict, n_stages: int) -> List[Dict]:
    """Slice a stacked-layer Llama param dict into per-stage dicts (views of
    `params`). Stage 0 holds the embedding; the last stage holds final_norm
    + lm_head."""
    n_layers = next(iter(params["layers"].values())).shape[0]
    stages = []
    for s, (lo, hi) in enumerate(stage_layer_ranges(n_layers, n_stages)):
        st: Dict = {"layers": {k: v[lo:hi]
                               for k, v in params["layers"].items()}}
        if s == 0:
            st["embed"] = params["embed"]
        if s == n_stages - 1:
            st["final_norm"] = params["final_norm"]
            st["lm_head"] = params["lm_head"]
        stages.append(st)
    return stages


def merge_params(stage_params: List[Dict], device=None) -> Dict:
    """Inverse of split_params: new tensors on `device` (default: stage
    0's)."""
    dev = stage_params[0]["embed"].device if device is None else device
    return {"embed": stage_params[0]["embed"].to(dev, copy=True),
            "layers": {k: torch.cat([st["layers"][k].to(dev)
                                     for st in stage_params])
                       for k in stage_params[0]["layers"]},
            "final_norm": stage_params[-1]["final_norm"].to(dev, copy=True),
            "lm_head": stage_params[-1]["lm_head"].to(dev, copy=True)}


# ------------------------------------------------------------ stage programs

def stage_apply(stage_params: Dict, x: torch.Tensor, config, *,
                is_first: bool, is_last: bool) -> torch.Tensor:
    """One stage's forward: tokens -> hidden (first), hidden -> hidden
    (middle), hidden -> fp32 logits (last). Under `config.remat` each layer
    is checkpointed with nothing saved, whatever `remat_policy` says (the
    JAX package's stage program does the same)."""
    layers = stage_params["layers"]
    device = layers["wq"].device
    if is_first:
        x = llama.embed(stage_params["embed"], x, config)
    cos, sin = llama.rope_tables(config, x.shape[1], device)
    layer = llama.layer_fn(partial(llama._layer, config), config.remat)
    stacked = {k: layers[k].unbind(0) for k in llama.LAYER_KEYS}
    for li in range(layers["wq"].shape[0]):
        x = layer(x, {k: stacked[k][li] for k in llama.LAYER_KEYS}, cos, sin)
    if is_last:
        with profile_range("norm"):
            x = rms_norm(x, stage_params["final_norm"], config.norm_eps)
        with profile_range("loss"):
            x = llama.logits_of(x, stage_params["lm_head"])
    return x


def last_stage_loss(stage_params: Dict, x, targets, config,
                    is_first: bool = False) -> torch.Tensor:
    logits = stage_apply(stage_params, x, config, is_first=is_first,
                         is_last=True)
    with profile_range("loss"):
        return llama.next_token_ce(logits, targets)


def _tree_like(tree: Dict, flat: Sequence[torch.Tensor]) -> Dict:
    """`flat` (in `leaves(tree)` order) as a dict of tree's structure."""
    it = iter(flat)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}
    return build(tree)


def _vjp(stage_fn, p: Dict, x: torch.Tensor, is_first: bool):
    """Run stage_fn(p, x) with grad enabled from a detached alias of the
    saved input; returns (out, the tensors to differentiate: p's leaves,
    then the input unless it is token ids)."""
    xs = x.detach()
    if not is_first:
        xs.requires_grad_(True)
    with torch.enable_grad():
        out = stage_fn(p, xs)
    wrt = [t for _, t in leaves(p)] + ([] if is_first else [xs])
    return out, wrt


def build_chunk_programs(config, chunk_ids, n_virtual: int):
    """Per-chunk programs: fwd[c] (None for the last chunk: its loss and
    gradients come from bwd[c]) and bwd[c].

    fwd[c](p, x) -> activations, under torch.no_grad. bwd[c](p, x, g) ->
    (dp, dx): the gradients of the stage forward re-run from x, pulled back
    from the output cotangent g (jax.vjp's pair); the last chunk's
    bwd[c](p, x, targets) -> (loss, (dp, dx)). dp has p's structure (zeros
    for the layers of a chunk that holds none); dx is None for chunk 0,
    whose input is token ids."""
    fwd: Dict[int, Optional[object]] = {}
    bwd: Dict[int, object] = {}
    for c in chunk_ids:
        is_first, is_last = c == 0, c == n_virtual - 1
        if is_last:
            def loss_grad(p, x, t, _first=is_first):
                loss, wrt = _vjp(lambda pp, xx: last_stage_loss(
                    pp, xx, t, config, is_first=_first), p, x, _first)
                grads = torch.autograd.grad(loss, wrt,
                                            materialize_grads=True)
                return loss.detach(), _split_grads(p, grads, _first)

            fwd[c] = None
            bwd[c] = loss_grad
        else:
            f = partial(stage_apply, config=config, is_first=is_first,
                        is_last=False)

            def forward(p, x, _f=f):
                with torch.no_grad():
                    return _f(p, x)

            def pullback(p, x, g, _f=f, _first=is_first):
                out, wrt = _vjp(_f, p, x, _first)
                grads = torch.autograd.grad(out, wrt, grad_outputs=g,
                                            materialize_grads=True)
                return _split_grads(p, grads, _first)

            fwd[c] = forward
            bwd[c] = pullback
    return fwd, bwd


def _split_grads(p, grads, is_first):
    n = len(grads) - (0 if is_first else 1)
    return _tree_like(p, grads[:n]), (None if is_first else grads[n])


# --------------------------------------------------------------- schedule

@dataclasses.dataclass(frozen=True)
class PipeOp:
    kind: str        # "fwd" | "bwd"
    stage: int
    microbatch: int


def one_f_one_b(n_stages: int, n_microbatches: int) -> List[List[PipeOp]]:
    """Per-stage 1F1B op sequences. Stage s runs (n_stages - s) warmup
    forwards, then alternates 1F1B, then drains backwards."""
    if n_microbatches < n_stages:
        raise ValueError("1F1B needs at least n_stages microbatches")
    per_stage: List[List[PipeOp]] = []
    for s in range(n_stages):
        ops: List[PipeOp] = []
        f = b = 0
        for _ in range(min(n_stages - s, n_microbatches)):
            ops.append(PipeOp("fwd", s, f))
            f += 1
        while f < n_microbatches:
            ops.append(PipeOp("bwd", s, b))
            b += 1
            ops.append(PipeOp("fwd", s, f))
            f += 1
        while b < n_microbatches:
            ops.append(PipeOp("bwd", s, b))
            b += 1
        per_stage.append(ops)
    return per_stage


def virtual_stage_schedule(n_devices: int, v: int,
                           n_microbatches: int) -> List[List[PipeOp]]:
    """Per-DEVICE op sequences for a VIRTUAL-stage pipeline: the model is
    cut into n_devices*v chunks; device d hosts chunks d, d+n_devices, ...
    (round-robin, the Megatron virtual-pipeline placement). The op order is
    depth-(n_devices*v) 1F1B restricted to each device, the simple baseline
    that megatron_interleaved_schedule improves on. PipeOp.stage is the
    VIRTUAL stage (chunk) id; device = stage % n_devices."""
    per_device: List[List[PipeOp]] = [[] for _ in range(n_devices)]
    for op in global_order(n_devices * v, n_microbatches):
        per_device[op.stage % n_devices].append(op)
    return per_device


def megatron_interleaved_schedule(n_devices: int, v: int,
                                  n_microbatches: int) -> List[List[PipeOp]]:
    """Per-DEVICE op sequences for the Megatron interleaved 1F1B schedule
    (Narayanan et al. 2021): chunks placed as in virtual_stage_schedule,
    but the op ORDER cycles microbatch groups of size n_devices through the
    v local chunks: warmup of (p-d-1)*2 + (v-1)*p forwards, then fwd/bwd
    steady state, then drain. Deadlock-free under blocking in-order
    per-device execution, complete, and a bubble of 2*(p-1)/v ticks against
    2*(p*v-1) for the plain virtual order. Requires m % p == 0."""
    p, total = n_devices, n_microbatches * v
    if n_microbatches % p:
        raise ValueError(
            "interleaved schedule needs n_microbatches % n_devices == 0")

    def chunk_of(op_id: int, forward: bool) -> int:
        c = (op_id % (p * v)) // p
        return c if forward else (v - 1 - c)

    def mb_of(op_id: int) -> int:
        return (op_id // (p * v)) * p + op_id % p

    out: List[List[PipeOp]] = []
    for d in range(p):
        ops: List[PipeOp] = []
        warmup = min((p - d - 1) * 2 + (v - 1) * p, total)
        f = b = 0
        for _ in range(warmup):
            ops.append(PipeOp("fwd", chunk_of(f, True) * p + d, mb_of(f)))
            f += 1
        while f < total:
            ops.append(PipeOp("fwd", chunk_of(f, True) * p + d, mb_of(f)))
            f += 1
            ops.append(PipeOp("bwd", chunk_of(b, False) * p + d, mb_of(b)))
            b += 1
        while b < total:
            ops.append(PipeOp("bwd", chunk_of(b, False) * p + d, mb_of(b)))
            b += 1
        out.append(ops)
    return out


def linearize(per_queue: List[List[PipeOp]], n_virtual: int) -> List[PipeOp]:
    """Merge per-queue op sequences into one dependency-valid global order,
    preserving each queue's internal order (queues = stages or devices).
    fwd(s, m) needs fwd(s-1, m); bwd(s, m) needs fwd(s, m) and
    bwd(s+1, m). Raises when the sequences deadlock."""
    cursors = [0] * len(per_queue)
    done = set()
    order: List[PipeOp] = []
    total = sum(len(ops) for ops in per_queue)
    while len(order) < total:
        progressed = False
        for q in range(len(per_queue)):
            while cursors[q] < len(per_queue[q]):
                op = per_queue[q][cursors[q]]
                if op.kind == "fwd":
                    ready = (op.stage == 0
                             or ("fwd", op.stage - 1, op.microbatch) in done)
                else:
                    ready = (("fwd", op.stage, op.microbatch) in done
                             and (op.stage == n_virtual - 1
                                  or ("bwd", op.stage + 1,
                                      op.microbatch) in done))
                if not ready:
                    break
                done.add((op.kind, op.stage, op.microbatch))
                order.append(op)
                cursors[q] += 1
                progressed = True
        if not progressed:
            raise RuntimeError("pipeline schedule deadlocked")
    return order


def global_order(n_stages: int, n_microbatches: int) -> List[PipeOp]:
    """A single sequential order respecting all inter-stage dependencies:
    fwd(s, m) after fwd(s-1, m); bwd(s, m) after bwd(s+1, m) and fwd(s, m)."""
    return linearize(one_f_one_b(n_stages, n_microbatches), n_stages)


def submission_order(n_devices: int, interleave: int,
                     n_microbatches: int) -> List[PipeOp]:
    """The dependency-valid GLOBAL linearization whose per-device
    subsequence is the production schedule: plain 1F1B without
    interleaving, Megatron interleaved steady state with it."""
    if interleave <= 1:
        return global_order(n_devices, n_microbatches)
    if n_microbatches % n_devices != 0:
        # Megatron's interleaved order needs m % p == 0; other microbatch
        # counts (legal for the plain order: only m >= p*v) fall back to
        # depth-p*v 1F1B rather than rejecting the step.
        return global_order(n_devices * interleave, n_microbatches)
    per_device = megatron_interleaved_schedule(
        n_devices, interleave, n_microbatches)
    return linearize(per_device, n_devices * interleave)


# ---------------------------------------------------------- local pipeline

def _default_devices(n_stages: int) -> List[torch.device]:
    devices = [resolve_device(f"cuda:{i}") for i in range(n_stages)]
    if torch.cuda.device_count() < n_stages:
        raise ValueError(f"{n_stages} stages need {n_stages} cards, the "
                         f"machine has {torch.cuda.device_count()}; pass "
                         "devices= to place several stages on one card")
    return devices


class LocalPipeline:
    """Stages on the cards of one process (or on the CPU, device="cpu"
    entries). `devices` defaults to cuda:0..n_stages-1; an explicit list
    may repeat a device, which then holds several stages."""

    def __init__(self, config, params: Dict, n_stages: int,
                 optimizer: AdamW, devices: Optional[Sequence] = None,
                 interleave: int = 1):
        """`interleave=v` enables virtual-stage partitioning: layers split
        into n_stages*v chunks, chunk c on device c % n_stages. train_step
        then needs n_microbatches >= n_stages * v. The stages hold copies
        of `params`, which the steps update in place."""
        self.config = config
        self.n_stages = n_stages
        self.n_virtual = n_stages * max(1, interleave)
        self.optimizer = optimizer
        devices = (_default_devices(n_stages) if devices is None
                   else [resolve_device(d) for d in devices])
        if len(devices) < n_stages:
            raise ValueError(f"{n_stages} stages, {len(devices)} devices")
        self.devices = devices[:n_stages]
        # Device of each VIRTUAL stage (round-robin under interleaving).
        self.chunk_devices = [self.devices[c % n_stages]
                              for c in range(self.n_virtual)]
        self.stage_params = []
        for st, dev in zip(split_params(params, self.n_virtual),
                           self.chunk_devices):
            copy = _tree_like(st, [t.detach().to(dev, copy=True)
                                   .requires_grad_(True)
                                   for _, t in leaves(st)])
            self.stage_params.append(copy)
        self.opt_states = [optimizer.init(st) for st in self.stage_params]
        fwd, bwd = build_chunk_programs(config, range(self.n_virtual),
                                        self.n_virtual)
        self._fwd = [fwd[c] for c in range(self.n_virtual)]
        self._bwd = [bwd[c] for c in range(self.n_virtual)]
        # Bytes the last step moved between devices (activations forward,
        # their gradients backward, tokens and targets in).
        self.last_step_bytes = 0

    def _to(self, x: torch.Tensor, device) -> torch.Tensor:
        if x.device != device:
            self.last_step_bytes += x.numel() * x.element_size()
        return x.to(device)

    def train_step(self, tokens: torch.Tensor,
                   n_microbatches: int) -> Dict[str, float]:
        """One 1F1B training step. tokens: (batch, seq+1) int; batch must
        divide into n_microbatches. Returns {"loss": mean of the
        microbatch losses}."""
        B = tokens.shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} does not divide into "
                             f"{n_microbatches} microbatches")
        if n_microbatches < self.n_virtual:
            raise ValueError(
                f"1F1B over {self.n_virtual} virtual stages "
                f"({self.n_stages} devices x interleave "
                f"{self.n_virtual // self.n_stages}) needs n_microbatches "
                f">= {self.n_virtual}, got {n_microbatches}")
        mb = B // n_microbatches
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        saved_in: Dict[Tuple[int, int], torch.Tensor] = {}
        fwd_out: Dict[Tuple[int, int], torch.Tensor] = {}
        grads_in: Dict[Tuple[int, int], torch.Tensor] = {}
        stage_grads: List[Optional[List[torch.Tensor]]] = [None] * \
            self.n_virtual
        losses = []
        last = self.n_virtual - 1
        self.last_step_bytes = 0
        for op in submission_order(self.n_stages,
                                   self.n_virtual // self.n_stages,
                                   n_microbatches):
            s, m = op.stage, op.microbatch
            dev = self.chunk_devices[s]
            if op.kind == "fwd":
                if s == 0:
                    x = self._to(inputs[m * mb:(m + 1) * mb], dev)
                else:
                    x = self._to(fwd_out.pop((s - 1, m)), dev)
                saved_in[(s, m)] = x
                if s != last:
                    fwd_out[(s, m)] = self._fwd[s](self.stage_params[s], x)
                continue
            x = saved_in.pop((s, m))
            if s == last:
                t = self._to(targets[m * mb:(m + 1) * mb], dev)
                loss, (dp, dx) = self._bwd[s](self.stage_params[s], x, t)
                losses.append(loss)
            else:
                g = self._to(grads_in.pop((s, m)), dev)
                dp, dx = self._bwd[s](self.stage_params[s], x, g)
            if s > 0:
                grads_in[(s - 1, m)] = dx
            flat = [t for _, t in leaves(dp)]
            if stage_grads[s] is None:
                stage_grads[s] = flat
            else:
                torch._foreach_add_(stage_grads[s], flat)
        # Optimizer step per chunk (gradients averaged over microbatches).
        with profile_range("optimizer"):
            for s in range(self.n_virtual):
                torch._foreach_mul_(stage_grads[s], 1.0 / n_microbatches)
                self.optimizer.update(self.stage_params[s], stage_grads[s],
                                      self.opt_states[s])
        return {"loss": float(sum(float(l) for l in losses) / len(losses))}

    def merged_params(self, device=None) -> Dict:
        """The whole model's parameters (copies) on `device` (default: the
        first stage's)."""
        with torch.no_grad():
            return merge_params(self.stage_params, device)
