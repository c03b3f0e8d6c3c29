"""Multi-LoRA serving: batched low-rank adapters over the paged engine.

Port of ray_tpu/llm/lora.py. Adapters live in slot stacks on the runner's
device, one user adapter per slot; slot 0 is the zero adapter (the base
model). Every sequence of a batch carries a slot index, and each target
projection adds

    delta[t] = (x[t] @ A[l, slot(t)]) @ B[l, slot(t)]      (B holds alpha/rank)

Two forms compute it:

  * `apply_lora`, the plain version: JAX's gathered form. It gathers A and
    B per sequence, so its traffic grows with the batch.
  * The runner's form (`ModelRunner._project`): one product against every
    slot's A at once ((d_in, n_slots * rank)), every column block but the
    row's own slot zeroed (`slot_mask`), then one product with every
    slot's B ((n_slots * rank, d_out)). The zeroed columns add exact
    zeros, so it equals the gathered form up to the order of
    accumulation, and what it reads does not depend on the batch.

The manager stores A of the targets that share an input side by side:
wq, wk and wv read the attention norm's output, w_gate and w_up the MLP
norm's, so one product serves each group. `slot_stacks` gives every
target's stacks in JAX's layout, (L, n_slots, d_in, r) and
(L, n_slots, r, d_out), as views of the same storage.

A captured CUDA graph holds the stacks' addresses: `load_adapter` writes a
slot in place and never rebinds a stack; only `resize` reallocates, and it
bumps `epoch`, which the runner's graph key reads.

Under tensor parallelism (`tp=(rank, size)`) each rank's stacks hold its
part of every adapter, as its weights are split: a column-parallel target
(wq, wk, wv, w_gate, w_up) keeps A whole and takes its rank's columns of
B; a row-parallel one (wo, w_down) takes its rank's rows of A and keeps B
whole, so its delta is a partial sum that the row product's all-reduce
adds up with no collective of its own. The slot table lives on rank 0:
there `fanout` sends each slot write and reallocation to the other ranks,
which hold the stacks only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import resolve_device

# Projections that may carry adapters, with (in, out) dims per config.
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# Targets that read the same input, in TARGETS order: one A product each.
INPUT_GROUPS = (("wq", "wk", "wv"), ("wo",), ("w_gate", "w_up"),
                ("w_down",))


# Row-parallel targets under tensor parallelism (their input is split).
ROW_TARGETS = ("wo", "w_down")


def target_dims(config, tp: int = 1) -> Dict[str, Tuple[int, int]]:
    """(d_in, d_out) per target on one rank of `tp`: the split dim (the
    output of a column-parallel target, the input of a row-parallel one)
    divided by tp."""
    d, f, hd = config.d_model, config.d_ff, config.head_dim
    q, kv = config.n_heads * hd // tp, config.n_kv_heads * hd // tp
    return {
        "wq": (d, q),
        "wk": (d, kv),
        "wv": (d, kv),
        "wo": (q, d),
        "w_gate": (d, f // tp),
        "w_up": (d, f // tp),
        "w_down": (f // tp, d),
    }


@dataclasses.dataclass
class LoRAAdapter:
    """One adapter: per-target stacked factors over layers.

    weights[target] = (A, B) with A: (n_layers, d_in, rank),
    B: (n_layers, rank, d_out), numpy fp32 (a JAX `init_adapter` result
    carries over as it is). Missing targets mean identity."""

    name: str
    rank: int
    alpha: float
    weights: Dict[str, Tuple[np.ndarray, np.ndarray]]

    @property
    def scaling(self) -> float:
        return self.alpha / max(self.rank, 1)


def init_adapter(config, name: str, rank: int = 8, alpha: float = 16.0,
                 targets: Sequence[str] = ("wq", "wv"),
                 generator: Optional[torch.Generator] = None,
                 scale: float = 0.1) -> LoRAAdapter:
    """Random A, random-small B (standard LoRA init uses zero B; a nonzero
    scale makes adapters change the logits measurably). Drawn in fp32 on
    the CPU from `generator` (default: seeded from the name's crc32)."""
    if generator is None:
        import zlib

        generator = torch.Generator().manual_seed(zlib.crc32(name.encode()))
    dims = target_dims(config)
    weights = {}
    for t in targets:
        d_in, d_out = dims[t]
        a = torch.randn((config.n_layers, d_in, rank), generator=generator,
                        dtype=torch.float32) / math.sqrt(d_in)
        b = torch.randn((config.n_layers, rank, d_out), generator=generator,
                        dtype=torch.float32) / math.sqrt(rank) * scale
        weights[t] = (a.numpy(), b.numpy())
    return LoRAAdapter(name, rank, alpha, weights)


class LoRAManager:
    """Owns the slot stacks on the device and the name -> slot LRU table.

    Slot 0 is permanently the zero adapter (base model); user adapters
    occupy slots 1..n_slots-1. All adapters in one manager share `rank`
    (smaller ranks are zero-padded when loading)."""

    def __init__(self, config, n_slots: int = 8, rank: int = 8,
                 targets: Sequence[str] = TARGETS, dtype=None,
                 device="cuda", tp: Tuple[int, int] = (0, 1)):
        self.config = config
        self.tp = tuple(tp)
        # Rank 0 of a tensor-parallel world: fanout(path, *args) runs
        # `self.<path>(*args)` on the other ranks (set by the runner).
        self.fanout = None
        self.n_slots = n_slots + 1          # +1 for the base slot
        self.rank = rank
        self.targets = tuple(t for t in TARGETS if t in targets)
        self.dtype = dtype or config.dtype
        self.device = resolve_device(device)
        # Bumped by every reallocation (resize): the runner recaptures its
        # graphs when it changes.
        self.epoch = 0
        self._alloc(self.n_slots)
        self._slots: Dict[str, int] = {}
        self._scaling: Dict[int, float] = {}
        self._tick = 0
        self._last_used: Dict[int, int] = {}
        # slot -> count of queued/in-flight requests using it: a pinned
        # slot must never be evicted (an LRU reuse would silently switch
        # a running sequence's adapter mid-generation).
        self._pins: Dict[int, int] = {}
        # Pool-scaling telemetry (engine stats() -> LoRAPoolPolicy): loads
        # count every load_adapter install; evictions only the LRU subset.
        self.loads = 0
        self.evictions = 0
        # Called with the slot after every load_adapter: KV cached under a
        # slot was computed with the adapter that held it, so an engine
        # drops that slot's cached prefixes when its weights change.
        self.listeners: List = []

    # ---- storage ---------------------------------------------------------

    def _alloc(self, n_slots: int) -> None:
        """Fresh zero stacks for n_slots slots: per input group one A
        (L, d_in, G * n_slots * r) holding its G targets side by side; per
        target one B (L, n_slots * r, d_out)."""
        dims = target_dims(self.config, self.tp[1])
        L, N = self.config.n_layers, n_slots * self.rank
        self.groups: List[Tuple[str, ...]] = []
        self.a_group: Dict[Tuple[str, ...], torch.Tensor] = {}
        self.b: Dict[str, torch.Tensor] = {}
        for group in INPUT_GROUPS:
            group = tuple(t for t in group if t in self.targets)
            if not group:
                continue
            self.groups.append(group)
            d_in = dims[group[0]][0]
            self.a_group[group] = torch.zeros(
                (L, d_in, len(group) * N), dtype=self.dtype,
                device=self.device)
            for t in group:
                self.b[t] = torch.zeros((L, N, dims[t][1]),
                                        dtype=self.dtype, device=self.device)

    def a_all(self, target: str) -> torch.Tensor:
        """Every slot's A of `target`: a (L, d_in, n_slots * r) view."""
        for group in self.groups:
            if target in group:
                N = self.n_slots * self.rank
                g = group.index(target)
                return self.a_group[group][:, :, g * N:(g + 1) * N]
        raise KeyError(target)

    def slot_stacks(self, target: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """`target`'s stacks in JAX's layout, views of the device storage:
        A (L, n_slots, d_in, r), B (L, n_slots, r, d_out)."""
        a = self.a_all(target)
        L, d_in, _ = a.shape
        b = self.b[target]
        return (a.unflatten(2, (self.n_slots, self.rank)).permute(0, 2, 1, 3),
                b.view(L, self.n_slots, self.rank, b.shape[-1]))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in list(self.a_group.values())
                   + list(self.b.values()))

    # ---- the slot table --------------------------------------------------

    def slot_of(self, name: Optional[str]) -> int:
        if not name:
            return 0
        if name not in self._slots:
            raise KeyError(f"LoRA adapter {name!r} not loaded")
        slot = self._slots[name]
        self._tick += 1
        self._last_used[slot] = self._tick
        return slot

    def pin(self, slot: int):
        """Mark a slot as referenced by a queued/running request."""
        if slot:
            self._pins[slot] = self._pins.get(slot, 0) + 1

    def unpin(self, slot: int):
        if not slot:
            return
        n = self._pins.get(slot, 0) - 1
        if n > 0:
            self._pins[slot] = n
        else:
            self._pins.pop(slot, None)

    @property
    def loaded(self) -> List[str]:
        return sorted(self._slots)

    def name_of(self, slot: int) -> Optional[str]:
        """Inverse of slot_of: the adapter currently holding `slot` (""
        for the base slot, None for an empty/unknown slot). The prefix
        store keys spilled KV by adapter NAME, not slot: slots are
        recycled across loads, names are identity."""
        if slot == 0:
            return ""
        for name, s in self._slots.items():
            if s == slot:
                return name
        return None

    def load_adapter(self, adapter: LoRAAdapter) -> int:
        """Install (or refresh) an adapter; returns its slot. Evicts the
        LRU adapter when all user slots are taken. Writes the slot's
        columns in place on the current stream, so a graph replayed after
        it reads the new values with no recapture."""
        if adapter.rank > self.rank:
            raise ValueError(
                f"adapter rank {adapter.rank} > manager rank {self.rank}")
        if adapter.name in self._slots:
            slot = self._slots[adapter.name]
            if self._pins.get(slot):
                # Refreshing a live slot would switch a running sequence's
                # adapter weights mid-generation.
                raise RuntimeError(
                    f"LoRA adapter {adapter.name!r} is referenced by "
                    "in-flight requests; retry the refresh once they drain")
        elif len(self._slots) < self.n_slots - 1:
            used = set(self._slots.values())
            slot = next(s for s in range(1, self.n_slots) if s not in used)
        else:
            evictable = [s for s in self._slots.values()
                         if not self._pins.get(s)]
            if not evictable:
                raise RuntimeError(
                    "all LoRA slots are referenced by in-flight requests; "
                    "cannot load a new adapter (raise n_slots)")
            slot = min(evictable, key=lambda s: self._last_used.get(s, 0))
            evicted = next(n for n, s in self._slots.items() if s == slot)
            del self._slots[evicted]
            self.evictions += 1
        self.loads += 1
        self._slots[adapter.name] = slot
        self._tick += 1
        self._last_used[slot] = self._tick
        self._scaling[slot] = adapter.scaling
        if self.fanout is not None:
            self.fanout("lora._write_slot", slot, adapter)
        self._write_slot(slot, adapter)
        for fn in self.listeners:
            fn(slot)
        return slot

    def _write_slot(self, slot: int, adapter: LoRAAdapter) -> None:
        """Write `adapter`'s factors (this rank's part of them) into
        `slot`'s columns, zero-padded to the manager's rank."""
        L, r = self.config.n_layers, self.rank
        rank, size = self.tp
        cols = slice(slot * r, (slot + 1) * r)
        for t in self.targets:
            a_dst, b_dst = self.a_all(t)[:, :, cols], self.b[t][:, cols, :]
            a_pad = torch.zeros((L, a_dst.shape[1], r), dtype=torch.float32)
            b_pad = torch.zeros((L, r, b_dst.shape[2]), dtype=torch.float32)
            if t in adapter.weights:
                a, b = adapter.weights[t]
                n = a.shape[-1]
                a = np.asarray(a, dtype=np.float32)
                # alpha/rank folds into B: the product needs no per-slot
                # scale.
                b = np.asarray(b, dtype=np.float32) * adapter.scaling
                if t in ROW_TARGETS:
                    d = a_dst.shape[1]
                    a = a[:, rank * d:(rank + 1) * d]
                else:
                    d = b_dst.shape[2]
                    b = b[:, :, rank * d:(rank + 1) * d]
                a_pad[:, :, :n] = torch.from_numpy(np.array(a))
                b_pad[:, :n, :] = torch.from_numpy(np.array(b))
            a_dst.copy_(a_pad.to(self.dtype))
            b_dst.copy_(b_pad.to(self.dtype))

    def resize(self, n_slots: int) -> int:
        """Grow/shrink the user-slot pool (LoRAPoolPolicy's actuator),
        reallocating the stacks and keeping every occupied slot's columns.
        Shrinks clamp to the highest loaded or pinned slot index. Returns
        the new user-slot count. The stacks are new tensors: `epoch` moves
        on, and the runner recaptures its graphs on its next step."""
        floor = max([0] + list(self._slots.values())
                    + [s for s, n in self._pins.items() if n])
        new = max(int(n_slots), floor, 1)
        total = new + 1
        if total == self.n_slots:
            return new
        if self.fanout is not None:
            self.fanout("lora._realloc", total)
        self._realloc(total)
        return new

    def _realloc(self, total: int) -> None:
        """New stacks of `total` slots keeping the first min(old, new)
        slots' columns; the epoch moves on."""
        keep = min(self.n_slots, total)
        old = {t: self.slot_stacks(t) for t in self.targets}
        self._alloc(total)
        self.n_slots = total
        for t in self.targets:
            a_new, b_new = self.slot_stacks(t)
            a_new[:, :keep].copy_(old[t][0][:, :keep])
            b_new[:, :keep].copy_(old[t][1][:, :keep])
        self.epoch += 1


@dataclasses.dataclass
class LoRAPoolPolicyConfig:
    """Watermarks for adapter-pool scaling."""

    min_slots: int = 1
    max_slots: int = 32
    high_occupancy: float = 0.9   # loaded/slots at or above -> grow
    low_occupancy: float = 0.5    # at or below (sustained) -> shrink
    grow_factor: float = 1.5
    cooldown_s: float = 10.0      # min seconds between resizes
    quiet_s: float = 30.0         # sustained low occupancy before a shrink


class LoRAPoolPolicy:
    """Adapter-pool scaling off the engine's stats(): the actuator is
    LoRAManager.resize. Pure and clock-driven: feed it stats dicts and
    `now`, it answers a desired slot count or None.

    Grow on pressure: occupancy at the high watermark, or any LRU eviction
    since the last tick. Shrink only after a sustained quiet window, never
    below what is loaded/pinned."""

    def __init__(self, config: Optional[LoRAPoolPolicyConfig] = None):
        self.config = config or LoRAPoolPolicyConfig()
        self._last_resize = 0.0
        self._quiet_since: Optional[float] = None
        self._last_evictions = 0

    def desired(self, stats: dict, now: float) -> Optional[int]:
        cfg = self.config
        slots = int(stats.get("lora_slots", 0))
        if slots <= 0:
            return None
        loaded = int(stats.get("lora_loaded", 0))
        evictions = int(stats.get("lora_evictions", 0))
        evicting = evictions > self._last_evictions
        self._last_evictions = evictions
        occupancy = loaded / slots
        if now - self._last_resize < cfg.cooldown_s:
            return None
        if ((evicting or occupancy >= cfg.high_occupancy)
                and slots < cfg.max_slots):
            self._quiet_since = None
            self._last_resize = now
            return min(cfg.max_slots,
                       max(slots + 1, int(slots * cfg.grow_factor)))
        if occupancy <= cfg.low_occupancy and slots > cfg.min_slots:
            if self._quiet_since is None:
                self._quiet_since = now
            elif now - self._quiet_since >= cfg.quiet_s:
                self._quiet_since = None
                self._last_resize = now
                return max(cfg.min_slots, loaded, slots // 2, 1)
        else:
            self._quiet_since = None
        return None


def apply_lora(x: torch.Tensor, lA: torch.Tensor, lB: torch.Tensor,
               lora_idx: torch.Tensor) -> torch.Tensor:
    """Plain version, JAX's gathered form: the delta of one layer's one
    target. x: (S, Bq, d_in); lA: (n_slots, d_in, r); lB: (n_slots, r,
    d_out); lora_idx: (S,) slot per sequence. Returns (S, Bq, d_out)."""
    idx = lora_idx.long()
    mid = torch.einsum("sbd,sdr->sbr", x, lA[idx])
    return torch.einsum("sbr,sro->sbo", mid, lB[idx])


def slot_mask(tok_slots: torch.Tensor, n_slots: int, rank: int,
              dtype) -> torch.Tensor:
    """(T,) slot per row -> (T, n_slots * rank): 1 on the row's own slot's
    columns, 0 elsewhere."""
    col_slot = torch.arange(n_slots * rank,
                            device=tok_slots.device) // rank
    return (col_slot[None, :] == tok_slots.long()[:, None]).to(dtype)
