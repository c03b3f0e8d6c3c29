"""RLHF rollouts: seq-numbered experiences off the port's serving engine
(port of the JAX package's rlhf/rollout.py, its in-process half).

Rollouts run on `LLMEngine`: continuous batching, paged KV, and the
prefix cache warm across the shared system prompt. Every prompt gets a
monotonic sequence number at admission, and `RolloutCoordinator` is the
single ledger of issued and completed work: re-queued prompts keep their
seq_no, a duplicate completion is dropped and counted. The actor-hosted
generator (`RolloutReplica`) needs the runtime and is not ported.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.llm.sampling import SamplingParams


@dataclasses.dataclass
class Experience:
    """One completed rollout: the unit the learner consumes."""
    seq_no: int
    prompt: List[int]            # WITHOUT the system prompt
    response: List[int]
    reward: float
    weights_version: int         # params version the tokens were sampled under
    replica: str = ""            # generator that produced it


def default_reward(prompt: Sequence[int], response: Sequence[int]) -> float:
    """Synthetic stand-in reward: distinct-token fraction of the response."""
    if not response:
        return 0.0
    return len(set(response)) / len(response)


class RolloutCoordinator:
    """The loop's ledger of rollout work: pending -> issued -> done.

    Exactly-once completion: `complete()` drops (and counts) any seq_no
    already done. `requeue()` moves issued work back to the FRONT of
    pending so recovered prompts keep their position roughly in order."""

    def __init__(self):
        self._next_seq = 0
        self._pending: deque = deque()            # (seq_no, prompt)
        self._issued: Dict[int, List[int]] = {}   # seq_no -> prompt
        self._done: Dict[int, Experience] = {}
        self.dup_completions = 0
        self.requeues = 0

    def add_prompts(self, prompts: Sequence[Sequence[int]]) -> List[int]:
        seqs = []
        for p in prompts:
            self._pending.append((self._next_seq, list(p)))
            seqs.append(self._next_seq)
            self._next_seq += 1
        return seqs

    def take(self, n: int) -> List[Tuple[int, List[int]]]:
        """Hand out up to n pending prompts, marking them issued."""
        out = []
        while self._pending and len(out) < n:
            seq, prompt = self._pending.popleft()
            self._issued[seq] = prompt
            out.append((seq, prompt))
        return out

    def complete(self, experiences: Sequence[Experience]) -> List[Experience]:
        """Record completions; returns the ones that were NEW."""
        fresh = []
        for exp in experiences:
            if exp.seq_no in self._done:
                self.dup_completions += 1
                continue
            self._done[exp.seq_no] = exp
            self._issued.pop(exp.seq_no, None)
            fresh.append(exp)
        return fresh

    def requeue(self, seq_nos: Sequence[int]) -> int:
        """Return issued-but-incomplete prompts to the front of pending."""
        n = 0
        for seq in sorted(seq_nos, reverse=True):
            prompt = self._issued.pop(seq, None)
            if prompt is None or seq in self._done:
                continue
            self._pending.appendleft((seq, prompt))
            n += 1
        self.requeues += n
        return n

    def requeue_all_issued(self) -> int:
        return self.requeue(list(self._issued))

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    @property
    def issued_count(self) -> int:
        return len(self._issued)

    def round_complete(self) -> bool:
        return not self._pending and not self._issued

    def drain_done(self) -> List[Experience]:
        """Pop all completed experiences in seq_no order."""
        out = [self._done[s] for s in sorted(self._done)]
        self._done.clear()
        return out

    def ledger(self) -> dict:
        return {"next_seq": self._next_seq,
                "pending": self.pending_count,
                "issued": self.issued_count,
                "dup_completions": self.dup_completions,
                "requeues": self.requeues}


def rollout_seed(base_seed: int, seq_no: int) -> int:
    """Per-prompt sampling seed: a function of (base_seed, seq_no) ONLY, so
    a re-queued prompt regenerates the identical tokens and batching order
    never leaks into the sampled stream."""
    return (base_seed * 1_000_003 + seq_no) & 0x7FFFFFFF


def run_rollout_round(engine, items: Sequence[Tuple[int, Sequence[int]]], *,
                      system_prompt: Sequence[int] = (),
                      max_new_tokens: int = 16,
                      temperature: float = 0.0,
                      base_seed: int = 0,
                      reward_fn: Optional[Callable] = None,
                      replica: str = "") -> List[Experience]:
    """Generate one batch of rollouts on `engine` (all items admitted up
    front; the engine interleaves their prefill and decode). Returns one
    Experience per item."""
    reward_fn = reward_fn or default_reward
    sys_p = list(system_prompt)
    rid_to_item = {}
    for seq, prompt in items:
        sp = SamplingParams(temperature=temperature,
                            max_tokens=max_new_tokens,
                            seed=rollout_seed(base_seed, seq))
        rid = engine.add_request(sys_p + list(prompt), sp)
        rid_to_item[rid] = (seq, list(prompt))
    done: Dict[str, List[int]] = {}
    while engine.has_unfinished():
        for out in engine.step():
            if out.finished and out.request_id in rid_to_item:
                done[out.request_id] = list(out.output_token_ids)
    version = getattr(engine, "weights_version", 0)
    return [Experience(seq_no=seq, prompt=prompt,
                       response=done.get(rid, []),
                       reward=float(reward_fn(prompt, done.get(rid, []))),
                       weights_version=version, replica=replica)
            for rid, (seq, prompt) in rid_to_item.items()]
