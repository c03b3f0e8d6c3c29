"""Sampling parameters and host-side token sampling (port of
ray_tpu/llm/sampling.py). The engine's own sampling runs on the device
in llm/model_runner.py; `sample` is the host reference for one row."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = disabled
    top_p: float = 1.0
    max_tokens: int = 64
    stop_token_ids: Optional[List[int]] = None
    repetition_penalty: float = 1.0
    seed: Optional[int] = None


def sample(logits: np.ndarray, params: SamplingParams,
           prev_tokens: Optional[np.ndarray] = None) -> int:
    logits = np.asarray(logits, dtype=np.float64).copy()
    if params.repetition_penalty != 1.0 and prev_tokens is not None \
            and prev_tokens.size:
        seen = np.unique(prev_tokens)
        pos = logits[seen] > 0
        logits[seen[pos]] /= params.repetition_penalty
        logits[seen[~pos]] *= params.repetition_penalty
    if params.temperature <= 0.0:
        return int(np.argmax(logits))
    logits /= params.temperature
    if params.top_k > 0:
        kth = np.partition(logits, -params.top_k)[-params.top_k]
        logits[logits < kth] = -np.inf
    if params.top_p < 1.0:
        order = np.argsort(logits)[::-1]
        probs = _softmax(logits[order])
        keep = np.cumsum(probs) <= params.top_p
        keep[0] = True
        cut = order[~keep]
        logits[cut] = -np.inf
    probs = _softmax(logits)
    rng = np.random.default_rng(params.seed)
    return int(rng.choice(len(probs), p=probs))


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - np.max(x[np.isfinite(x)] if np.isfinite(x).any() else x)
    e = np.exp(np.where(np.isfinite(x), x, -np.inf))
    return e / e.sum()
