"""RPC fault injection: delay/drop/fail calls by method pattern.

The port's copy of ray_tpu/runtime/chaos.py. The runtime's RPC layer
(runtime/rpc.py) and the in-process replica adapter (llm/router.py
`LocalReplica`) consult the process-local `RpcChaos` table before every
call, as the JAX package's do, so tests drive retry paths with injected
faults.

Config is a spec string, programmatic or via the RAY_TPU_TORCH_CHAOS env
var (so spawned raylets/workers inherit it; the port reads none of the JAX
runtime's variables):

    "method_glob=mode:prob[:param][,...]"

  modes:  fail    — raise ConnectionLost before calling (prob)
          timeout — swallow the reply: caller sees ConnectionLost after
                    param seconds (default 1.0)
          delay   — sleep param seconds (default 0.05) before dispatch
  e.g. RAY_TPU_TORCH_CHAOS="lease_worker=fail:0.2,pull_object=delay:0.3:0.1"

Determinism: draws come from a dedicated RNG seeded from RAY_TPU_TORCH_CHAOS_SEED
(default 0) + the process id, so multi-process runs differ but a whole-test
rerun with a fixed pid layout is reproducible in practice; tests assert on
behavior (retries succeed), not on exact draw sequences.
"""

from __future__ import annotations

import asyncio
import fnmatch
import os
import random
from typing import List, Optional

FAIL, TIMEOUT, DELAY = "fail", "timeout", "delay"


class ConnectionLost(ConnectionError):
    """An injected transport failure: the call never reached the replica
    (the counterpart of the JAX runtime's rpc.ConnectionLost)."""


class ChaosRule:
    __slots__ = ("pattern", "mode", "prob", "param", "max_hits", "hits")

    def __init__(self, pattern: str, mode: str, prob: float,
                 param: float = 0.0, max_hits: Optional[int] = None):
        if mode not in (FAIL, TIMEOUT, DELAY):
            raise ValueError(f"unknown chaos mode {mode!r}")
        self.pattern = pattern
        self.mode = mode
        self.prob = prob
        self.param = param
        self.max_hits = max_hits   # stop injecting after N hits (None = inf)
        self.hits = 0

    def matches(self, method: str) -> bool:
        if self.max_hits is not None and self.hits >= self.max_hits:
            return False
        return fnmatch.fnmatch(method, self.pattern)


class RpcChaos:
    """Process-local chaos table; disabled (zero overhead) unless rules
    exist."""

    def __init__(self):
        self._rules: List[ChaosRule] = []
        seed = int(os.environ.get("RAY_TPU_TORCH_CHAOS_SEED", "0"))
        self._rng = random.Random(seed ^ os.getpid())
        spec = os.environ.get("RAY_TPU_TORCH_CHAOS", "")
        if spec:
            self.configure(spec)

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    def configure(self, spec: str):
        """Parse and append rules from a spec string (see module doc).

        Each rule is validated independently; a malformed fragment raises
        ValueError naming the offending fragment (a RAY_TPU_TORCH_CHAOS typo
        must fail the run loudly, not silently change which faults get
        injected).
        Rules parsed before the bad fragment are NOT added — the spec is
        applied all-or-nothing."""
        rules = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                pattern, rhs = part.split("=", 1)
                if not pattern:
                    raise ValueError("empty method pattern")
                fields = rhs.split(":")
                mode = fields[0]
                if mode not in (FAIL, TIMEOUT, DELAY):
                    raise ValueError(
                        f"unknown mode {mode!r} (expected one of "
                        f"{FAIL!r}, {TIMEOUT!r}, {DELAY!r})")
                prob = float(fields[1]) if len(fields) > 1 else 1.0
                if not 0.0 <= prob <= 1.0:
                    raise ValueError(f"probability {prob!r} not in [0, 1]")
                param = float(fields[2]) if len(fields) > 2 else (
                    1.0 if mode == TIMEOUT else 0.05)
                if param < 0:
                    raise ValueError(f"negative param {param!r}")
                max_hits = int(fields[3]) if len(fields) > 3 else None
                if max_hits is not None and max_hits < 0:
                    raise ValueError(f"negative max_hits {max_hits!r}")
                if len(fields) > 4:
                    raise ValueError(
                        f"too many ':' fields ({len(fields)}, max 4)")
            except ValueError as e:
                raise ValueError(
                    f"bad RAY_TPU_TORCH_CHAOS rule {part!r}: {e} "
                    f"(expected 'method_glob=mode:prob[:param[:max_hits]]')"
                ) from e
            rules.append((pattern, mode, prob, param, max_hits))
        for pattern, mode, prob, param, max_hits in rules:
            self.add_rule(pattern, mode, prob, param, max_hits)

    def add_rule(self, pattern: str, mode: str, prob: float = 1.0,
                 param: float = 0.0, max_hits: Optional[int] = None
                 ) -> ChaosRule:
        rule = ChaosRule(pattern, mode, prob, param, max_hits)
        self._rules.append(rule)
        return rule

    def clear(self):
        self._rules.clear()

    def _draw(self, method: str) -> Optional[ChaosRule]:
        for rule in self._rules:
            if rule.matches(method) and self._rng.random() < rule.prob:
                rule.hits += 1
                return rule
        return None

    async def intercept_client(self, method: str):
        """Runs before a client sends a request. May raise ConnectionLost
        (fail mode) or sleep (delay mode). timeout mode is handled server
        side."""
        if not self._rules:
            return
        rule = self._draw(method)
        if rule is None:
            return
        if rule.mode == FAIL:
            raise ConnectionLost(
                f"chaos: injected failure for {method!r}")
        if rule.mode == DELAY:
            await asyncio.sleep(rule.param)

    async def intercept_server(self, method: str) -> bool:
        """Runs before a server dispatches a request. Returns True if the
        request should be silently dropped (timeout mode — the caller's
        await then times out / sees the connection close later), after an
        optional delay."""
        if not self._rules:
            return False
        rule = self._draw(method)
        if rule is None:
            return False
        if rule.mode == DELAY:
            await asyncio.sleep(rule.param)
            return False
        if rule.mode == TIMEOUT:
            await asyncio.sleep(rule.param)
            return True
        return False   # FAIL is a client-side mode


_instance: Optional[RpcChaos] = None


def chaos() -> RpcChaos:
    global _instance
    if _instance is None:
        _instance = RpcChaos()
    return _instance


def reset():
    """Drop all rules AND the instance (tests)."""
    global _instance
    _instance = None
