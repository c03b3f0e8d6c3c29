"""LLM routing core: prefix affinity, pow2 on real load, SLO admission,
replica health, and the prefill tier's retry.

The port's copy of the in-process half of ray_tpu/llm/router.py:

  1. **Prefix-cache affinity.** The engine's prefix cache keys blocks by a
     salted digest chain over prompt blocks (engine.prefix_digest_chain).
     The router keeps its own chain -> replica map under its OWN salt:
     route a prompt to the replica that most recently served its longest
     matching chain and that replica's cache hits on the shared prefix.
  2. **Session / LoRA affinity.** A session's follow-up turn lands where
     its KV pages are still hot.
  3. **Power-of-two-choices on real load**: queue depth (waiting +
     prefilling + running from LLMServer.engine_stats()), router-side
     in-flight, and KV occupancy.
  4. **SLO-aware admission.** Projected TTFT = queued prefill tokens ahead
     of this request / measured prefill throughput; above slo_ttft_s the
     request is shed at once instead of queueing without bound.
  5. **Health and draining flags**: ejected replicas are never picked
     again (their affinity entries pruned at once), draining ones take no
     new picks, and `remap` repoints affinity after a migration.

`prefill_with_retry` drives a disaggregated request (llm/disagg.py): it
runs prefill on the first prefill replica that survives it, handing the
decode replica's KV handoff address along. The handoff wire is atomic,
so a prefill replica dying mid-handoff leaves nothing adopted and the
whole prefill re-runs elsewhere.

RouterCore and LocalReplica are cluster-free (replicas are anything with
a `.call(method, *args)` surface). The JAX package's ActorReplica,
FleetSupervisor and LLMRouter need an actor runtime and are a later
slice.
"""

from __future__ import annotations

import collections
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.llm.engine import prefix_digest_chain

# Load-score weight of KV occupancy relative to one queued request: a
# replica with a full cache is one whose next admission will evict reusable
# prefixes, so treat it as ~2 requests heavier.
_KV_PRESSURE_WEIGHT = 2.0
# An affinity owner more than this many score points heavier than the
# lightest replica loses the request anyway (cache reuse never justifies
# piling onto a hotspot).
_AFFINITY_IMBALANCE = 8.0


class NoHealthyReplicasError(RuntimeError):
    """Every replica is ejected or draining; nothing can take the request."""


class LocalReplica:
    """In-process replica adapter: `call(method, *args)` on the object,
    with RpcChaos fault injection (runtime/chaos.py) honored, so chaos
    tests exercise the router's retry path without a cluster."""

    def __init__(self, obj: Any, name: str = ""):
        self._obj = obj
        self.name = name or type(obj).__name__
        self.key = f"local:{self.name}:{id(obj):x}"

    def call(self, method: str, *args, **kwargs):
        from ray_tpu_torch.runtime.chaos import chaos

        kwargs.pop("_timeout", None)
        c = chaos()
        if c.enabled:
            import asyncio

            asyncio.run(c.intercept_client(f"{self.name}.{method}"))
        return getattr(self._obj, method)(*args, **kwargs)


class RouterCore:
    """Routing state machine: affinity maps, load scores, admission gate,
    and per-replica health/draining flags.

    Indexes replicas 0..n-1; the owner (a fleet supervisor or a test) maps
    indexes to actual replica objects and feeds `pick`/`admit` fresh
    engine_stats payloads. Slots are append-only: an ejected replica keeps
    its index (never routable again) and replacements get fresh indexes
    via add_replica, so affinity maps never alias across replica
    generations. Thread-safe under one internal lock (decisions are cheap;
    the expensive work — stats RPCs, token streaming — happens outside)."""

    def __init__(self, n_replicas: int, *, block_size: int = 16,
                 slo_ttft_s: float = 0.0, prefix_lru: int = 8192,
                 prefill_tps: Optional[float] = None,
                 fail_threshold: int = 3):
        if n_replicas < 1:
            raise ValueError("router needs at least one replica")
        self.n = n_replicas
        self.block_size = block_size
        self.slo_ttft_s = float(slo_ttft_s)
        self._lock = threading.Lock()
        # Router-local salt: chains here never meet replica-side chains
        # (those are salted per process); only internal consistency matters.
        self._salt = os.urandom(16)
        # digest -> replica idx, LRU-bounded; last writer wins (that replica
        # holds the freshest copy of the blocks).
        self._prefix_owner: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self._prefix_lru = prefix_lru
        self._session_owner: Dict[str, int] = {}
        self._inflight = [0] * n_replicas
        # Health: consecutive stats-probe failures accumulate toward
        # fail_threshold; a hard call failure ejects immediately. Draining
        # replicas stay healthy but take no new picks (their sessions are
        # mid-migration).
        self._healthy = [True] * n_replicas
        self._draining = [False] * n_replicas
        self._fail_counts = [0] * n_replicas
        self.fail_threshold = max(1, int(fail_threshold))
        self.ejected_count = 0
        # Prefill-throughput EWMA feeding the TTFT estimator; a pinned
        # value (tests) disables the online update.
        self._prefill_tps = prefill_tps or 0.0
        self._prefill_tps_pinned = prefill_tps is not None
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.shed_count = 0

    # ---- affinity --------------------------------------------------------

    def digest_chain(self, prompt: Sequence[int],
                     lora_name: Optional[str] = None) -> List[bytes]:
        return prefix_digest_chain(prompt, self.block_size, salt=self._salt,
                                   seed=(lora_name or "").encode())

    def _remember(self, chain: List[bytes], idx: int):
        for d in chain:
            if d in self._prefix_owner:
                self._prefix_owner.move_to_end(d)
            self._prefix_owner[d] = idx
        while len(self._prefix_owner) > self._prefix_lru:
            self._prefix_owner.popitem(last=False)

    # ---- health ----------------------------------------------------------

    def is_healthy(self, idx: int) -> bool:
        return 0 <= idx < self.n and self._healthy[idx]

    def is_routable(self, idx: int) -> bool:
        return (0 <= idx < self.n and self._healthy[idx]
                and not self._draining[idx])

    def healthy_count(self) -> int:
        return sum(self._healthy)

    def routable_count(self) -> int:
        return sum(h and not d for h, d in zip(self._healthy, self._draining))

    def note_success(self, idx: int) -> None:
        with self._lock:
            if 0 <= idx < self.n:
                self._fail_counts[idx] = 0

    def note_failure(self, idx: int, hard: bool = False) -> bool:
        """Record a probe/call failure; True when the replica should now be
        ejected (hard failure, or fail_threshold consecutive probes)."""
        with self._lock:
            if not (0 <= idx < self.n) or not self._healthy[idx]:
                return False
            self._fail_counts[idx] += 1
            return hard or self._fail_counts[idx] >= self.fail_threshold

    def set_draining(self, idx: int, flag: bool = True) -> None:
        with self._lock:
            if 0 <= idx < self.n:
                self._draining[idx] = flag

    def eject(self, idx: int) -> Optional[Dict]:
        """Declare a replica dead: no pick ever returns it again, and its
        prefix-digest owner-LRU and session-stickiness entries are pruned
        EAGERLY (the affinity-leak fix — without this, requests keep
        routing to the corpse until LRU eviction). Returns prune counts,
        or None when already ejected (idempotent)."""
        with self._lock:
            if not (0 <= idx < self.n) or not self._healthy[idx]:
                return None
            self._healthy[idx] = False
            self._draining[idx] = False
            dead_digests = [d for d, o in self._prefix_owner.items()
                            if o == idx]
            for d in dead_digests:
                del self._prefix_owner[d]
            dead_sessions = [s for s, o in self._session_owner.items()
                             if o == idx]
            for s in dead_sessions:
                del self._session_owner[s]
            self._inflight[idx] = 0
            self.ejected_count += 1
            return {"prefix_pruned": len(dead_digests),
                    "sessions_pruned": len(dead_sessions)}

    def remap(self, old: int, new: int) -> Dict:
        """Atomically repoint every affinity entry old -> new (the adoptive
        replica now holds the migrated sessions' KV), so follow-up turns
        land where the pages moved instead of re-prefilling elsewhere."""
        with self._lock:
            n_prefix = n_sessions = 0
            for d, o in self._prefix_owner.items():
                if o == old:
                    self._prefix_owner[d] = new
                    n_prefix += 1
            for s, o in self._session_owner.items():
                if o == old:
                    self._session_owner[s] = new
                    n_sessions += 1
            return {"prefix_remapped": n_prefix,
                    "sessions_remapped": n_sessions}

    def add_replica(self) -> int:
        """Grow the fleet by one slot (scale-up / replacement capacity)."""
        with self._lock:
            self.n += 1
            self._inflight.append(0)
            self._healthy.append(True)
            self._draining.append(False)
            self._fail_counts.append(0)
            return self.n - 1

    # ---- load ------------------------------------------------------------

    def _load_score(self, idx: int, stats: Sequence[Optional[Dict]]) -> float:
        s = stats[idx] if idx < len(stats) else None
        score = float(self._inflight[idx])
        if s:
            score += s.get("waiting", 0) + s.get("prefilling", 0) \
                + s.get("running", 0)
            total = s.get("total_kv_blocks", 0)
            if total:
                score += _KV_PRESSURE_WEIGHT * (
                    1.0 - s.get("free_kv_blocks", 0) / total)
        return score

    def load_score(self, idx: int,
                   stats: Sequence[Optional[Dict]]) -> float:
        with self._lock:
            return self._load_score(idx, stats)

    # ---- decisions -------------------------------------------------------

    def pick(self, prompt: Sequence[int], *,
             session_id: Optional[str] = None,
             lora_name: Optional[str] = None,
             stats: Optional[Sequence[Optional[Dict]]] = None,
             exclude: Optional[Set[int]] = None
             ) -> Tuple[int, Dict]:
        """Choose a replica. Returns (idx, decision) where decision carries
        the reason ("session" | "prefix" | "pow2") and matched_blocks.
        Only healthy, non-draining replicas (minus `exclude` — replicas a
        failover already tried) are candidates; raises
        NoHealthyReplicasError when none remain."""
        import random

        stats = stats if stats is not None else [None] * self.n
        chain = self.digest_chain(prompt, lora_name)
        exclude = exclude or set()
        with self._lock:
            elig = [i for i in range(self.n)
                    if self._healthy[i] and not self._draining[i]
                    and i not in exclude]
            if not elig:
                raise NoHealthyReplicasError(
                    f"no healthy replicas ({self.n} slots: "
                    f"{self.healthy_count()} healthy, "
                    f"{len(exclude)} excluded by this request)")
            elig_set = set(elig)
            scores = {i: self._load_score(i, stats) for i in elig}
            floor = min(scores.values())
            idx: Optional[int] = None
            decision = {"reason": "pow2", "matched_blocks": 0}
            if session_id is not None:
                owner = self._session_owner.get(session_id)
                if owner is not None and owner in elig_set \
                        and scores[owner] - floor <= _AFFINITY_IMBALANCE:
                    idx = owner
                    decision = {"reason": "session", "matched_blocks": 0}
            if idx is None:
                # Deepest cached chain wins: scan from the longest prefix
                # down so a replica holding 8 blocks beats one holding 2.
                for i in range(len(chain) - 1, -1, -1):
                    owner = self._prefix_owner.get(chain[i])
                    if owner is None or owner not in elig_set:
                        continue
                    if scores[owner] - floor > _AFFINITY_IMBALANCE:
                        break  # owner is a hotspot; fall through to pow2
                    idx = owner
                    decision = {"reason": "prefix", "matched_blocks": i + 1}
                    break
            if idx is None:
                if len(elig) == 1:
                    idx = elig[0]
                else:
                    a, b = random.sample(elig, 2)
                    idx = a if scores[a] <= scores[b] else b
                self.affinity_misses += 1
            else:
                self.affinity_hits += 1
            if session_id is not None:
                self._session_owner[session_id] = idx
            self._remember(chain, idx)
            return idx, decision

    def admit(self, idx: int, prompt_len: int,
              stats: Optional[Sequence[Optional[Dict]]] = None
              ) -> Tuple[bool, float]:
        """SLO admission gate: (ok, projected_ttft_s). Projected TTFT is
        the prefill tokens queued ahead of this request divided by measured
        prefill throughput; with no SLO configured everything admits."""
        if self.slo_ttft_s <= 0.0:
            return True, 0.0
        with self._lock:
            tps = self._prefill_tps
        if tps <= 0.0:
            return True, 0.0  # no throughput signal yet: never shed blind
        s = (stats[idx] if stats is not None and idx < len(stats) else None) \
            or {}
        queued = s.get("queued_prefill_tokens", 0)
        projected = (queued + prompt_len) / tps
        if projected > self.slo_ttft_s:
            with self._lock:
                self.shed_count += 1
            return False, projected
        return True, projected

    def observe_prefill(self, tokens: int, seconds: float):
        """Feed the TTFT estimator with a measured prefill."""
        if self._prefill_tps_pinned or seconds <= 0 or tokens <= 0:
            return
        rate = tokens / seconds
        with self._lock:
            self._prefill_tps = (rate if self._prefill_tps == 0.0
                                 else 0.8 * self._prefill_tps + 0.2 * rate)

    def start(self, idx: int):
        with self._lock:
            if idx < len(self._inflight):
                self._inflight[idx] += 1

    def finish(self, idx: int):
        with self._lock:
            if idx < len(self._inflight):
                self._inflight[idx] = max(0, self._inflight[idx] - 1)


class PrefillTierError(RuntimeError):
    """Every prefill replica failed transport-side: the tier is down.
    Routers report this upstream as a 503 — it is never attributed to the
    decode replica the request happened to be paired with."""


# Replica-side failures of the prefill→decode handoff wire (socket death,
# rejected adoption) cross the actor-RPC boundary re-wrapped in TaskError,
# so retryability is classified by message marker like the drain errors.
_HANDOFF_RETRY_RE = re.compile(
    r"HandoffError|ConnectionLost|Connection(Error|RefusedError|ResetError|"
    r"AbortedError)|BrokenPipeError|socket\.timeout")


def prefill_with_retry(prefill_replicas: Sequence[Any], request: Dict,
                       decode_address) -> Dict:
    """Run prefill on the first replica that survives it.

    The handoff wire is atomic (llm/disagg.py): a replica that dies
    mid-stream leaves NOTHING adopted on the decode side, so re-running
    the whole prefill elsewhere is always correct — just wasted compute.
    Only transport/handoff failures retry: an error the replica raised
    executing the request (validation ValueError from _parse) is
    deterministic — every replica would fail identically — so it
    propagates to the client immediately."""
    last: Optional[Exception] = None
    for replica in prefill_replicas:
        try:
            return replica.call("prefill", request, decode_address)
        except Exception as e:  # ConnectionLost, HandoffError, socket death
            if not (_is_transport_error(e)
                    or _HANDOFF_RETRY_RE.search(repr(e))):
                raise
            last = e
    raise PrefillTierError(
        f"prefill failed on all {len(prefill_replicas)} replicas") from last


# Replica exceptions cross actor RPC boundaries re-wrapped in transport
# error types, so classification is by message marker, not isinstance
# (serving.SessionMigratedError / ReplicaDrainingError embed these).
_MIGRATED_RE = re.compile(r"SESSION_MIGRATED (kv|replay)")


def _migrated_mode(exc: BaseException) -> Optional[str]:
    m = _MIGRATED_RE.search(repr(exc))
    return m.group(1) if m else None


def _is_draining_error(exc: BaseException) -> bool:
    return "REPLICA_DRAINING" in repr(exc)


def _is_transport_error(exc: BaseException) -> bool:
    """True when the error means the CALL never completed (a dropped
    connection, a refused or reset socket, an injected ConnectionLost):
    the only failures that justify retrying the request elsewhere.

    A request timeout the replica REPORTS (serving.RequestTimeoutError,
    a TimeoutError and so an OSError) is excluded first: the replica is
    alive and a replay would fail the same way. The JAX package also
    counts its runtime's actor, get-timeout, worker-crash, node-death,
    object-loss and RPC errors here; the port has no runtime, so those
    wait for it."""
    from ray_tpu_torch.llm.serving import RequestTimeoutError

    if isinstance(exc, RequestTimeoutError):
        return False
    return isinstance(exc, OSError)
