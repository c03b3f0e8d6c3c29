"""Token-throughput-aware LLM router: prefix affinity, pow2, SLO admission,
replica health, failover, and drain-plane session migration.

The port's copy of ray_tpu/llm/router.py. For LLM apps a router
deployment replaces the handle's blind power-of-two pick with one that
sees what matters for token throughput:

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
     request is shed at once with a 429-shaped error instead of queueing
     without bound.

Fleet resilience (FleetSupervisor):

  5. **Health + failover.** A replica whose engine_stats probes keep
     failing, or whose request call fails in transport, is ejected (its
     affinity entries pruned at once) and every request it held replays
     on a survivor under the SAME request_id: the engine seeds sampling
     from crc32(request_id), so the replay is token-identical and the
     client sees one response and an LLM_REQUEST_FAILOVER event.
  6. **Live session migration.** A replica whose node drains (or that the
     replica policy retires) stops admitting and exports its in-flight
     requests, KV pages included, to an adoptive replica over the KV
     stream wire (llm/disagg.py migrate_session); the router remaps
     affinity to the target, so the sessions resume with no re-prefill.
  7. **Telemetry-driven scaling.** A ReplicaPolicy (llm/replica_policy.py)
     turns queue-delay / KV-pressure signals into a replica count;
     scale-down is drain-then-migrate, never kill.

With a prefill tier (LLMConfig.disaggregate > 0) the router also picks a
prefill replica, hands it the decode replica's KV handoff address
(`prefill_with_retry`) and collects the completion from the decode
replica once the pages are adopted. The handoff wire is atomic, so a
prefill replica dying mid-handoff leaves nothing adopted and the prefill
re-runs elsewhere; a whole-tier outage is a 503 that never touches the
decode replicas' health.

RouterCore, LocalReplica and FleetSupervisor are cluster-free (replicas
are anything with a `.call(method, *args)` surface, scaling actions are
injected callbacks), so tests drive them against in-process servers;
ActorReplica and LLMRouter, the serve deployment around them, run on the
port's runtime. With a cluster prefix store (llm/prefix_store.py) the
supervisor falls back to the table's owner hints where its own owner LRU
misses (a new router, an ejected owner), and blanks an ejected replica's
hints in the same tick.
"""

from __future__ import annotations

import collections
import logging
import os
import re
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.llm.engine import prefix_digest_chain

log = logging.getLogger(__name__)

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


class ActorReplica:
    """Replica actor handle adapter (the serve path): `call` runs the
    method through the replica's `handle_request` and waits for it."""

    def __init__(self, handle: Any, name: str = "", timeout: float = 600.0):
        self._handle = handle
        self._timeout = timeout
        self.name = name
        aid = getattr(handle, "_actor_id", None)
        self.key = (bytes(aid).hex() if isinstance(aid, (bytes, bytearray))
                    else str(aid))

    def call(self, method: str, *args, **kwargs):
        import ray_tpu_torch as rt

        # `_timeout` is adapter-reserved (health probes use short deadlines
        # so a dead actor can't wedge the router for the full RPC timeout).
        timeout = kwargs.pop("_timeout", self._timeout)
        ref = self._handle.handle_request.remote(method, list(args), kwargs)
        return rt.get(ref, timeout=timeout)


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
    """True when the error means the CALL never completed (actor death,
    wedged RPC, dropped connection): the only failures that justify
    ejecting the replica and replaying the request elsewhere.

    A TaskError does NOT match: the replica executed the request and
    raised (a validation error from _parse, a per-request stream timeout,
    an engine error). The replica is alive and a replay would fail the
    same way, so those reach the client without touching replica
    health."""
    from ray_tpu_torch.core import exceptions as exc_mod
    from ray_tpu_torch.llm.serving import RequestTimeoutError
    from ray_tpu_torch.runtime.rpc import RpcError

    # RequestTimeoutError is a TimeoutError, so an OSError, but it is the
    # replica REPORTING a per-request deadline, not a dead transport:
    # exclude it before the OSError check.
    if isinstance(exc, (exc_mod.TaskError, RequestTimeoutError)):
        return False
    return isinstance(exc, (exc_mod.ActorError, exc_mod.GetTimeoutError,
                            exc_mod.WorkerCrashedError,
                            exc_mod.NodeDiedError, exc_mod.ObjectLostError,
                            RpcError, OSError))


class FleetSupervisor:
    """The fleet resilience engine around RouterCore: request failover,
    drain-plane session migration, node-event handling, and replica-count
    policy. Cluster-free: replicas are anything with the
    LocalReplica/ActorReplica `.call` surface, and scaling actions are
    injected callbacks, so tests drive the real failover and migration
    machinery against in-process servers."""

    STATS_TTL_S = 0.25
    STATS_TIMEOUT_S = 5.0

    def __init__(self, core: RouterCore, replicas: Sequence[Any], *,
                 deployment: str = "llm",
                 prefill_replicas: Sequence[Any] = (),
                 policy: Any = None,
                 scale_up_fn: Optional[Callable[[int], Any]] = None,
                 retire_fn: Optional[Callable[[int], Any]] = None,
                 prefix_store: Any = None):
        from ray_tpu_torch.runtime import metric_defs as md

        self.core = core
        self.replicas: List[Any] = list(replicas)
        self.prefill_replicas: List[Any] = list(prefill_replicas)
        self.deployment = deployment
        self.policy = policy
        # Cluster prefix table client (llm/prefix_store.py), optional: the
        # owner LRU's fallback after an owner's ejection or a restart, and
        # the same-tick hygiene when a replica is ejected.
        self.prefix_store = prefix_store
        self._scale_up_fn = scale_up_fn
        self._retire_fn = retire_fn
        self._lock = threading.Lock()        # replica list + drain state
        self._stats_lock = threading.Lock()
        self._stats: List[Optional[Dict]] = [None] * len(self.replicas)
        self._stats_t = 0.0
        # replica idx -> KV stream address, resolved once per replica.
        self._handoff_addrs: Dict[int, Any] = {}
        # Draining idx -> adoptive idx: where a consumer hit by
        # SessionMigratedError("kv") re-collects its stream.
        self._drain_target: Dict[int, int] = {}
        # Event-ring watermark (time.time() base, matching make_event):
        # starts at NOW so a (re)started supervisor never replays
        # historical NODE_DRAINING/NODE_DEAD events against replicas on a
        # node that drained and recovered before this supervisor existed.
        self._events_since = time.time()
        self.failovers = 0
        self.migrated_sessions = 0
        tags = {"deployment": deployment}
        self._m_failovers = md.LLM_FAILOVERS.bind(tags)
        self._m_migrated = md.LLM_SESSIONS_MIGRATED.bind(tags)
        self._m_healthy = md.LLM_REPLICAS_HEALTHY.bind(tags)
        self._m_healthy.set(core.healthy_count())

    # ---- replica set -----------------------------------------------------

    def add_replica(self, replica: Any) -> int:
        """Append a new replica slot (scale-up / replacement capacity)."""
        with self._lock:
            self.replicas.append(replica)
            idx = self.core.add_replica()
        with self._stats_lock:
            self._stats.append(None)
        self._m_healthy.set(self.core.healthy_count())
        return idx

    def replica_keys(self) -> Set[str]:
        with self._lock:
            return {getattr(r, "key", None) for r in self.replicas}

    # ---- stats + health probing ------------------------------------------

    def fresh_stats(self, force: bool = False) -> List[Optional[Dict]]:
        now = time.monotonic()
        with self._stats_lock:
            if not force and now - self._stats_t < self.STATS_TTL_S:
                return self._stats
            self._stats_t = now
        stats: List[Optional[Dict]] = []
        for i, r in enumerate(list(self.replicas)):
            if not self.core.is_healthy(i):
                stats.append(None)
                continue
            try:
                s = r.call("engine_stats", _timeout=self.STATS_TIMEOUT_S)
                self.core.note_success(i)
            except Exception as e:
                # Staleness accrues per failed probe; fail_threshold
                # consecutive misses eject (the replica stopped answering
                # the cheapest call it serves).
                s = None
                if self.core.note_failure(i):
                    self.eject_replica(i, reason=f"stats probe: {e!r:.80}")
            stats.append(s)
        with self._stats_lock:
            self._stats = stats
        return stats

    def _handoff_addr(self, idx: int):
        addr = self._handoff_addrs.get(idx)
        if addr is None:
            addr = self.replicas[idx].call("handoff_address")
            self._handoff_addrs[idx] = addr
        return addr

    # ---- ejection + migration --------------------------------------------

    def eject_replica(self, idx: int, *, reason: str = "") -> Optional[Dict]:
        """Health verdict: the replica is dead. Prune its affinity state,
        stop routing to it, emit LLM_REPLICA_EJECTED. Idempotent."""
        from ray_tpu_torch.runtime import events

        pruned = self.core.eject(idx)
        if pruned is None:
            return None
        self._handoff_addrs.pop(idx, None)
        self._m_healthy.set(self.core.healthy_count())
        # Same-tick hygiene of the cluster table, beside the owner-LRU prune
        # above: blank the dead replica's live-owner hints so no lookup
        # routes a request to it. The rows stay: the pages are GCS-homed
        # and any survivor adopts them.
        if self.prefix_store is not None:
            with self._stats_lock:
                s = self._stats[idx] if idx < len(self._stats) else None
            tag = (s or {}).get("replica") or ""
            if tag:
                try:
                    self.prefix_store.purge(owner_replica=tag,
                                            clear_owner_only=True)
                except Exception:
                    log.exception("owner-hint purge of %s failed", tag)
        events.emit(
            events.LLM_REPLICA_EJECTED,
            f"replica {idx} ejected: {reason or 'unhealthy'} "
            f"({pruned['prefix_pruned']} prefix + "
            f"{pruned['sessions_pruned']} session affinity entries pruned)",
            severity=events.WARNING, source="llm-router",
            labels={"replica": str(idx), "deployment": self.deployment,
                    "reason": reason[:120],
                    **{k: str(v) for k, v in pruned.items()}})
        return pruned

    def pick_migration_target(self, exclude: int) -> Optional[int]:
        """Least-loaded routable replica other than `exclude`."""
        stats = self.fresh_stats()
        best, best_score = None, None
        for i in range(self.core.n):
            if i == exclude or not self.core.is_routable(i):
                continue
            score = self.core.load_score(i, stats)
            if best_score is None or score < best_score:
                best, best_score = i, score
        return best

    def drain_replica(self, idx: int, *, reason: str = "node-draining",
                      target: Optional[int] = None) -> Dict:
        """Retire a replica gracefully: stop routing to it, migrate its
        live sessions (KV pages over the KV stream wire) to the least-
        loaded survivor, and remap affinity so follow-ups land where the
        pages went. Safe to call twice (the second call finds nothing
        live)."""
        from ray_tpu_torch.runtime import events

        if not self.core.is_healthy(idx):
            return {"migrated": [], "replayed": [], "target": None}
        self.core.set_draining(idx)
        if target is None or not self.core.is_routable(target):
            target = self.pick_migration_target(idx)
        if target is None:
            # Nowhere to migrate (last replica standing): it keeps its
            # sessions and keeps draining.
            return {"migrated": [], "replayed": [], "target": None}
        self._drain_target[idx] = target
        # Live sessions move FIRST: migrate_sessions quiesces admission and
        # snapshots the in-flight set, so the sessions decoding when the
        # drain lands are the ones that travel with their KV.
        try:
            addr = self._handoff_addr(target)
            summary = self.replicas[idx].call("migrate_sessions", addr)
        except Exception as e:
            # The draining replica died before/while exporting: the wire's
            # atomicity means nothing half-adopted; consumers' blocked
            # calls fail and ride the failover replay path.
            self.eject_replica(idx, reason=f"died during drain: {e!r:.60}")
            return {"migrated": [], "replayed": [], "target": target,
                    "error": repr(e)}
        # Working-set handoff second: the victim's hottest reusable prefix
        # pages go to the target so shared prompts stay warm. Best-effort.
        try:
            self.replicas[idx].call("push_prefixes",
                                    self._handoff_addr(target))
        except Exception:
            pass
        for rid in summary.get("send_failed", ()):
            # A migration send that failed with a lost ack may have left
            # the session adopted on the target (decoding with no consumer)
            # while the replay path re-submits it: abort the potential
            # orphan first (a no-op when nothing was adopted).
            try:
                self.replicas[target].call("abort", rid, _timeout=5.0)
            except Exception:
                pass
        remapped = self.core.remap(idx, target)
        n = len(summary.get("migrated", ()))
        if n:
            self.migrated_sessions += n
            self._m_migrated.inc(n)
        events.emit(
            events.LLM_SESSION_MIGRATED,
            f"replica {idx} drained to {target}: {n} sessions migrated "
            f"with KV, {len(summary.get('replayed', ()))} replayed from "
            f"prompt ({reason})",
            severity=events.INFO, source="llm-router",
            labels={"from_replica": str(idx), "to_replica": str(target),
                    "deployment": self.deployment, "reason": reason,
                    "migrated": str(n),
                    "replayed": str(len(summary.get("replayed", ()))),
                    **{k: str(v) for k, v in remapped.items()}})
        summary = dict(summary)
        summary["target"] = target
        return summary

    # ---- node events (the drain plane) -----------------------------------

    def replicas_on_node(self, node_hex: str) -> List[int]:
        """Replica indexes on a cluster node, by the node_id each replica
        reports in engine_stats()."""
        with self._stats_lock:
            stats = list(self._stats)
        return [i for i, s in enumerate(stats)
                if s and s.get("node_id") == node_hex
                and self.core.is_healthy(i)]

    def handle_node_event(self, ev: Dict) -> None:
        """React to one NODE_DRAINING / NODE_DEAD / NODE_PREEMPTED event:
        drain-migrate replicas on a draining node, eject replicas on a
        dead one (pruning their affinity at once)."""
        from ray_tpu_torch.runtime import events as ev_mod

        node_hex = ev.get("node_id")
        if not node_hex:
            return
        for idx in self.replicas_on_node(node_hex):
            if ev.get("type") == ev_mod.NODE_DRAINING:
                self.drain_replica(idx, reason=f"node {node_hex[:8]} "
                                               "draining")
            else:  # NODE_DEAD / NODE_PREEMPTED
                self.eject_replica(idx, reason=f"node {node_hex[:8]} "
                                               f"{ev.get('type')}")

    def check_events(self, list_events_fn: Optional[Callable] = None) -> int:
        """Poll the cluster event ring for drain-plane events newer than
        the last poll; returns how many were handled."""
        from ray_tpu_torch.runtime import events as ev_mod

        if list_events_fn is None:
            from ray_tpu_torch.state import \
                list_cluster_events as list_events_fn
        try:
            evs = list_events_fn(limit=200)
        except Exception:
            return 0
        interesting = [e for e in evs
                       if e.get("time", 0.0) > self._events_since
                       and e.get("type") in (ev_mod.NODE_DRAINING,
                                             ev_mod.NODE_DEAD,
                                             ev_mod.NODE_PREEMPTED)]
        if not interesting:
            return 0
        self._events_since = max(e["time"] for e in interesting)
        for e in sorted(interesting, key=lambda e: e.get("time", 0.0)):
            try:
                self.handle_node_event(e)
            except Exception:
                pass
        return len(interesting)

    # ---- replica-count policy --------------------------------------------

    def scale_tick(self, now: Optional[float] = None) -> Optional[Dict]:
        """One policy evaluation: compute the desired replica count from
        queue-delay/KV-pressure signals and act — scale-up through the
        injected callback, scale-down as drain-then-migrate-then-retire
        of the least-loaded replica. No-op without a policy."""
        from ray_tpu_torch.runtime import events

        if self.policy is None:
            return None
        now = time.monotonic() if now is None else now
        stats = self.fresh_stats()
        routable = [i for i in range(self.core.n)
                    if self.core.is_routable(i)]
        current = len(routable)
        if current == 0:
            return None
        desired = self.policy.desired(
            [stats[i] if i < len(stats) else None for i in routable],
            current, now)
        if desired == current:
            return None
        if desired > current:
            if self._scale_up_fn is None:
                return None
            self._scale_up_fn(desired - current)
            events.emit(
                events.LLM_REPLICAS_SCALED,
                f"scale-up {current} -> {desired} (queue delay / KV "
                "pressure over target)",
                severity=events.INFO, source="llm-router",
                labels={"deployment": self.deployment,
                        "from": str(current), "to": str(desired),
                        "direction": "up"})
            return {"direction": "up", "from": current, "to": desired}
        # Scale-down: one replica per tick, the least-loaded one, and ONLY
        # via the drain plane: its sessions migrate before the actor dies.
        victim = min(routable, key=lambda i: self.core.load_score(i, stats))
        summary = self.drain_replica(victim, reason="scale-down")
        self.core.eject(victim)  # retired, not dead: no EJECTED event
        self._handoff_addrs.pop(victim, None)
        self._m_healthy.set(self.core.healthy_count())
        if self._retire_fn is not None:
            try:
                self._retire_fn(victim)
            except Exception:
                pass
        events.emit(
            events.LLM_REPLICAS_SCALED,
            f"scale-down {current} -> {current - 1}: replica {victim} "
            f"drained ({len(summary.get('migrated', ()))} sessions "
            "migrated) and retired",
            severity=events.INFO, source="llm-router",
            labels={"deployment": self.deployment, "from": str(current),
                    "to": str(current - 1), "direction": "down",
                    "victim": str(victim)})
        return {"direction": "down", "from": current, "to": current - 1,
                "victim": victim, "drain": summary}

    # ---- request path ----------------------------------------------------

    def completions(self, request: Dict) -> Dict:
        """Route one completion with failover: the request gets a stable
        router-assigned request_id, so any replay (replica death, drain
        fallback) reproduces the same token stream (the engine seeds
        sampling from crc32(request_id) when no seed is given).

        The router owns the request's ROOT trace span: the trace id
        derives from the request id (util/tracing.request_trace_id), so
        every span a server records for this request stitches under one
        trace with no context riding the calls themselves."""
        from ray_tpu_torch.util import tracing

        request = dict(request)
        rid = request.get("request_id") or uuid.uuid4().hex[:12]
        request["request_id"] = rid
        with tracing.trace_context(tracing.request_trace_id(rid), None):
            with tracing.span("llm:request", "llm", request_id=rid,
                              deployment=self.deployment):
                return self._route_completions(request, rid)

    def _route_completions(self, request: Dict, rid: str) -> Dict:
        from ray_tpu_torch.runtime import events, metric_defs
        from ray_tpu_torch.util import tracing

        prompt = request.get("prompt", [])
        token_prompt = (list(prompt.encode()) if isinstance(prompt, str)
                        else list(prompt))
        tried: Set[int] = set()
        first_attempt = True
        while True:
            stats = self.fresh_stats()
            try:
                idx, decision = self.core.pick(
                    token_prompt, session_id=request.get("session_id"),
                    lora_name=request.get("lora_name"), stats=stats,
                    exclude=tried)
            except NoHealthyReplicasError as e:
                return {"error": {"code": 503, "type": "no_healthy_replicas",
                                  "message": str(e)}}
            if decision["reason"] == "pow2" and self.prefix_store is not None:
                # Local owner-LRU miss: the cluster prefix table remembers
                # owners across router restarts and owner ejection. A live
                # owner hint re-establishes local affinity; no hint is fine,
                # since whoever was picked adopts the GCS-homed pages.
                better = self._cluster_affinity(token_prompt, request,
                                                tried)
                if better is not None:
                    idx = better
            if first_attempt:
                # Admission gates the FIRST attempt only: a failover replay
                # has already consumed prefill work somewhere, and shedding
                # it now would turn a survivable fault into a client error.
                metric_defs.LLM_ROUTER_AFFINITY.inc(tags={
                    "outcome": "hit" if decision["reason"] != "pow2"
                    else "miss"})
                t_adm = time.time()
                ok, projected = self.core.admit(idx, len(token_prompt),
                                                stats)
                tracing.record_span(
                    "llm:admit", "llm", t_adm, time.time(),
                    request_id=rid, replica=str(idx), admitted=ok,
                    projected_ttft_s=round(projected, 4))
                if not ok:
                    metric_defs.LLM_ROUTER_SHED.inc(
                        tags={"deployment": self.deployment})
                    events.emit(
                        events.LLM_REQUEST_SHED,
                        f"shed: projected TTFT {projected:.2f}s > SLO "
                        f"{self.core.slo_ttft_s:.2f}s",
                        severity=events.WARNING, source="llm-router",
                        labels={"projected_ttft_s": f"{projected:.3f}",
                                "slo_ttft_s":
                                    f"{self.core.slo_ttft_s:.3f}",
                                "replica": str(idx)})
                    return {"error": {
                        "code": 429, "type": "overloaded",
                        "message": "projected TTFT "
                                   f"{projected:.2f}s exceeds SLO; "
                                   "retry with backoff"}}
            first_attempt = False
            self.core.start(idx)
            try:
                if self.prefill_replicas:
                    return self._disagg_completions(request, idx,
                                                    token_prompt)
                t0 = time.monotonic()
                resp = self.replicas[idx].call("completions", request)
                self.core.observe_prefill(
                    len(token_prompt), max(time.monotonic() - t0, 1e-6))
                return resp
            except Exception as exc:
                t_fail = time.time()
                outcome = self._handle_request_failure(idx, rid, exc)
                if outcome is not None:
                    return outcome          # re-collected at drain target
                tracing.record_span(
                    "llm:failover_replay", "llm", t_fail, time.time(),
                    request_id=rid, replica=str(idx),
                    error=type(exc).__name__)
                tried.add(idx)
            finally:
                self.core.finish(idx)

    def _cluster_affinity(self, token_prompt: List[int], request: Dict,
                          tried: Set[int]) -> Optional[int]:
        """Map the cluster table's owner hint for this prompt's prefix to a
        routable replica index (replica tags come from engine_stats). None
        on a miss, a dead hint or a store error: the pow2 pick stands."""
        from ray_tpu_torch.llm.prefix_store import cluster_chain

        lora = request.get("lora_name") or ""
        try:
            chain = cluster_chain(token_prompt, self.core.block_size, lora)
            if not chain:
                return None
            hit = self.prefix_store.lookup_owner(chain, lora_id=lora)
        except Exception:
            log.exception("cluster owner lookup failed")
            return None
        if not hit or not hit.get("owner_replica"):
            return None
        with self._stats_lock:
            stats_now = list(self._stats)
        for i, s in enumerate(stats_now):
            if ((s or {}).get("replica") == hit["owner_replica"]
                    and i not in tried and self.core.is_routable(i)):
                # Re-seed the local owner LRU so follow-ups skip the probe.
                self.core._remember(self.core.digest_chain(
                    token_prompt, request.get("lora_name")), i)
                return i
        return None

    def _disagg_completions(self, request: Dict, decode_idx: int,
                            token_prompt: List[int]) -> Dict:
        from ray_tpu_torch.util import tracing

        # Resolved BEFORE the prefill try: a dead decode replica fails
        # here and rides the eject-and-replay path.
        decode_addr = self._handoff_addr(decode_idx)
        t0 = time.monotonic()
        t0_wall = time.time()
        try:
            result = prefill_with_retry(self.prefill_replicas, request,
                                        decode_addr)
        except PrefillTierError as e:
            # Prefill-tier outage: the decode replica never saw this
            # request, so it is not ejected; every prefill replica was
            # already tried. Deterministic app errors are not caught here:
            # prefill_with_retry re-raises them to the client.
            return {"error": {
                "code": 503, "type": "prefill_unavailable",
                "message": f"prefill tier unavailable: {e}"}}
        if not result.get("handoff"):
            return result["response"]  # finished at prefill
        tracing.record_span(
            "llm:prefill_rpc", "llm", t0_wall, time.time(),
            request_id=request["request_id"], tokens=len(token_prompt),
            replica=str(decode_idx))
        self.core.observe_prefill(
            len(token_prompt), max(time.monotonic() - t0, 1e-6))
        return self.replicas[decode_idx].call(
            "completions_collect", result["rid"])

    def _handle_request_failure(self, idx: int, rid: str,
                                exc: BaseException) -> Optional[Dict]:
        """Classify a failed replica call. Returns a response when the
        request completed elsewhere (KV migration re-collect); None means
        the caller replays the request on another replica; application
        errors re-raise to the client untouched."""
        from ray_tpu_torch.runtime import events

        mode = _migrated_mode(exc)
        if mode == "kv":
            # The drain plane moved the live stream, with every token
            # already generated, to the adoptive replica: collect there.
            target = self._drain_target.get(idx)
            if target is not None and self.core.is_healthy(target):
                # The adopted stream is the target's work now: count it in
                # the target's in-flight so pow2 scoring sees it.
                self.core.start(target)
                try:
                    return self.replicas[target].call(
                        "completions_collect", rid)
                except Exception:
                    mode = "replay"  # target died too: replay from prompt
                finally:
                    self.core.finish(target)
            else:
                mode = "replay"
        if mode == "replay" or _is_draining_error(exc):
            # Drain-path fallback: the replica is retiring, not dead. The
            # replay is seeded-identical; no ejection, no failover event
            # (LLM_SESSION_MIGRATED already told the story).
            return None
        if not _is_transport_error(exc):
            # The replica executed the request and raised: it is alive,
            # and ejecting it would let one bad request walk the retry
            # loop through the whole fleet. Propagate.
            raise exc
        # Hard failure: abort the orphan if the replica still answers (a
        # timed-out request must not keep decoding into dead KV pages),
        # then eject and replay on a survivor.
        try:
            self.replicas[idx].call("abort", rid, _timeout=5.0)
        except Exception:
            pass
        self.eject_replica(idx, reason=f"request call failed: {exc!r:.80}")
        self.failovers += 1
        self._m_failovers.inc()
        events.emit(
            events.LLM_REQUEST_FAILOVER,
            f"request {rid} replayed after replica {idx} failed "
            f"({type(exc).__name__}); seeded replay is token-identical",
            severity=events.WARNING, source="llm-router",
            labels={"request_id": rid, "replica": str(idx),
                    "deployment": self.deployment,
                    "error": repr(exc)[:120]})
        return None

    def stats_summary(self) -> Dict:
        return {
            "replicas": self.core.n,
            "healthy_replicas": self.core.healthy_count(),
            "routable_replicas": self.core.routable_count(),
            "prefill_replicas": len(self.prefill_replicas),
            "affinity_hits": self.core.affinity_hits,
            "affinity_misses": self.core.affinity_misses,
            "shed_count": self.core.shed_count,
            "failovers": self.failovers,
            "sessions_migrated": self.migrated_sessions,
            "replicas_ejected": self.core.ejected_count,
        }


class LLMRouter:
    """The serve deployment fronting the LLM fleet (build_routed_app).

    Requests: LLMServer.completions's body plus an optional "session_id".
    Responses: the completion dict, or a 429-shaped {"error": {"code":
    429, ...}} when SLO admission sheds. The routing and resilience logic
    lives in FleetSupervisor/RouterCore; this class resolves the replica
    actor handles, runs the control loop (the drain-plane event watcher
    and the replica policy) and bridges scaling decisions to the
    ServeController."""

    STATS_TTL_S = FleetSupervisor.STATS_TTL_S
    CONTROL_INTERVAL_S = 1.0

    def __init__(self, llm_config, engine_deployment: str,
                 prefill_deployment: Optional[str] = None):
        self.config = llm_config
        self.deployment = engine_deployment
        self._prefill_deployment = prefill_deployment
        # Replica handles resolve on the FIRST REQUEST, not here: this
        # __init__ runs while the controller is still deploying the router
        # itself, so calling back into it (get_replicas) from here would
        # wait on the controller until the deploy times out.
        self.replicas: List[Any] = []
        self.prefill_replicas: List[Any] = []
        self.core: Optional[RouterCore] = None
        self.supervisor: Optional[FleetSupervisor] = None
        self._resolve_lock = threading.Lock()
        self._control_thread: Optional[threading.Thread] = None

    # ---- replica state ---------------------------------------------------

    def _ensure_replicas(self) -> None:
        if self.supervisor is not None:
            return
        with self._resolve_lock:
            if self.supervisor is not None:
                return
            from ray_tpu_torch import serve

            handle = serve.get_deployment_handle(self.deployment)
            self.replicas = [
                ActorReplica(h, name=f"{self.deployment}#{i}")
                for i, h in enumerate(handle.replica_handles())]
            if self._prefill_deployment:
                ph = serve.get_deployment_handle(self._prefill_deployment)
                self.prefill_replicas = [
                    ActorReplica(h, name=f"{self._prefill_deployment}#{i}")
                    for i, h in enumerate(ph.replica_handles())]
            self.core = RouterCore(
                len(self.replicas), block_size=self.config.block_size,
                slo_ttft_s=self.config.slo_ttft_s)
            policy = None
            pol_cfg = getattr(self.config, "replica_policy", None)
            if pol_cfg is not None:
                from ray_tpu_torch.llm.replica_policy import (
                    ReplicaPolicy, ReplicaPolicyConfig)

                if isinstance(pol_cfg, dict):
                    pol_cfg = ReplicaPolicyConfig(**pol_cfg)
                if not isinstance(pol_cfg, ReplicaPolicy):
                    pol_cfg = ReplicaPolicy(pol_cfg)
                policy = pol_cfg
            prefix_store = None
            if self.config.cluster_prefix_store:
                from ray_tpu_torch.llm.prefix_store import ClusterPrefixStore

                store = ClusterPrefixStore(self.config.block_size,
                                           deployment=self.deployment)
                if store.available():
                    prefix_store = store
            # supervisor is the publication barrier: assigned LAST, so a
            # racing reader that sees it non-None sees resolved state too.
            sup = FleetSupervisor(
                self.core, self.replicas, deployment=self.deployment,
                prefill_replicas=self.prefill_replicas, policy=policy,
                scale_up_fn=self._scale_up, retire_fn=self._retire,
                prefix_store=prefix_store)
            self.supervisor = sup
            self._start_control_loop()

    # ---- controller bridge (scale actions) -------------------------------

    def _controller(self):
        from ray_tpu_torch.serve.api import _get_controller

        return _get_controller()

    def _scale_up(self, delta: int) -> None:
        import ray_tpu_torch as rt

        ctrl = self._controller()
        current = len(rt.get(
            ctrl.get_replicas.remote(self.deployment), timeout=60)[
                "replicas"])
        rt.get(ctrl.scale_replicas.remote(
            self.deployment, current + int(delta)), timeout=300)
        self._sync_replicas()

    def _retire(self, idx: int) -> None:
        import ray_tpu_torch as rt

        replica = self.supervisor.replicas[idx]
        key = getattr(replica, "key", None)
        if key is None:
            return
        rt.get(self._controller().remove_replica.remote(
            self.deployment, key), timeout=60)

    def _sync_replicas(self) -> None:
        """Pick up replicas the controller added since resolution: new
        actor ids get fresh router slots (slots are append-only; removed
        replicas keep their dead slot)."""
        from ray_tpu_torch import serve

        sup = self.supervisor
        if sup is None:
            return
        handle = serve.get_deployment_handle(self.deployment)
        known = sup.replica_keys()
        for h in handle.replica_handles():
            r = ActorReplica(h, name=f"{self.deployment}#?")
            if r.key not in known:
                idx = sup.add_replica(r)
                r.name = f"{self.deployment}#{idx}"

    # ---- control loop ----------------------------------------------------

    def _start_control_loop(self) -> None:
        if self._control_thread is not None:
            return
        t = threading.Thread(target=self._control_loop,
                             name="llm-router-control", daemon=True)
        self._control_thread = t
        t.start()

    def _control_loop(self) -> None:
        """Background fleet management: watch the drain plane and run the
        replica policy. Every step is best-effort: the request path never
        depends on this thread."""
        while True:
            time.sleep(self.CONTROL_INTERVAL_S)
            sup = self.supervisor
            if sup is None:
                continue
            try:
                sup.check_events()
            except Exception:
                pass
            try:
                sup.scale_tick()
            except Exception:
                pass
            try:
                self._sync_replicas()
            except Exception:
                pass

    # ---- API -------------------------------------------------------------

    def __call__(self, request: Dict) -> Dict:
        return self.completions(request)

    def completions(self, request: Dict) -> Dict:
        self._ensure_replicas()
        return self.supervisor.completions(request)

    def drain_replica(self, idx: int, *, reason: str = "manual") -> Dict:
        """Operator entry point: drain-migrate one replica now."""
        self._ensure_replicas()
        return self.supervisor.drain_replica(idx, reason=reason)

    def router_stats(self) -> Dict:
        self._ensure_replicas()
        return self.supervisor.stats_summary()
