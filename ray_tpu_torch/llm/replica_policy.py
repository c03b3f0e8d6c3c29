"""Telemetry-driven replica-count policy for the LLM serving fleet.

The port's copy of ray_tpu/llm/replica_policy.py: the same decisions on
the same engine_stats() payloads.

A generic deployment autoscaler scales on queue
length at the replica actors — the right signal for stateless RPC apps,
and the wrong one for LLM serving, where the binding resources are KV
cache pages and prefill compute: a fleet can show short actor queues
while every engine is one admission away from evicting reusable prefixes,
or deep prefill backlogs that the actor queue never sees (requests sit
INSIDE the engine's waiting queue, not in the mailbox).

This policy consumes what the router already collects — the per-replica
engine_stats() payloads — and turns two signals into a desired count:

  * **Queue delay**: total queued prefill tokens across the fleet divided
    by aggregate measured prefill throughput = seconds of prefill work a
    new request waits behind. Over `queue_delay_high_s` -> add a replica
    (before SLO admission starts shedding); prefill throughput unknown ->
    fall back on mean engine queue depth vs `queue_depth_high`.
  * **KV pressure**: mean fraction of KV pages in use. Over
    `kv_pressure_high` -> add a replica (an engine past ~85% occupancy
    is cannibalizing its own prefix cache to admit).

Scale-down is deliberately sticky: BOTH signals must sit below their low
watermarks continuously for `scale_down_quiet_s` (any busy sample resets
the clock), and then the fleet shrinks by ONE replica. The asymmetry is
intentional — upscale errors cost money for minutes, downscale errors
cost live sessions a migration each — and the router retires the victim
through the drain plane (drain -> migrate sessions -> remap affinity ->
kill), never by killing a loaded replica.

Pure and cluster-free (desired(stats, current, now) -> int) so unit tests
drive it with synthetic stats and explicit clocks; a router's control
loop owns the real feed (the JAX package's LLMRouter; the port's waits
for an actor runtime).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class ReplicaPolicyConfig:
    """Watermarks for the LLM replica policy (see module docstring)."""

    min_replicas: int = 1
    max_replicas: int = 8
    # Seconds of queued prefill work behind which a new request waits.
    queue_delay_high_s: float = 2.0
    queue_delay_low_s: float = 0.25
    # Fallback when no prefill-throughput signal exists yet: mean engine
    # queue depth (waiting + prefilling) per replica.
    queue_depth_high: float = 4.0
    queue_depth_low: float = 0.5
    # Mean fraction of KV pages in use across the fleet.
    kv_pressure_high: float = 0.85
    kv_pressure_low: float = 0.50
    # Both signals must stay below the low watermarks this long before a
    # scale-down fires (busy samples reset the clock).
    scale_down_quiet_s: float = 30.0
    # At most one step per direction per this interval (lets a freshly
    # added replica absorb load before the policy reads the fleet again).
    cooldown_s: float = 10.0
    # Windowed-input mode: > 0 means watermark tests run against the mean
    # of the signals over this many trailing seconds instead of the
    # instantaneous tick, so a single-tick spike (one burst of queued
    # prefill tokens, one transient KV high-water) cannot trigger an
    # upscale by itself. 0 keeps the original instantaneous behaviour.
    signal_window_s: float = 0.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.signal_window_s < 0:
            raise ValueError("signal_window_s must be >= 0")


class ReplicaPolicy:
    """Stateful wrapper: config + the quiet/cooldown clocks."""

    def __init__(self, config: Optional[ReplicaPolicyConfig] = None):
        self.config = config or ReplicaPolicyConfig()
        self._quiet_since: Optional[float] = None
        self._last_action_t: Optional[float] = None
        # (t, signals) samples for windowed-input mode; trimmed each tick.
        self._samples: List = []

    # ---- signal extraction ----------------------------------------------

    @staticmethod
    def signals(stats: Sequence[Optional[Dict]]) -> Dict[str, float]:
        """Fleet-level (queue_delay_s, queue_depth, kv_pressure) from the
        per-replica engine_stats payloads; replicas with no fresh stats
        (probe failed this tick) contribute nothing."""
        live = [s for s in stats if s]
        if not live:
            return {"queue_delay_s": 0.0, "queue_depth": 0.0,
                    "kv_pressure": 0.0, "live": 0}
        queued_tokens = sum(s.get("queued_prefill_tokens", 0) for s in live)
        # tokens_per_s is the decode EWMA; prefill throughput rides under
        # its own key when a replica measured one. Either way, treat the
        # aggregate as the fleet's drain rate; zero means "unknown".
        tps = sum(s.get("prefill_tokens_per_s") or s.get("tokens_per_s") or 0
                  for s in live)
        depth = sum(s.get("waiting", 0) + s.get("prefilling", 0)
                    for s in live) / len(live)
        utils = []
        for s in live:
            total = s.get("total_kv_blocks", 0)
            if total:
                utils.append(1.0 - s.get("free_kv_blocks", 0) / total)
        return {
            "queue_delay_s": (queued_tokens / tps) if tps > 0 else -1.0,
            "queue_depth": depth,
            "kv_pressure": sum(utils) / len(utils) if utils else 0.0,
            "live": len(live),
        }

    def _windowed(self, sig: Dict[str, float], now: float) -> Dict[str, float]:
        """Fold this tick's signals into the sample window and return the
        window means. Unknown queue delays (-1) are excluded from the delay
        mean; the result is -1 only when NO sample in the window knew it."""
        w = self.config.signal_window_s
        self._samples.append((now, sig))
        self._samples = [(t, s) for t, s in self._samples if now - t <= w]
        samples = [s for _, s in self._samples]
        delays = [s["queue_delay_s"] for s in samples
                  if s["queue_delay_s"] >= 0]
        return {
            "queue_delay_s": (sum(delays) / len(delays)) if delays else -1.0,
            "queue_depth": sum(s["queue_depth"] for s in samples)
            / len(samples),
            "kv_pressure": sum(s["kv_pressure"] for s in samples)
            / len(samples),
            "live": sig["live"],
        }

    # ---- the decision ----------------------------------------------------

    def desired(self, stats: Sequence[Optional[Dict]], current: int,
                now: float) -> int:
        """Desired replica count given this tick's fleet stats. Returns
        `current` (no-op) outside the cooldown window or when neither
        watermark trips."""
        cfg = self.config
        if current < cfg.min_replicas:
            return cfg.min_replicas
        sig = self.signals(stats)
        if sig["live"] == 0:
            return current  # blind tick: never act on no data
        if cfg.signal_window_s > 0:
            sig = self._windowed(sig, now)
        delay = sig["queue_delay_s"]
        hot = (sig["kv_pressure"] > cfg.kv_pressure_high
               or (delay >= 0 and delay > cfg.queue_delay_high_s)
               or (delay < 0 and sig["queue_depth"] > cfg.queue_depth_high))
        quiet = (sig["kv_pressure"] < cfg.kv_pressure_low
                 and ((delay >= 0 and delay < cfg.queue_delay_low_s)
                      or (delay < 0
                          and sig["queue_depth"] < cfg.queue_depth_low)))
        if not quiet:
            self._quiet_since = None
        elif self._quiet_since is None:
            self._quiet_since = now
        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t < cfg.cooldown_s)
        if hot and current < cfg.max_replicas and not in_cooldown:
            self._quiet_since = None
            self._last_action_t = now
            return current + 1
        if (quiet and current > cfg.min_replicas and not in_cooldown
                and self._quiet_since is not None
                and now - self._quiet_since >= cfg.scale_down_quiet_s):
            self._last_action_t = now
            self._quiet_since = now  # the next step needs its own quiet run
            return current - 1
        return current
