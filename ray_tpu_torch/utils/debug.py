"""Process-debugging helpers shared by the runtime entry points."""

from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Dict, List, Optional


def register_stack_dump_signal() -> None:
    """SIGUSR1 dumps every thread's stack to stderr — the first tool for
    diagnosing a hung GCS/raylet/worker without restarting it (the stderr
    of runtime processes lands in the session's per-process log file)."""
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)


def render_stacks(label: str = "") -> dict:
    """Snapshot every thread's stack, annotated with blocked-on context.

    The structured (JSON-able) analog of faulthandler's SIGUSR1 dump:
    `sys._current_frames()` plus, per thread, the live blocked-on record
    from `core.blocked` (what the thread is waiting for — object get,
    collective op, channel read) and the task/actor the thread is
    executing. This is what the `dump_stacks` RPC returns and what
    `scripts stack --cluster` / dashboard `/api/stacks` render.
    """
    from ray_tpu_torch.core import blocked as blocked_mod

    threads_by_ident = {t.ident: t for t in threading.enumerate()}
    blocked = blocked_mod.snapshot()
    out = []
    # The snapshot contains this thread's own frame (a cycle) and keeps any
    # concurrently-returning frame alive with its locals until collected —
    # enough to pin channel buffers and wedge a ring writer. clear() drops
    # every frame ref the moment rendering is done.
    frames = sys._current_frames()
    try:
        for ident, frame in frames.items():
            t = threads_by_ident.get(ident)
            rec = {
                "ident": ident,
                "name": t.name if t else f"thread-{ident}",
                "daemon": bool(t.daemon) if t else False,
                "frames": [ln.rstrip("\n")
                           for ln in traceback.format_stack(frame)],
            }
            b = blocked.get(ident)
            if b:
                rec["blocked_on"] = b
            ctx = blocked_mod.task_context(ident)
            if ctx:
                rec["task"] = ctx
            out.append(rec)
        frame = None
    finally:
        frames.clear()
    return {"pid": os.getpid(), "label": label, "threads": out}


def _describe_blocked(b: dict) -> str:
    import time as _time

    kind = b.get("kind", "?")
    d = b.get("detail", {})
    age = _time.time() - b.get("since", _time.time())
    if kind == "object_get":
        parts = [f"object {d.get('oid', '?')}"]
        if d.get("owner"):
            parts.append(f"owner {d['owner']}")
        if d.get("target_name"):
            parts.append(f"result of {d['target_name']!r}")
        if d.get("target_actor"):
            parts.append(f"actor {d['target_actor']}")
        what = ", ".join(parts)
        return f"blocked on get({what}) for {age:.1f}s"
    if kind == "collective_op":
        return (f"blocked in collective group {d.get('group', '?')!r} "
                f"op #{d.get('op_id', '?')} "
                f"(rank {d.get('rank', '?')}/{d.get('world_size', '?')}) "
                f"for {age:.1f}s")
    if kind == "channel_read":
        return (f"blocked on channel {d.get('channel', '?')} read "
                f"(version {d.get('version', '?')}) for {age:.1f}s")
    return f"blocked on {kind} for {age:.1f}s"


def format_stacks(processes: List[dict], dedupe: bool = True) -> str:
    """Render `render_stacks()` results as text, deduping identical stacks.

    Idle pool threads all parked on the same `wait()` line are the noise
    of a stack dump; grouping by (frames, blocked-on description) keeps
    the one-screen signal. Blocked/task-annotated threads sort first.
    """
    lines: List[str] = []
    for proc in processes:
        label = proc.get("label") or f"pid {proc.get('pid')}"
        lines.append(f"=== {label} (pid {proc.get('pid')}) ===")
        groups: Dict[tuple, dict] = {}
        for t in proc.get("threads", []):
            desc = _describe_blocked(t["blocked_on"]) \
                if t.get("blocked_on") else ""
            key = (tuple(t.get("frames", ())), desc) if dedupe \
                else (t["ident"],)
            g = groups.setdefault(key, {"threads": [], "t": t,
                                        "desc": desc})
            g["threads"].append(t)
        ordered = sorted(
            groups.values(),
            key=lambda g: (0 if g["desc"] else (1 if g["t"].get("task")
                                                else 2)))
        for g in ordered:
            t = g["t"]
            names = ", ".join(x["name"] for x in g["threads"][:4])
            extra = len(g["threads"]) - 4
            if extra > 0:
                names += f", +{extra} more"
            header = f"-- thread {names}"
            task = t.get("task")
            if task:
                who = task.get("name") or task.get("task_id")
                header += f" [running {who}"
                if task.get("actor_id"):
                    header += f" on actor {task['actor_id']}"
                header += "]"
            lines.append(header)
            if g["desc"]:
                lines.append(f"   {g['desc']}")
            for fr in t.get("frames", []):
                lines.append("  " + fr.replace("\n", "\n  "))
        lines.append("")
    return "\n".join(lines)
