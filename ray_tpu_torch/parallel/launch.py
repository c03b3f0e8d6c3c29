"""Start a world of ranks on one host (the CPU tests' gloo helper, and
the multi-card leg of chip_smoke.py on NCCL).

    from ray_tpu_torch.parallel.launch import spawn
    results = spawn(fn, 4, arg, device="cpu")   # fn(rank, world, arg)

Each rank is a fresh process (`spawn` start method) that joins the
default process group through a FileStore in a temporary directory, so
no TCP port is needed. CUDA ranks take card `rank` and NCCL; CPU ranks
take gloo and one thread each. `fn` must be importable by name (a module
function) and return something picklable. Under torchrun, call
`torch.distributed.init_process_group` instead and skip this module.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_rank(rank: int, world: int, store_path: str, device: str = "cuda",
              timeout_s: float = 120.0) -> None:
    """Join the default process group: NCCL on card `rank` for "cuda",
    gloo for "cpu". Raises on a CUDA request without a card."""
    from ray_tpu_torch.ops import resolve_device

    dev = resolve_device(device)
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(store_path, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def _entry(fn, rank, world, store_path, device, results, args):
    try:
        init_rank(rank, world, store_path, device)
        results.put((rank, True, fn(rank, world, *args)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device: str = "cuda",
          timeout: float = 300.0) -> List:
    """Run fn(rank, world, *args) on `world` ranks; returns the results in
    rank order. Raises RuntimeError with the tracebacks when a rank fails
    or dies, and TimeoutError after `timeout` seconds; either way every
    rank is killed before it returns."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_world_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_entry, daemon=True,
                             args=(fn, r, world, os.path.join(tmp, "store"),
                                   device, results, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, failed = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"{world} ranks: no result from ranks "
                                       f"{missing} after {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        failed.append(f"ranks {dead} exited without a "
                                      f"result")
                    continue
                got[rank] = value
                if not ok:
                    failed.append(f"rank {rank}:\n{value}")
        finally:
            for p in procs:   # let finished ranks leave their group first
                p.join(timeout=30 if len(got) == world and not failed
                       else 0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [got[r] for r in range(world)]
