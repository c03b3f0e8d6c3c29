"""Public API: init/shutdown/remote/get/put/wait/kill.

Reference analog: python/ray/_private/worker.py (init:1285, shutdown:1894,
get:2645, put:2813, wait:2878, remote:3266). The port's copy of
ray_tpu/core/api.py, with `num_gpus` where the JAX package has
`num_tpus`. The runtime_env option, the dashboard, usage stats and the
driver log stream are not ported: the first two refuse.
"""

from __future__ import annotations

import asyncio
import atexit
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.core.actor import ActorClass, get_actor  # noqa: F401
from ray_tpu_torch.core.exceptions import _unported
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.worker import CoreWorker
from ray_tpu_torch.runtime import node as node_mod
from ray_tpu_torch.runtime import resources as resources_mod

_head: Optional[node_mod.NodeProcesses] = None


def init(address: Optional[str] = None, *, num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         labels: Optional[Dict[str, str]] = None,
         worker_env: Optional[Dict[str, str]] = None,
         runtime_env: Optional[dict] = None,
         include_dashboard: Optional[bool] = None,
         dashboard_port: int = 0,
         ignore_reinit_error: bool = False,
         remote_client: bool = False,
         _system_config: Optional[Dict[str, Any]] = None) -> "RuntimeContext":
    """Start a local cluster (default) or connect to an existing one
    (address="host:port" of its GCS, or the RAY_TPU_TORCH_ADDRESS env var set by
    the job-submission entrypoint runner). `_system_config` overrides entries
    of the central config table (ray_tpu_torch/config.py, the ray_config_def.h
    analog); the cluster's processes get them as RAY_TPU_TORCH_* variables
    in their environment at spawn. `num_gpus` defaults to the cards the
    node has (runtime/accelerators.py)."""
    global _head
    if runtime_env:
        raise _unported("runtime_env")
    if include_dashboard:
        raise _unported("the dashboard")
    if worker_mod.is_initialized():
        if ignore_reinit_error:
            return RuntimeContext()
        raise RuntimeError("ray_tpu_torch.init() already called (use ignore_reinit_error)")
    from ray_tpu_torch.config import cfg

    child_env: Dict[str, str] = {}
    if _system_config:
        cfg().apply_overrides(_system_config)
        for k, v in _system_config.items():
            child_env[f"RAY_TPU_TORCH_{k.upper()}"] = str(v)
    if object_store_memory is None:
        object_store_memory = cfg().object_store_memory_default

    if address is None:
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
    if address == "auto":
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if address is None:
            raise RuntimeError(
                'init(address="auto") but RAY_TPU_TORCH_ADDRESS is not set')
    if address is None:
        session_dir = node_mod.new_session_dir()
        processes = node_mod.NodeProcesses(session_dir)
        child_env["RAY_TPU_TORCH_AUTH_TOKEN"] = node_mod.ensure_auth_token(
            session_dir)
        processes.gcs_proc, processes.gcs_address = node_mod.start_gcs(
            session_dir, child_env)
        # Workers must resolve by-reference pickles (module-level functions/
        # classes) against the driver's import paths (runtime_env working_dir
        # equivalent for the local-cluster case).
        import sys as _sys
        driver_path = ":".join(p for p in _sys.path if p)
        worker_env = dict(worker_env or {})
        worker_env.setdefault(
            "PYTHONPATH",
            driver_path + ":" + os.environ.get("PYTHONPATH", ""))
        res = resources_mod.node_resources(num_cpus, num_gpus, None, resources)
        processes.raylet_proc, info = node_mod.start_raylet(
            session_dir, processes.gcs_address, res, dict(labels or {}),
            object_store_memory, child_env, is_head=True,
            worker_env=worker_env)
        processes.node_id = bytes.fromhex(info["node_id"])
        processes.raylet_address = tuple(info["address"])
        processes.store_path = info["store_path"]
        _head = processes
        core = CoreWorker(
            mode="driver", gcs_address=processes.gcs_address,
            raylet_address=processes.raylet_address,
            store_path=processes.store_path, session_dir=session_dir,
            node_id=processes.node_id)
    else:
        host, port = address.rsplit(":", 1)
        gcs_address = (host, int(port))
        # Connect-only mode: pick the head (or first) node's raylet as local.
        import asyncio

        from ray_tpu_torch.runtime import rpc as rpc_mod
        from ray_tpu_torch.runtime.rpc import RpcClient

        # Resolve the auth token by the address being attached to (NOT
        # session_latest, which mis-resolves with two clusters on one host).
        rpc_mod.load_token_for_address(host, int(port))

        async def _discover():
            client = RpcClient(*gcs_address)
            await client.connect(timeout=30)
            nodes = await client.call("get_nodes")
            await client.close()
            return nodes

        loop = asyncio.new_event_loop()
        try:
            nodes = loop.run_until_complete(_discover())
        finally:
            loop.close()
        if not nodes:
            raise RuntimeError(f"no nodes registered at GCS {address}")
        head = next((n for n in nodes if n["is_head"]), nodes[0])
        # Ray-Client analog (util/client/): a remote driver attaches with NO
        # local store — put() streams into the head node's store over RPC,
        # get() pulls chunks back. Auto-detected when the store path isn't
        # visible (different machine), or forced with remote_client=True.
        store_path = head["object_store_path"]
        if remote_client or not os.path.exists(store_path):
            store_path = None
        core = CoreWorker(
            mode="driver", gcs_address=gcs_address,
            raylet_address=tuple(head["address"]),
            store_path=store_path,
            session_dir=os.path.dirname(head["object_store_path"]),
            node_id=head["node_id"])
    # An auto-started cluster (_head set above) dies with this driver: the
    # GCS tears everything down when the owning connection drops, so a
    # SIGKILLed driver can't leak GCS/raylet/worker processes. The token
    # makes registration idempotent under auto_reconnect retries; the
    # keepalive loop re-claims the job after transparent reconnects even
    # when the driver is otherwise idle (no other GCS traffic would redial).
    import uuid as _uuid

    owns_cluster = _head is not None
    job_token = _uuid.uuid4().hex
    core.job_id = core.io.run(core.gcs.call(
        "register_job", owns_cluster=owns_cluster, token=job_token))["job_id"]

    async def _reclaim_job(client):
        await client.call("claim_job", job_id=core.job_id,
                          owns_cluster=owns_cluster)

    core.gcs.on_reconnect = _reclaim_job

    async def _job_keepalive():
        from ray_tpu_torch.config import cfg as _cfg

        while True:
            await asyncio.sleep(_cfg().job_keepalive_interval_s)
            try:
                await core.gcs.call("claim_job", job_id=core.job_id,
                                    owns_cluster=owns_cluster, timeout=10)
            except Exception:
                pass  # reconnect path retries on the next tick

    if owns_cluster:
        core._job_keepalive_task = core.io.spawn(_job_keepalive())
    worker_mod.set_global_worker(core)
    atexit.register(_atexit_shutdown)
    return RuntimeContext()


def _atexit_shutdown():
    try:
        if worker_mod.is_initialized():
            shutdown()
    except Exception:
        pass


def shutdown():
    global _head
    if worker_mod.is_initialized():
        core = worker_mod.global_worker()
        core.shutdown(kill_cluster=_head is not None)
        worker_mod.set_global_worker(None)
    if _head is not None:
        for proc in (_head.raylet_proc, _head.gcs_proc):
            if proc is not None:
                try:
                    proc.wait(timeout=5)
                except Exception:
                    try:
                        proc.kill()
                    except Exception:
                        pass
        _head = None


def is_initialized() -> bool:
    return worker_mod.is_initialized()


def remote(*args, **kwargs):
    """@remote decorator for functions and classes, with or without options."""
    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)

    def decorator(target):
        if isinstance(target, type):
            allowed = {"num_cpus", "num_gpus", "resources", "max_restarts",
                       "max_task_retries", "max_concurrency", "name", "namespace",
                       "lifetime", "scheduling_strategy", "runtime_env"}
            opts = {k: v for k, v in kwargs.items() if k in allowed}
            return ActorClass(target, **opts)
        allowed = {"num_returns", "num_cpus", "num_gpus", "resources",
                   "max_retries", "scheduling_strategy", "runtime_env"}
        opts = {k: v for k, v in kwargs.items() if k in allowed}
        return RemoteFunction(target, **opts)

    return decorator


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    core = worker_mod.global_worker()
    if isinstance(refs, ObjectRef):
        return core.get_one(refs, timeout)
    return core.get(list(refs), timeout)


def put(value: Any) -> ObjectRef:
    return worker_mod.global_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    return worker_mod.global_worker().wait(refs, num_returns, timeout)


def kill(actor_handle, *, no_restart: bool = True):
    worker_mod.global_worker().kill_actor(actor_handle._actor_id, no_restart)


def free(refs):
    """Eagerly delete the objects' data everywhere (ray.internal.free
    analog). The refs become unreadable; lineage is dropped too."""
    worker_mod.global_worker().free(refs)


def cancel(ref, *, force: bool = False, recursive: bool = False) -> bool:
    """Cancel the task producing `ref` (ray.cancel analog). Queued tasks
    fail immediately; running tasks get a best-effort interrupt
    (force=True kills the worker process). get() on the ref raises
    TaskCancelledError. Returns False if the task already finished."""
    return worker_mod.global_worker().cancel(ref, force=force,
                                             recursive=recursive)


class RuntimeContext:
    @property
    def gcs_address(self) -> Optional[str]:
        core = worker_mod.global_worker()
        return f"{core.gcs.host}:{core.gcs.port}"

    @property
    def node_id(self):
        return worker_mod.global_worker().node_id

    @property
    def session_dir(self):
        return worker_mod.global_worker().session_dir

    @property
    def current_actor_id(self):
        return worker_mod.global_worker().current_actor_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()


def nodes() -> List[dict]:
    core = worker_mod.global_worker()
    return core.io.run(core.gcs.call("get_nodes"))


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        for k, v in n["resources"].items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        for k, v in n["available"].items():
            total[k] = total.get(k, 0.0) + v
    return total
