"""Actor API: ActorClass and ActorHandle.

Reference analog: python/ray/actor.py (ActorClass._remote:893 -> GCS-mediated
creation; ActorHandle method submission via the direct actor transport).
The port's copy of ray_tpu/core/actor.py, with `num_gpus` where the JAX
package has `num_tpus`; `runtime_env` and `bind` (the DAG API) are not
ported and refuse.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.core.exceptions import _unported
from ray_tpu_torch.core.task_spec import ActorSpec
from ray_tpu_torch.runtime.resources import whole_gpus
from ray_tpu_torch.runtime.scheduling import PlacementGroupStrategy
from ray_tpu_torch.utils.ids import ActorID


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1):
        return ActorMethod(self._handle, self._method_name, num_returns)

    def remote(self, *args, **kwargs):
        core = worker_mod.global_worker()
        refs = core.submit_actor_task(
            self._handle._actor_id, self._method_name, args, kwargs,
            num_returns=self._num_returns,
            name=f"{self._handle._class_name}.{self._method_name}",
            max_task_retries=self._handle._max_task_retries)
        if self._num_returns in (1, "streaming"):
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """The DAG API (the JAX package's dag.node.ClassMethodNode)."""
        raise _unported("the DAG API (bind)")

    def __call__(self, *args, **kwargs):
        raise TypeError("Actor methods cannot be called directly; use .remote()")


class ActorHandle:
    def __init__(self, actor_id: bytes, class_name: str, max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name, self._max_task_retries))


class ActorClass:
    # Default num_cpus=0 matches the reference: an actor's lifetime holds no
    # CPU (only explicit num_cpus/num_gpus reservations pin resources).
    def __init__(self, cls, *, num_cpus: float = 0.0, num_gpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None, max_restarts: int = 0,
                 max_task_retries: int = 0, max_concurrency: int = 1,
                 name: Optional[str] = None, namespace: str = "default",
                 lifetime: Optional[str] = None, scheduling_strategy=None,
                 runtime_env: Optional[dict] = None):
        if runtime_env:
            raise _unported("runtime_env")
        self._cls = cls
        self._num_cpus = num_cpus
        self._num_gpus = whole_gpus(num_gpus)
        self._resources = dict(resources or {})
        self._max_restarts = max_restarts
        self._max_task_retries = max_task_retries
        self._max_concurrency = max_concurrency
        self._name = name
        self._namespace = namespace
        self._lifetime = lifetime
        self._scheduling_strategy = scheduling_strategy

    def options(self, **overrides) -> "ActorClass":
        kw = dict(num_cpus=self._num_cpus, num_gpus=self._num_gpus,
                  resources=dict(self._resources), max_restarts=self._max_restarts,
                  max_task_retries=self._max_task_retries,
                  max_concurrency=self._max_concurrency, name=self._name,
                  namespace=self._namespace, lifetime=self._lifetime,
                  scheduling_strategy=self._scheduling_strategy)
        kw.update(overrides)
        return ActorClass(self._cls, **kw)

    def _resource_demand(self) -> Dict[str, float]:
        demand = dict(self._resources)
        if self._num_cpus:
            demand["CPU"] = float(self._num_cpus)
        if self._num_gpus:
            demand["GPU"] = self._num_gpus
        return demand

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = worker_mod.global_worker()
        class_id = core.register_class(self._cls)
        ser_args, names, pins = core.serialize_args(args, kwargs)
        core.pin_args(pins)
        pg_id, bundle_index = None, -1
        strategy = self._scheduling_strategy
        if isinstance(strategy, PlacementGroupStrategy):
            pg_id = strategy.placement_group.id.binary()
            bundle_index = strategy.bundle_index
        spec = ActorSpec(
            actor_id=ActorID.generate().binary(),
            class_id=class_id, name=self._name,
            class_name=self._cls.__name__, args=ser_args, kwarg_names=names,
            resources=self._resource_demand(), max_restarts=self._max_restarts,
            max_task_retries=self._max_task_retries,
            max_concurrency=self._max_concurrency,
            scheduling_strategy=strategy, placement_group_id=pg_id,
            placement_group_bundle_index=bundle_index, namespace=self._namespace)
        try:
            reply = core.create_actor(spec)
        except BaseException:
            core.unpin_args(pins)
            raise
        if not reply.get("ok"):
            core.unpin_args(pins)
            raise RuntimeError(f"actor creation failed: {reply.get('error')}")
        if pins:
            core.io.spawn(_unpin_once_created(core, spec.actor_id, pins))
        return ActorHandle(spec.actor_id, self._cls.__name__, self._max_task_retries)

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor class {self._cls.__name__} cannot be instantiated "
                        "directly; use .remote()")


async def _unpin_once_created(core, actor_id: bytes, pins) -> None:
    """Creation is asynchronous (the GCS replies once the actor is
    registered): the constructor's ref arguments stay pinned until the
    actor has left PENDING_CREATION, i.e. its __init__ has read them or
    the creation failed."""
    import asyncio

    try:
        while True:
            info = await core.gcs.call("get_actor", actor_id=actor_id)
            if info.get("state") != "PENDING_CREATION":
                return
            await asyncio.sleep(0.1)
    finally:
        core.unpin_args(pins)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    core = worker_mod.global_worker()
    info = core.get_actor_info(name=name, namespace=namespace)
    if not info.get("found") or info["state"] == "DEAD":
        raise ValueError(f"no live actor named {name!r}")
    return ActorHandle(info["actor_id"], info["class_name"])
