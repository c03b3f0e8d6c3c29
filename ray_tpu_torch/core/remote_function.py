"""@ray_tpu_torch.remote functions.

Reference analog: python/ray/remote_function.py (RemoteFunction._remote:303).
The port's copy of ray_tpu/core/remote_function.py, with `num_gpus` where
the JAX package has `num_tpus`; `runtime_env` and `bind` (the DAG API)
are not ported and refuse.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.core.exceptions import _unported
from ray_tpu_torch.runtime.resources import whole_gpus
from ray_tpu_torch.runtime.scheduling import PlacementGroupStrategy

DEFAULT_MAX_RETRIES = 3


class RemoteFunction:
    def __init__(self, fn, *, num_returns: int = 1, num_cpus: float = 1.0,
                 num_gpus: float = 0.0, resources: Optional[Dict[str, float]] = None,
                 max_retries: int = DEFAULT_MAX_RETRIES, scheduling_strategy=None,
                 runtime_env: Optional[dict] = None):
        if runtime_env:
            raise _unported("runtime_env")
        self._fn = fn
        self._num_returns = num_returns
        self._num_cpus = num_cpus
        self._num_gpus = whole_gpus(num_gpus)
        self._resources = dict(resources or {})
        self._max_retries = max_retries
        self._scheduling_strategy = scheduling_strategy
        functools.update_wrapper(self, fn)

    def options(self, **overrides) -> "RemoteFunction":
        kw = dict(
            num_returns=self._num_returns, num_cpus=self._num_cpus,
            num_gpus=self._num_gpus, resources=dict(self._resources),
            max_retries=self._max_retries,
            scheduling_strategy=self._scheduling_strategy)
        kw.update(overrides)
        return RemoteFunction(self._fn, **kw)

    def _resource_demand(self) -> Dict[str, float]:
        demand = dict(self._resources)
        if self._num_cpus:
            demand["CPU"] = float(self._num_cpus)
        if self._num_gpus:
            demand["GPU"] = self._num_gpus
        return demand

    def remote(self, *args, **kwargs):
        core = worker_mod.global_worker()
        pg_id, bundle_index = None, -1
        strategy = self._scheduling_strategy
        if isinstance(strategy, PlacementGroupStrategy):
            pg_id = strategy.placement_group.id.binary()
            bundle_index = strategy.bundle_index
        refs = core.submit_task(
            self._fn, args, kwargs,
            name=getattr(self._fn, "__qualname__", str(self._fn)),
            num_returns=self._num_returns,
            resources=self._resource_demand(),
            max_retries=self._max_retries,
            scheduling_strategy=strategy,
            placement_group_id=pg_id, bundle_index=bundle_index)
        if self._num_returns in (1, "streaming"):
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """The DAG API (the JAX package's dag.node.FunctionNode)."""
        raise _unported("the DAG API (bind)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._fn, '__name__', '?')}' cannot be called "
            "directly; use .remote() (or access the original via __wrapped__).")
