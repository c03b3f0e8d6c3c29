"""Model multiplexing: many models (e.g. LoRA adapters) per replica with
LRU residency.

The port's copy of ray_tpu/serve/multiplex.py (reference analog:
python/ray/serve/multiplex.py, _ModelMultiplexWrapper, @serve.multiplexed
+ get_multiplexed_model_id). A replica holds up to
``max_num_models_per_replica`` loaded models; requests route by model id,
loading on miss and evicting the least recently used (device memory is
the scarce resource: evicted model weights free it for the next
adapter).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Optional

__all__ = ["Multiplexer", "multiplexed"]

_current_model_id = threading.local()


def get_multiplexed_model_id() -> Optional[str]:
    """Inside a model loader or request handler: the model id being served."""
    return getattr(_current_model_id, "value", None)


class Multiplexer:
    """LRU cache of loaded models keyed by model id."""

    def __init__(self, load_fn: Callable[[str], Any],
                 max_num_models: int = 3,
                 unload_fn: Optional[Callable[[Any], None]] = None):
        self.load_fn = load_fn
        self.unload_fn = unload_fn
        self.max_num_models = max_num_models
        self._models: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.load_count = 0
        self.evict_count = 0

    def get_model(self, model_id: str) -> Any:
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        # Load outside the lock (device transfers are slow). If another
        # thread loaded the same id while we did, keep the existing entry
        # and unload our duplicate — dropping it silently would leak the
        # device/HBM memory multiplexing exists to manage.
        prev = getattr(_current_model_id, "value", None)
        _current_model_id.value = model_id
        try:
            model = self.load_fn(model_id)
        finally:
            _current_model_id.value = prev
        evicted = []
        duplicate = None
        with self._lock:
            if model_id in self._models:
                duplicate, model = model, self._models[model_id]
                self._models.move_to_end(model_id)
            else:
                self._models[model_id] = model
                self.load_count += 1
                if len(self._models) > self.max_num_models:
                    evicted.append(self._models.popitem(last=False)[1])
                    self.evict_count += 1
        if self.unload_fn is not None:
            for m in evicted:
                self.unload_fn(m)
            if duplicate is not None:
                self.unload_fn(duplicate)
        return model

    def loaded_model_ids(self):
        with self._lock:
            return list(self._models)

    def __call__(self, model_id: str, request: Any,
                 handler: Callable[[Any, Any], Any]) -> Any:
        model = self.get_model(model_id)
        prev = getattr(_current_model_id, "value", None)
        _current_model_id.value = model_id
        try:
            return handler(model, request)
        finally:
            _current_model_id.value = prev


def multiplexed(*, max_num_models_per_replica: int = 3,
                unload_fn: Optional[Callable[[Any], None]] = None):
    """Decorator for a model-loader method; the wrapped loader becomes an
    LRU-cached ``loader(model_id) -> model``:

        class Replica:
            @multiplexed(max_num_models_per_replica=4)
            def get_model(self, model_id: str):
                return load_lora(model_id)

            def predict(self, model_id, x):
                return self.get_model(model_id)(x)
    """

    def decorate(fn: Callable):
        attr = f"__multiplexer_{fn.__name__}"

        def wrapper(self, model_id: str):
            mux = getattr(self, attr, None)
            if mux is None:
                mux = Multiplexer(lambda mid: fn(self, mid),
                                  max_num_models_per_replica, unload_fn)
                setattr(self, attr, mux)
            return mux.get_model(model_id)

        wrapper.__name__ = fn.__name__
        return wrapper

    return decorate
