from ray_tpu_torch.runtime.object_store.store import (  # noqa: F401
    ObjectStore,
    StoreFullError,
    ObjectNotFoundError,
)
