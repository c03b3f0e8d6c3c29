"""The port's actor runtime (its copy of ray_tpu/runtime/): the typed
wire codec, RPC with its auth challenge and fault injection, resources
and accelerators (GPU first), scheduling, the shared-memory object store,
the GCS, the raylet, node bootstrap and the worker process."""
