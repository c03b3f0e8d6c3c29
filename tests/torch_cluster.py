"""One port cluster for a test module (shared by the port's cluster tests).

`port_cluster` starts the port's runtime with fake GPUs and, however the
module ends, tears down in order: `before_shutdown` (serve.shutdown for a
Serve module), `rt.shutdown()`, a SIGKILL of every process of the session
that is still alive, and the unlinking of the session's shared-memory
store. This module imports only the port.
"""

import contextlib
import os
import signal

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import session_pids


@contextlib.contextmanager
def port_cluster(fake_gpus: int = 2, before_shutdown=None, **init_kw):
    """rt.init(**init_kw) with RAY_TPU_TORCH_FAKE_GPUS=fake_gpus; yields
    the session directory."""
    from ray_tpu_torch.core import api

    old = os.environ.get("RAY_TPU_TORCH_FAKE_GPUS")
    os.environ["RAY_TPU_TORCH_FAKE_GPUS"] = str(fake_gpus)
    session_dir = store_path = None
    try:
        rt.init(**init_kw)
        session_dir = rt.get_runtime_context().session_dir
        store_path = api._head.store_path
        yield session_dir
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_TORCH_FAKE_GPUS", None)
        else:
            os.environ["RAY_TPU_TORCH_FAKE_GPUS"] = old
        try:
            if before_shutdown is not None and session_dir is not None:
                before_shutdown()
        finally:
            try:
                rt.shutdown()
            finally:
                if session_dir is not None:
                    for pid in session_pids(session_dir):
                        try:
                            os.kill(pid, signal.SIGKILL)
                        except OSError:
                            pass
                if store_path is not None and os.path.exists(store_path):
                    os.unlink(store_path)
