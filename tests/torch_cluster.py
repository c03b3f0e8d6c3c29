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


def session_pids(session_dir: str):
    """Processes of one port session: the GCS and raylet name the session
    directory on their command line, workers in their environment."""
    key = session_dir.encode()
    env_key = b"RAY_TPU_TORCH_SESSION_DIR=" + key
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit() or int(entry) == os.getpid():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read()
        except OSError:
            continue
        if b"ray_tpu_torch" in cmd and (key in cmd or env_key in env):
            pids.append(int(entry))
    return pids


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
