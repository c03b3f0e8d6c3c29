"""Node bootstrap: start/stop the head-node process tree.

Reference analog: python/ray/_private/node.py (:1117-1429) and services.py
(start_gcs_server:1445, start_raylet:1529): the driver spawns the GCS and a
raylet as subprocesses and connects to them.

The port's copy of ray_tpu/runtime/node.py, with names of its own: the base
directory /tmp/ray_tpu_torch (its own session_latest) and the auth token
RAY_TPU_TORCH_AUTH_TOKEN. The token and any `_system_config` reach the
cluster's processes through their environment at spawn; this process's
`os.environ` is never written, so nothing of one cluster leaks into the
next one started in the same process. The dashboard is not ported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, Optional, Tuple


def _default_base() -> str:
    """/tmp/ray_tpu_torch, or ray_tpu_torch under $TMPDIR where it is set."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


class NodeProcesses:
    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.raylet_proc: Optional[subprocess.Popen] = None
        self.gcs_address: Optional[Tuple[str, int]] = None
        self.raylet_address: Optional[Tuple[str, int]] = None
        self.node_id: Optional[bytes] = None
        self.store_path: Optional[str] = None


def _child_env(env: Dict[str, str]) -> Dict[str, str]:
    """This process's environment plus `env`, with the directory holding
    the ray_tpu_torch package first on PYTHONPATH (`python -m` finds it
    from any working directory)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = {**os.environ, **env}
    out["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, out.get("PYTHONPATH", "")) if p)
    return out


def new_session_dir() -> str:
    base = os.environ.get("RAY_TPU_TORCH_TMPDIR") or _default_base()
    session = os.path.join(base, f"session_{int(time.time())}_{uuid.uuid4().hex[:8]}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    # session_latest lets same-host attachers (CLI status/join, driver
    # init(address=...)) find the auth token without an env var (reference
    # analog: /tmp/ray/session_latest).
    latest = os.path.join(base, "session_latest")
    tmp = f"{latest}.{os.getpid()}.tmp"
    try:
        os.symlink(session, tmp)
        os.replace(tmp, latest)
    except OSError:
        pass
    return session


def _wait_file(path: str, timeout: float, proc: subprocess.Popen, what: str) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        if proc.poll() is not None:
            raise RuntimeError(f"{what} exited with code {proc.returncode} during startup "
                               f"(logs in {os.path.dirname(path)})")
        time.sleep(0.02)
    raise RuntimeError(f"timed out waiting for {what} to start")


def ensure_auth_token(session_dir: str) -> str:
    """Mint the per-session wire-auth token (rpc.py challenge-response) and
    return it as hex.

    The caller hands it to every cluster process it spawns through the
    child's RAY_TPU_TORCH_AUTH_TOKEN; the 0600 session file lets a
    same-host operator attach out-of-band. A token already in this
    process's environment is used instead (attach to an existing cluster /
    explicit operator-provided token)."""
    token_hex = os.environ.get("RAY_TPU_TORCH_AUTH_TOKEN")
    if token_hex:
        try:
            bytes.fromhex(token_hex)
        except ValueError:
            raise RuntimeError(
                "RAY_TPU_TORCH_AUTH_TOKEN must be a hex string; "
                f"got {len(token_hex)} chars of non-hex")
    else:
        token_hex = os.urandom(32).hex()
    path = os.path.join(session_dir, "auth_token")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(token_hex)
    from ray_tpu_torch.runtime import rpc

    rpc.set_session_token(bytes.fromhex(token_hex))
    return token_hex


def start_gcs(session_dir: str, env: Dict[str, str], port: int = 0,
              storage: Optional[str] = None
              ) -> Tuple[subprocess.Popen, Tuple[str, int]]:
    """storage defaults to <session>/gcs.db — GCS restarts recover state
    (pass storage="" to run purely in-memory). `env` is added to the
    child's environment (the auth token, `_system_config`)."""
    if storage is None:
        storage = os.path.join(session_dir, "gcs.db")
    ready = os.path.join(session_dir, f"gcs_ready_{os.getpid()}_{port}")
    try:
        os.unlink(ready)
    except OSError:
        pass
    log = open(os.path.join(session_dir, "logs", "gcs.log"), "ab")
    cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.gcs.main",
           "--ready-file", ready, "--port", str(port)]
    if storage:
        cmd += ["--storage", storage]
    proc = subprocess.Popen(
        cmd, stdout=log, stderr=subprocess.STDOUT, start_new_session=True,
        env=_child_env(env))
    log.close()
    addr = _wait_file(ready, 60, proc, "GCS")
    host, port = addr.rsplit(":", 1)
    # Record the address in the session dir so same-host attachers can
    # resolve the RIGHT session's auth token by the address they attach to
    # (session_latest alone mis-resolves when two clusters share a host —
    # rpc.load_token_for_address scans these files).
    with open(os.path.join(session_dir, "gcs_address"), "w") as f:
        f.write(f"{host}:{port}")
    return proc, (host, int(port))


def start_raylet(session_dir: str, gcs_address: Tuple[str, int],
                 resources: Dict[str, float], labels: Dict[str, str],
                 object_store_memory: int, env: Dict[str, str],
                 is_head: bool = False,
                 worker_env: Optional[Dict[str, str]] = None,
                 name: str = "raylet") -> Tuple[subprocess.Popen, dict]:
    """`env` is added to the raylet's environment, which its workers
    inherit (the auth token, `_system_config`)."""
    ready = os.path.join(session_dir, f"{name}_ready_{uuid.uuid4().hex[:6]}")
    log = open(os.path.join(session_dir, "logs", f"{name}.log"), "ab")
    cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.raylet.main",
           "--gcs-address", f"{gcs_address[0]}:{gcs_address[1]}",
           "--session-dir", session_dir,
           "--resources", json.dumps(resources),
           "--labels", json.dumps(labels),
           "--object-store-memory", str(object_store_memory),
           "--worker-env", json.dumps(worker_env or {}),
           "--ready-file", ready]
    if is_head:
        cmd.append("--is-head")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True, env=_child_env(env))
    log.close()
    info = json.loads(_wait_file(ready, 60, proc, "raylet"))
    return proc, info
