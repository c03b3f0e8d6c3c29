"""A multi-node cluster of the port's runtime on one host, for tests and the
smoke run (port of ray_tpu/cluster_utils.py).

Reference analog: python/ray/cluster_utils.py:135 `Cluster`: `add_node`
spawns a full raylet (with its own object store) per simulated node, each
with its own resource dict; `remove_node` kills one to exercise
fault-tolerance paths.

    cluster = Cluster(system_config={"ckpt_replicate": True})
    cluster.add_node(num_cpus=2, num_gpus=1)   # the head node
    cluster.add_node(num_cpus=1)
    rt.init(address=cluster.address)
    cluster.wait_for_nodes()
    ...
    rt.shutdown(); cluster.shutdown()

Every node's resources are given explicitly (a node with `num_gpus=0` has
no GPU whatever the host has). The session's auth token and
`system_config` reach the GCS, the raylets and their workers through
their environment at spawn; this process's `os.environ` is not written.
`shutdown()` SIGKILLs every process of the session still alive (the GCS
and raylets name the session directory on their command line, workers in
their environment) and unlinks every node's store file. Nothing here
imports torch.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.runtime import node as node_mod


def session_pids(session_dir: str) -> List[int]:
    """The live processes of one session, this one excepted."""
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


def _child_pids(pid: int) -> List[int]:
    """Direct children of `pid` (through /proc), best-effort."""
    out: List[int] = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/status") as f:
                for line in f:
                    if line.startswith("PPid:"):
                        if int(line.split()[1]) == pid:
                            out.append(int(entry))
                        break
        except OSError:
            continue
    return out


def _unlink(path: Optional[str]) -> None:
    if path and os.path.exists(path):
        try:
            os.unlink(path)
        except OSError:
            pass


class ClusterNode:
    def __init__(self, proc, info: dict, resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None):
        self.proc = proc
        self.node_id = bytes.fromhex(info["node_id"])
        self.address = tuple(info["address"])
        self.store_path = info["store_path"]
        self.resources = resources
        self.labels: Dict[str, str] = dict(labels or {})


class Cluster:
    """A GCS, then nodes added and removed one by one."""

    def __init__(self, system_config: Optional[Dict[str, Any]] = None):
        self.session_dir = node_mod.new_session_dir()
        self._env = {"RAY_TPU_TORCH_AUTH_TOKEN":
                     node_mod.ensure_auth_token(self.session_dir)}
        for k, v in (system_config or {}).items():
            self._env[f"RAY_TPU_TORCH_{k.upper()}"] = str(v)
        self.gcs_proc, self.gcs_address = node_mod.start_gcs(
            self.session_dir, self._env)
        self.nodes: List[ClusterNode] = []

    @property
    def address(self) -> str:
        return f"{self.gcs_address[0]}:{self.gcs_address[1]}"

    def add_node(self, *, num_cpus: float = 1.0, num_gpus: float = 0.0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: int = 512 << 20,
                 env: Optional[Dict[str, str]] = None) -> ClusterNode:
        """Start a raylet with its own store; the first node is the head.
        `env` is added to the raylet's (and its workers') environment."""
        res: Dict[str, float] = {"CPU": float(num_cpus)}
        if num_gpus:
            res["GPU"] = float(num_gpus)
        res.update({k: float(v) for k, v in (resources or {}).items()})
        worker_env = {"PYTHONPATH": ":".join(p for p in sys.path if p)}
        proc, info = node_mod.start_raylet(
            self.session_dir, self.gcs_address, res, labels or {},
            object_store_memory, {**self._env, **(env or {})},
            is_head=not self.nodes, worker_env=worker_env,
            name=f"raylet{len(self.nodes)}")
        node = ClusterNode(proc, info, res, labels)
        self.nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode, force: bool = True) -> None:
        """Kill a node (its raylet and its workers) to simulate node
        failure, and unlink its store file."""
        try:
            if force:
                # Workers run in sessions of their own: collect the
                # raylet's children first and kill their groups too.
                children = _child_pids(node.proc.pid)
                node.proc.kill()
                node.proc.wait(timeout=10)
                for pid in children:
                    try:
                        os.killpg(pid, signal.SIGKILL)
                    except OSError:
                        try:
                            os.kill(pid, signal.SIGKILL)
                        except OSError:
                            pass
            else:
                node.proc.terminate()
                node.proc.wait(timeout=10)
        except Exception:
            pass
        _unlink(node.store_path)
        self.nodes.remove(node)

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 30) -> None:
        """Block until the GCS sees `count` (default: all added) live
        nodes. Needs `init(address=cluster.address)` first."""
        from ray_tpu_torch.core import api

        want = count if count is not None else len(self.nodes)
        deadline = time.monotonic() + timeout
        alive: list = []
        while time.monotonic() < deadline:
            alive = [n for n in api.nodes() if n["alive"]]
            if len(alive) >= want:
                return
            time.sleep(0.1)
        raise TimeoutError(f"only {len(alive)} of {want} nodes alive")

    def shutdown(self) -> None:
        """SIGKILL every process of the session and unlink every store.
        Call `shutdown()` of the runtime first where this process joined
        the cluster."""
        for pid in session_pids(self.session_dir):
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        for proc in [n.proc for n in self.nodes] + [self.gcs_proc]:
            try:
                proc.wait(timeout=10)
            except Exception:
                pass
        for node in self.nodes:
            _unlink(node.store_path)
        self.nodes = []
