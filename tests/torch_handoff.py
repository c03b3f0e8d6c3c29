"""Set-up shared by the KV handoff tests (test_torch_disagg.py,
test_torch_migration.py, test_torch_router.py): the tiny configuration of
tests/test_llm_router.py in both packages on the same weights, servers
of either package, and a listener that records the bytes of one handoff.
"""

import socket
import threading
import time

import numpy as np
import torch

from ray_tpu_torch.llm import disagg as td
from ray_tpu_torch.models import llama as tl

N_BLOCKS = 64


def prompt(seed, n=17, vocab=128):
    return [(seed * 7 + 3 * i + seed) % vocab for i in range(n)]


def make_weights(dtype="float32", max_seq=64):
    """(JAX config, port config, port params) of the tiny Llama: the JAX
    server draws jax.random.key(0) itself, the port gets the same values
    through params_from_numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    jconfig = jl.LlamaConfig.tiny(vocab_size=128, max_seq=max_seq,
                                  dtype=getattr(jnp, dtype))
    jparams = jl.init_params(jconfig, jax.random.key(0))
    tconfig = tl.LlamaConfig.tiny(vocab_size=128, max_seq=max_seq,
                                  dtype=getattr(torch, dtype))
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   tconfig, device="cpu")
    return jconfig, tconfig, tparams


def _base(**kw):
    base = dict(num_kv_blocks=N_BLOCKS, block_size=8, max_batch_size=4,
                prefill_chunk=8, warmup_buckets="off", stream_timeout_s=30.0)
    base.update(kw)
    return base


def jax_config(weights, **kw):
    from ray_tpu.llm.serving import LLMConfig

    return LLMConfig(model_config=weights[0], **_base(**kw))


def port_config(weights, **kw):
    from ray_tpu_torch.llm.serving import LLMConfig

    return LLMConfig(model_config=weights[1], device="cpu", **_base(**kw))


def server(pkg, weights, **kw):
    """An LLMServer of `pkg` ("jax" or "port")."""
    if pkg == "jax":
        from ray_tpu.llm.serving import LLMServer

        return LLMServer(jax_config(weights, **kw))
    from ray_tpu_torch.llm.serving import LLMServer

    return LLMServer(port_config(weights, **kw), params=weights[2])


def prefill_server(pkg, weights, **kw):
    if pkg == "jax":
        from ray_tpu.llm.disagg import PrefillServer

        return PrefillServer(jax_config(weights, **kw))
    return td.PrefillServer(port_config(weights, **kw), params=weights[2])


def close(srv):
    """Stop a server's listener (and a port server's loop and runner; the
    JAX server's loop thread is a daemon that idles)."""
    if hasattr(srv, "close"):
        srv.close()
    elif hasattr(srv, "_handoff"):
        srv._handoff.close()


def counters(pkg):
    if pkg == "jax":
        from ray_tpu.core import serialization

        return serialization.counters
    from ray_tpu_torch.collective import cpu_group

    return cpu_group.counters


def free_blocks(srv):
    stats = srv.engine_stats()
    return stats["free_kv_blocks"], stats["total_kv_blocks"]


def wait_for(pred, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


class _Tap:
    """A socket whose receives are also appended to `data`."""

    def __init__(self, conn, data):
        self._conn = conn
        self._data = data

    def recv_into(self, view, nbytes=0):
        n = self._conn.recv_into(view, nbytes)
        self._data += bytes(view[:n])
        return n


class Recorder:
    """A listener that takes one handoff (head frame, K, V), keeps every
    byte it received, parses it with the port's frame reader and acks it.
    Every receive has a 10 s deadline."""

    def __init__(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(1)
        self._sock.settimeout(10.0)
        self.address = self._sock.getsockname()
        self.data = bytearray()
        self.frames = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            conn, _ = self._sock.accept()
            with conn:
                conn.settimeout(10.0)
                tap = _Tap(conn, self.data)
                self.frames = [td._recv_frame(tap) for _ in range(3)]
                td._send_json(conn, {"ok": True, "id": "recorded"})
        finally:
            self._sock.close()

    def join(self):
        self._thread.join(15.0)
        assert not self._thread.is_alive(), "recorder never finished"
        return bytes(self.data)


def engine(pkg, weights, prefill_only=False, **kw):
    """A bare engine of `pkg` (no server loop) on the tiny weights."""
    if pkg == "jax":
        from ray_tpu.llm.serving import build_engine

        return build_engine(jax_config(weights, **kw),
                            prefill_only=prefill_only)
    from ray_tpu_torch.llm.serving import build_engine

    return build_engine(port_config(weights, **kw), weights[2],
                        prefill_only=prefill_only)


def parse(pkg, request):
    """(prompt, SamplingParams of `pkg`) of an OpenAI-style request."""
    holder = type("Holder", (), {"tokenizer": None})()
    if pkg == "jax":
        from ray_tpu.llm.serving import LLMServer

        p, params, _, _ = LLMServer._parse(holder, request)
    else:
        from ray_tpu_torch.llm.serving import LLMServer

        p, params, _, _ = LLMServer._parse(holder, request)
    return p, params


def spliced_tokens(weights, src, dst, request, rid="spliced", at=1):
    """The reference of a move src -> dst without the wire: `src`'s
    engine runs the request until it holds `at` tokens (a prefill-only
    engine for the first), its export and pages go straight into `dst`'s
    engine, which decodes it to the end. The two packages' seeded
    samplers differ (each keys its own hash of (seed, position)), so a
    seeded request moved across packages has this reference, not a
    single server's."""
    pre = engine(src, weights, prefill_only=at == 1)
    dec = engine(dst, weights)
    p, params = parse(src, request)
    pre.add_request(p, params, request_id=rid)
    while not pre.running or len(pre.running[0].output) < at:
        pre.step()
    assert len(pre.running[0].output) == at
    state = pre.export_request(rid)
    k, v = pre.runner.gather_pages(state.pop("blocks"))
    first = list(state["output"])
    assert dec.adopt_request(state, np.asarray(k), np.asarray(v))
    out = None
    while dec.has_unfinished():
        for o in dec.step():
            if o.request_id == rid and o.finished:
                out = o.output_token_ids
    assert out[:len(first)] == first
    return out
