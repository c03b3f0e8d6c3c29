"""Disaggregated prefill/decode: KV-page streaming between LLM servers.

Port of ray_tpu/llm/disagg.py. Prefill and decode have opposite resource
profiles (prefill is one long compute-bound burst, decode thousands of
small latency-bound steps), so co-scheduling them makes every session's
inter-token latency hostage to whatever long prompt shares the batch.
This module splits the tiers: a PrefillServer's engine runs chunked
prefill ONLY (`prefill_only=True`: the split path, K6), then streams the
populated KV pages and the portable request state to a decode server,
whose engine adopts the pages into its own block table
(BlockManager.adopt_blocks + ModelRunner.scatter_pages) and enters
decode directly (the unified tick, K5 inside its CUDA graphs).

Wire format, byte for byte the JAX package's (collective/cpu_group.py
frames, runtime/wire.py head frame), so either package may sit on either
side:

    [u64 body len][u8 kind=3][KVHandoffMsg: state JSON + kv meta + trace ctx]
    [u64][u8 kind=1][97B _AMETA][raw k-page bytes]   x ceil(bytes/1MiB)
    [u64][u8 kind=1][97B _AMETA][raw v-page bytes]   x ceil(bytes/1MiB)
    <- [u64][u8 kind=2][JSON ack]

Receivers also accept a bare JSON head frame (kind 2). Nothing on the
wire is pickled (counter-tested through collective/cpu_group.counters).
Page payloads ride kind-1 frames straight out of and into host buffers;
the logical dtype rides in the head frame: bf16 pages are sent as their
uint16 bits labelled "bfloat16" (what the JAX package writes for its
bf16 arrays), and a port receiver turns that label back into uint16 bits,
which ModelRunner.scatter_pages takes.

Failure atomicity: one connection carries exactly one request, and the
receiver adopts only after BOTH arrays arrived whole. A sender dying
mid-handoff just drops the connection: the decode engine adopts nothing,
and the caller re-runs prefill elsewhere (the sender reports success
only after the receiver's ack).
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.collective.cpu_group import (
    _HDR, _K_ARRAY, _chunks, _frame_views, _read_ameta, _read_hdr,
    _sock_recv_into, _sock_send, counters)
from ray_tpu_torch.llm.prefix_store import BF16, _host_array
from ray_tpu_torch.runtime import wire
from ray_tpu_torch.util import tracing

# Handoff control frame: JSON body (kinds 0/1 belong to cpu_group's wire).
_K_JSON = 2
# Typed control frame: wire.KVHandoffMsg body — the JSON request state plus
# the trace context that stitches the request's spans across the handoff.
_K_MSG = 3
_CHUNK_BYTES = 1 << 20


class HandoffError(RuntimeError):
    """KV handoff failed before the receiver acked adoption."""


def _send_json(sock: socket.socket, obj: dict,
               deadline: Optional[float] = None) -> None:
    body = json.dumps(obj).encode()
    _sock_send(sock, memoryview(_HDR.pack(len(body), _K_JSON) + body),
               None, deadline)


def _send_msg(sock: socket.socket, msg,
              deadline: Optional[float] = None) -> None:
    body = msg.encode()
    _sock_send(sock, memoryview(_HDR.pack(len(body), _K_MSG) + body),
               None, deadline)


def _recv_frame(sock: socket.socket, deadline: Optional[float] = None):
    """Receive one logical handoff message: ("json", dict) or a whole raw
    array reassembled across its chunk frames ("array", flat array)."""
    length, kind = _read_hdr(sock, None, deadline)
    if kind == _K_MSG:
        # Typed head frame, decoded into the meta dict the JSON frame
        # carries, so nothing downstream cares which one arrived.
        body = bytearray(length)
        _sock_recv_into(sock, memoryview(body), None, deadline)
        msg = wire.KVHandoffMsg.decode(bytes(body))
        meta = json.loads(msg.state_json.decode())
        meta["kv_dtype"] = msg.kv_dtype
        meta["kv_shape"] = list(msg.kv_shape)
        if msg.trace_id:
            meta["_trace"] = (msg.trace_id, msg.parent_span_id or None)
        return "json", meta
    if kind == _K_JSON:
        body = bytearray(length)
        _sock_recv_into(sock, memoryview(body), None, deadline)
        return "json", json.loads(bytes(body).decode())
    if kind != _K_ARRAY:
        raise HandoffError(f"handoff protocol error: unknown frame kind {kind}")
    dtype, shape, offset, nelems = _read_ameta(sock, None, deadline)
    out = np.empty(shape, dtype)
    flat = out.reshape(-1)
    total, got = flat.size, 0
    while True:
        if nelems:
            _sock_recv_into(
                sock, memoryview(flat[offset:offset + nelems]).cast("B"),
                None, deadline)
            got += nelems
        counters["deserialize_fast"] += 1
        if got >= total:
            return "array", flat
        length, kind = _read_hdr(sock, None, deadline)
        if kind != _K_ARRAY:
            raise HandoffError("handoff protocol error: truncated array stream")
        _, _, offset, nelems = _read_ameta(sock, None, deadline)


def _send_array(sock: socket.socket, arr: np.ndarray,
                deadline: Optional[float] = None) -> None:
    """Stream one array as chunked raw frames; dtype-agnostic (bytes view)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    for off, n in _chunks(0, flat.size, _CHUNK_BYTES):
        for view in _frame_views(flat[off:off + n], flat.shape, off):
            _sock_send(sock, view, None, deadline)


def send_handoff(address, state: dict, k_pages, v_pages, *,
                 kv_dtype: Optional[str] = None,
                 timeout: float = 60.0) -> dict:
    """Stream one prefilled request to a decode server's KVStreamServer.

    `k_pages`/`v_pages` are host arrays or tensors in gather_pages'
    layout. `kv_dtype` names their dtype when the arrays hold another
    type's bits (the port's bf16 pages are uint16 arrays: pass the
    runner's `kv_dtype_name`); bf16 tensors are labelled by themselves.
    Blocks until the receiver acks adoption: only then may the sender
    release its own pages and report success (an unacked handoff never
    happened; the caller re-runs prefill)."""
    k, k_name = _host_array(k_pages)
    v, _ = _host_array(v_pages)
    kv_dtype = kv_dtype or k_name or str(k.dtype)
    migrated = bool(state.get("migrated"))
    with tracing.span("llm:kv_handoff", "llm",
                      request_id=str(state.get("id", "")),
                      migrated=migrated, bytes=int(k.nbytes + v.nbytes)):
        # The trace ids inside the span: the receiver's adopt span
        # parent-links to this handoff span, not to the caller's.
        msg = wire.KVHandoffMsg(
            state_json=json.dumps(state).encode(),
            kv_dtype=kv_dtype, kv_shape=list(k.shape),
            migrated=migrated,
            trace_id=tracing.current_trace_id() or b"",
            parent_span_id=tracing.current_span_id() or b"")
        deadline = time.monotonic() + timeout
        with socket.create_connection(tuple(address), timeout=timeout) as sock:
            sock.settimeout(timeout)
            _send_msg(sock, msg, deadline)
            _send_array(sock, k, deadline)
            _send_array(sock, v, deadline)
            kind, ack = _recv_frame(sock, deadline)
    if kind != "json" or not ack.get("ok"):
        raise HandoffError(f"decode replica rejected handoff: {ack}")
    return ack


def migrate_session(address, state: dict, k_pages, v_pages, *,
                    kv_dtype: Optional[str] = None,
                    timeout: float = 60.0) -> dict:
    """Server->server live session migration: the prefill->decode handoff
    wire generalized. `state` is an LLMEngine.export_session "kv" export,
    possibly mid-generation (output tokens and their KV pages ride
    along), and the adopter resumes decode exactly where the exporter
    stopped, with zero re-prefill. Same whole-stream-or-discard atomicity
    as send_handoff: an unacked migration never happened, and the caller
    falls back to seeded replay from the prompt."""
    meta = dict(state)
    meta["migrated"] = True
    return send_handoff(address, meta, k_pages, v_pages, kv_dtype=kv_dtype,
                        timeout=timeout)


class KVStreamServer:
    """Decode-side handoff listener: adopts streamed KV pages atomically.

    One daemon thread accepts connections; each connection carries exactly
    one request, received on a thread of its own with `timeout` seconds
    for every receive. A connection that dies mid-stream is discarded
    whole: `adopt_fn(state, k_pages, v_pages) -> bool` runs only once both
    arrays arrived intact, so partial prefill state never enters the
    decode engine's block table. bf16 pages reach `adopt_fn` as uint16
    arrays of their bits."""

    def __init__(self, adopt_fn: Callable[[dict, np.ndarray, np.ndarray], bool],
                 host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0):
        self._adopt = adopt_fn
        self._timeout = timeout
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._closed = False
        # Connections run on threads of their own: the counts take a lock.
        self._count_lock = threading.Lock()
        self.handoffs_adopted = 0
        self.handoffs_rejected = 0
        self._thread = threading.Thread(
            target=self._serve, name="kv-handoff-listener", daemon=True)
        self._thread.start()

    def _serve(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="kv-handoff-conn").start()

    def _handle(self, conn: socket.socket):
        with conn:
            conn.settimeout(self._timeout)
            try:
                kind, meta = _recv_frame(conn)
                if kind != "json":
                    raise HandoffError("handoff must start with a JSON frame")
                _, kflat = _recv_frame(conn)
                _, vflat = _recv_frame(conn)
            except Exception:
                # Partial stream (sender died / malformed): adopt NOTHING.
                self._count(False)
                return
            trace_id, parent = meta.pop("_trace", (None, None))
            try:
                name = meta.pop("kv_dtype")
                dtype = np.dtype(np.uint16 if name == BF16 else name)
                shape = tuple(meta.pop("kv_shape"))
                k = kflat.view(dtype).reshape(shape)
                v = vflat.view(dtype).reshape(shape)
                # Adopt under the sender's trace context, so this side of
                # the handoff joins the request's trace.
                with tracing.trace_context(trace_id, parent):
                    with tracing.span("llm:kv_adopt", "llm",
                                      request_id=str(meta.get("id", "")),
                                      migrated=bool(meta.get("migrated"))):
                        ok = bool(self._adopt(meta, k, v))
            except Exception as e:
                self._count(False)
                try:
                    _send_json(conn, {"ok": False, "error": repr(e)})
                except Exception:
                    pass
                return
            self._count(ok)
            try:
                _send_json(conn, {"ok": ok, "id": meta.get("id")})
            except Exception:
                pass

    def _count(self, adopted: bool) -> None:
        with self._count_lock:
            if adopted:
                self.handoffs_adopted += 1
            else:
                self.handoffs_rejected += 1
        if adopted:
            from ray_tpu_torch.runtime import metric_defs

            metric_defs.LLM_KV_HANDOFFS.inc()

    def close(self):
        self._closed = True
        try:
            # Wakes the listener blocked in accept(): a close alone leaves
            # it there, and the thread keeps this object, its adopt
            # callback and the whole server (engine, KV pool) alive.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not threading.current_thread():
            self._thread.join(5)


class PrefillServer:
    """The prefill tier's server.

    Runs chunked prefill ONLY (the engine never takes a decode tick), then
    exports the request (state and populated KV pages) and streams it to
    the decode server named by the caller. Requests that finish AT
    prefill (max_tokens == 1, a stop token first) complete here and
    return their response inline: there is nothing left to decode.
    `params` (the port's parameter dict) lets a prefill tier and a decode
    server on one card share one copy of the weights; `close()` releases
    the engine's runner."""

    def __init__(self, llm_config, params: Optional[Dict] = None):
        from ray_tpu_torch.llm.serving import build_engine, _cuda_scope

        self.engine = build_engine(llm_config, params, prefill_only=True)
        self.tokenizer = llm_config.tokenizer
        self._scope = _cuda_scope(self.engine.runner.device)
        self._lock = threading.Lock()
        # EWMA prefill throughput (tokens/s): the router's TTFT estimator
        # divides queued prefill tokens by this.
        self._prefill_tps = 0.0

    def close(self) -> None:
        self.engine.runner.close()

    def _parse(self, request: Dict):
        from ray_tpu_torch.llm.serving import LLMServer

        return LLMServer._parse(self, request)

    def prefill(self, request: Dict, decode_address) -> Dict:
        """Prefill one request and hand it to `decode_address` (a decode
        server's KVStreamServer). Returns {"handoff": True, "rid": ...} on
        success; {"handoff": False, "response": ...} when the request
        finished during prefill."""
        prompt, params, rid, lora_name = self._parse(request)
        t0 = time.monotonic()
        t0_wall = time.time()
        with self._lock, self._scope():
            # A caller-assigned request_id rides through, so the decode
            # side keeps the caller's name for the request (a replay
            # re-derives the same sampling seed from it).
            rid = self.engine.add_request(prompt, params, request_id=rid,
                                          lora_name=lora_name)
            final = None
            while True:
                outs = self.engine.step()
                mine = [o for o in outs if o.request_id == rid]
                if any(o.finished for o in mine):
                    final = next(o for o in mine if o.finished)
                    break
                if mine:
                    break  # first token emitted: prefill complete
                if not self.engine.has_unfinished():
                    raise RuntimeError(f"request {rid} vanished mid-prefill")
            if final is not None:
                return {"handoff": False, "rid": rid,
                        "response": _completion_response(final)}
            state = self.engine.export_request(rid)
            blocks = state.pop("blocks")
            k, v = self.engine.runner.gather_pages(blocks)
            self.engine.block_manager.release_blocks(blocks)
            elapsed = max(time.monotonic() - t0, 1e-6)
            tps = len(prompt) / elapsed
            self._prefill_tps = (tps if self._prefill_tps == 0.0
                                 else 0.8 * self._prefill_tps + 0.2 * tps)
            t1_wall = time.time()
        # Stream outside the lock: the socket write must not serialize the
        # next request's prefill behind network time. The trace id derives
        # from the rid, so the prefill and handoff spans join the request's
        # trace.
        t_send = time.monotonic()
        with tracing.trace_context(tracing.request_trace_id(rid), None):
            tracing.record_span("llm:prefill", "llm", t0_wall, t1_wall,
                                request_id=rid, tokens=len(prompt),
                                tier="prefill")
            ack = send_handoff(decode_address, state, k, v,
                               kv_dtype=self.engine.runner.kv_dtype_name)
        return {"handoff": True, "rid": rid, "ack": ack,
                "prefill_tokens_per_s": round(self._prefill_tps, 1),
                # What the JAX package's llm:kv_handoff span records.
                "handoff_bytes": int(k.nbytes + v.nbytes),
                "handoff_s": time.monotonic() - t_send}

    def engine_stats(self) -> Dict:
        with self._lock:
            s = self.engine.stats()
        s["prefill_tokens_per_s"] = round(self._prefill_tps, 1)
        s["role"] = "prefill"
        return s


def _completion_response(out) -> Dict:
    """OpenAI-ish completion body from a finished RequestOutput (shared by
    LLMServer.completions and the prefill-finishes-everything path)."""
    return {
        "id": out.request_id,
        "object": "text_completion",
        "choices": [{
            "text": out.text,
            "token_ids": out.output_token_ids,
            "finish_reason": out.finish_reason,
        }],
        "usage": {
            "prompt_tokens": len(out.prompt_token_ids),
            "completion_tokens": len(out.output_token_ids),
        },
    }
