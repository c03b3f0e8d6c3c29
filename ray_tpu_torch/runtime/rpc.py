"""Asyncio RPC layer: framed-pickle request/reply + push channels.

The port's copy of ray_tpu/runtime/rpc.py, auth challenge included. The
cross-language dialect (RTX frames, the JAX package's runtime/xlang.py)
is not ported: a server refuses such a frame with ProtocolMismatch.

Reference analog: src/ray/rpc/ (GrpcServer grpc_server.h:88, ClientCallManager
client_call.h, retryable_grpc_client.cc). The wire is a length-prefixed pickle
frame over TCP; the programming model mirrors gRPC async services: named
handlers on servers, awaitable calls on clients, plus server->client pushes
for pubsub. Transport is swappable behind these two classes.

Frame: [4-byte magic "RTP"+version][u32 length][pickle payload][16B MAC*]
Payload: (kind, msg_id, method, data)
  kind: 0 = request, 1 = reply, 2 = error reply, 3 = push (one-way)
A bad magic drops the connection (ProtocolMismatch) before any pickle runs.
*When a session token is set, connections mutually authenticate at accept
and every frame carries a keyed-blake2b MAC over (direction, seq, body),
verified before pickle.loads — see the wire-auth section below.
"""

from __future__ import annotations

import asyncio
import logging
import pickle
import struct
import threading
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)


def _chaos_enabled() -> bool:
    """Fault injection (runtime/chaos.py) — active only when its table has
    rules (from its environment spec or added programmatically); one cheap
    check on the hot path once the table exists."""
    from ray_tpu_torch.runtime import chaos as chaos_mod

    return chaos_mod.chaos().enabled


async def _chaos_client(method: str):
    """The chaos table's client-side hook, its injected failure raised as
    this module's ConnectionLost (the class every caller catches)."""
    from ray_tpu_torch.runtime import chaos as chaos_mod

    try:
        await chaos_mod.chaos().intercept_client(method)
    except chaos_mod.ConnectionLost as e:
        raise ConnectionLost(str(e)) from None


# Wire format (the protobuf-IDL analog, src/ray/protobuf/): every frame is
# `magic+version | length | pickle(body)`. The magic rejects foreign/garbage
# connections at the first frame instead of failing inside pickle, and the
# embedded version turns a mixed-version cluster into a loud, diagnosable
# error instead of undefined unpickling behavior.
PROTOCOL_VERSION = 1
_MAGIC = b"RTP" + bytes([PROTOCOL_VERSION])
# Cross-language dialect of the JAX package (runtime/xlang.py there): not
# ported, its magic is only recognised to refuse it.
_X_MAGIC = b"RTX" + bytes([PROTOCOL_VERSION])
# Raw dialect: the zero-pickle fast path for schema'd messages. Body is
# [u8 kind][u64 msg_id][u16 method_len][method utf8][u32 m_len][m][payload]
# where `m` is a wire.Message encoding (runtime/wire.py) and `payload` is
# out-of-band bulk bytes (object chunks) that reach the handler as a
# memoryview over the receive buffer — no pickle.dumps/loads anywhere on
# the path. Same MAC/auth rules as every other frame. Error replies stay
# pickled (rare path, carries real exceptions).
_R_MAGIC = b"RTR" + bytes([PROTOCOL_VERSION])
_R_PRE = struct.Struct("<BQH")
_R_MLEN = struct.Struct("<I")
_HDR = struct.Struct("<4sI")
KIND_REQUEST, KIND_REPLY, KIND_ERROR, KIND_PUSH = 0, 1, 2, 3
MAX_FRAME = 1 << 31


class Raw:
    """Raw-frame envelope: schema header bytes + out-of-band payload.

    Requests decoded off an RTR frame arrive at handlers as
    `handler(conn, m, payload)`; a handler returning a `Raw` (alias
    `RawReply`) gets its reply emitted as an RTR frame — end to end, the
    bulk payload is never pickled and never copied into a pickle buffer."""

    __slots__ = ("m", "payload")

    def __init__(self, m: bytes = b"", payload=b""):
        self.m = m
        self.payload = payload


RawReply = Raw

# ---------------------------------------------------------------- wire auth
#
# A pickle wire must earn what protobuf gets for free: anyone who can reach
# a port must NOT get arbitrary-code execution via pickle.loads — in EITHER
# direction. Every cluster session mints a random token (start_gcs, node.py)
# and each connection runs a MUTUAL challenge-response:
#
#   server -> client : "RTA"+ver + sc (32-byte challenge)
#   client -> server : cc (32-byte challenge) + HMAC(token, "c"+sc+cc)
#   server -> client : HMAC(token, "s"+sc+cc)
#
# The client proof gates the server (no pickle from unauthenticated
# clients); the server proof gates the client (a spoofed/hijacked endpoint
# — port reuse after a raylet dies, TCP injection — cannot feed the client
# pickle frames). Both sides then derive a per-session MAC key
# HMAC(token, "k"+sc+cc) and every frame carries a 16-byte
# blake2b(key=mac_key, direction+seq+body) tag verified BEFORE pickle.loads,
# so injected or replayed bytes are dropped at the framing layer. No token
# in the process -> auth is off (bare RpcServer unit tests); cluster
# processes always inherit the token via RAY_TPU_TORCH_AUTH_TOKEN / the 0600
# session file.
_AUTH_MAGIC = b"RTA" + bytes([PROTOCOL_VERSION])
_CHALLENGE_SIZE = 32
_MAC_SIZE = 16
_session_token: Optional[bytes] = None
_token_loaded = False


def _default_base() -> str:
    from ray_tpu_torch.runtime.node import _default_base as base

    return base()


def set_session_token(token: Optional[bytes]) -> None:
    global _session_token, _token_loaded
    _session_token = token or None
    _token_loaded = True


def get_session_token() -> Optional[bytes]:
    global _session_token, _token_loaded
    if not _token_loaded:
        import os

        tok = os.environ.get("RAY_TPU_TORCH_AUTH_TOKEN", "")
        if not tok:
            # Same-host attach without the env var: read the latest
            # session's token file (written 0600 by node.ensure_auth_token).
            # NOTE: with multiple live sessions on one host this can be the
            # WRONG session's token — attach paths that know the GCS
            # address call load_token_for_address() first, which resolves
            # by address and pins the token explicitly.
            base = os.environ.get("RAY_TPU_TORCH_TMPDIR") or _default_base()
            path = os.path.join(base, "session_latest", "auth_token")
            try:
                with open(path) as f:
                    tok = f.read().strip()
            except OSError:
                tok = ""
        try:
            _session_token = bytes.fromhex(tok) if tok else None
        except ValueError as e:
            raise AuthError(
                "RAY_TPU_TORCH_AUTH_TOKEN must be a hex string (64 hex chars for "
                f"the standard 32-byte token); got {len(tok)} chars") from e
        _token_loaded = True
    return _session_token


def load_token_for_address(host: str, port: int) -> bool:
    """Resolve the auth token for the session that owns host:port.

    Scans session dirs for a gcs_address record matching the address being
    attached to, so an attacher on a host running several clusters gets the
    RIGHT token instead of whatever session_latest points at. An explicit
    RAY_TPU_TORCH_AUTH_TOKEN always wins (operator override). Returns True if a
    token was pinned."""
    import glob
    import os

    if os.environ.get("RAY_TPU_TORCH_AUTH_TOKEN"):
        return False
    want = {f"{host}:{port}"}
    if host in ("127.0.0.1", "localhost", "0.0.0.0"):
        want = {f"{h}:{port}" for h in ("127.0.0.1", "localhost", "0.0.0.0")}
    base = os.environ.get("RAY_TPU_TORCH_TMPDIR") or _default_base()
    candidates = sorted(glob.glob(os.path.join(base, "session_*")),
                        key=lambda p: -os.path.getmtime(p)
                        if os.path.exists(p) else 0)
    for session in candidates:
        if os.path.basename(session) == "session_latest":
            continue
        try:
            with open(os.path.join(session, "gcs_address")) as f:
                addr = f.read().strip()
            if addr not in want:
                continue
            with open(os.path.join(session, "auth_token")) as f:
                tok = f.read().strip()
        except OSError:
            continue
        try:
            set_session_token(bytes.fromhex(tok))
            return True
        except ValueError:
            continue
    return False


def _hmac_answer(token: bytes, challenge: bytes) -> bytes:
    import hashlib
    import hmac as hmac_mod

    return hmac_mod.new(token, challenge, hashlib.sha256).digest()


def _client_proof(token: bytes, sc: bytes, cc: bytes) -> bytes:
    return _hmac_answer(token, b"c" + sc + cc)


def _server_proof(token: bytes, sc: bytes, cc: bytes) -> bytes:
    return _hmac_answer(token, b"s" + sc + cc)


def _session_mac_key(token: bytes, sc: bytes, cc: bytes) -> bytes:
    return _hmac_answer(token, b"k" + sc + cc)


class _FrameMac:
    """Per-connection frame authenticator (one per direction pair).

    The tag binds direction + monotonically increasing sequence + body, so a
    frame can't be injected, replayed, reordered, or reflected back. blake2b
    keyed mode (RFC 7693) — faster than HMAC-SHA256 on the hot path."""

    __slots__ = ("key", "send_dir", "recv_dir", "send_seq", "recv_seq")

    def __init__(self, key: bytes, is_client: bool):
        import hashlib  # noqa: F401  (ensures module is loaded before use)

        self.key = key
        self.send_dir = b"C" if is_client else b"S"
        self.recv_dir = b"S" if is_client else b"C"
        self.send_seq = 0
        self.recv_seq = 0

    def _tag(self, direction: bytes, seq: int, *parts) -> bytes:
        import hashlib

        m = hashlib.blake2b(key=self.key, digest_size=_MAC_SIZE)
        m.update(direction)
        m.update(seq.to_bytes(8, "little"))
        for part in parts:
            m.update(part)
        return m.digest()

    def seal(self, body: bytes) -> bytes:
        tag = self._tag(self.send_dir, self.send_seq, body)
        self.send_seq += 1
        return tag

    def seal_parts(self, *parts) -> bytes:
        """Seal a body supplied as segments (raw frames: head + payload)
        without concatenating — blake2b streams over each part."""
        tag = self._tag(self.send_dir, self.send_seq, *parts)
        self.send_seq += 1
        return tag

    def verify(self, body: bytes, tag: bytes) -> bool:
        import hmac as hmac_mod

        want = self._tag(self.recv_dir, self.recv_seq, body)
        self.recv_seq += 1
        return hmac_mod.compare_digest(want, tag)


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class ProtocolMismatch(RpcError):
    pass


class AuthError(RpcError):
    pass


async def _read_frame(reader: asyncio.StreamReader,
                      mac: Optional[_FrameMac] = None,
                      conn: Optional["ServerConnection"] = None):
    hdr = await reader.readexactly(_HDR.size)
    magic, length = _HDR.unpack(hdr)
    if magic == _X_MAGIC:
        raise ProtocolMismatch(
            "cross-language (xlang) frames are not ported to ray_tpu_torch "
            "yet (ROADMAP.md lists it as a later slice)")
    if magic == _R_MAGIC:
        # Zero-pickle raw frame: header fields are fixed-width structs, the
        # schema bytes + bulk payload come back as views over the receive
        # buffer. Nothing here can execute code.
        if length > MAX_FRAME:
            raise RpcError(f"frame too large: {length}")
        body = await reader.readexactly(length)
        if mac is not None:
            tag = await reader.readexactly(_MAC_SIZE)
            if not mac.verify(body, tag):
                raise AuthError("frame MAC verification failed")
        kind, msg_id, mlen = _R_PRE.unpack_from(body, 0)
        off = _R_PRE.size
        method = str(body[off:off + mlen], "utf-8")
        off += mlen
        (m_len,) = _R_MLEN.unpack_from(body, off)
        off += _R_MLEN.size
        data = Raw(bytes(body[off:off + m_len]),
                   memoryview(body)[off + m_len:])
        return kind, (msg_id if kind != KIND_PUSH else None), method, data
    if magic != _MAGIC:
        if magic[:3] == b"RTR":
            raise ProtocolMismatch(
                f"peer speaks raw wire v{magic[3]}, this process speaks "
                f"v{PROTOCOL_VERSION}")
        if magic[:3] == b"RTX":
            raise ProtocolMismatch(
                f"peer speaks xlang wire v{magic[3]}, which ray_tpu_torch "
                "does not speak")
        if magic[:3] == b"RTA":
            raise ProtocolMismatch(
                "server requires wire authentication but this process has "
                "no session token (RAY_TPU_TORCH_AUTH_TOKEN unset)")
        if magic[:3] == b"RTP":
            raise ProtocolMismatch(
                f"peer speaks ray_tpu_torch wire protocol v{magic[3]}, this "
                f"process speaks v{PROTOCOL_VERSION}")
        raise ProtocolMismatch(f"not a ray_tpu_torch peer (bad magic {magic!r})")
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}")
    body = await reader.readexactly(length)
    if mac is not None:
        tag = await reader.readexactly(_MAC_SIZE)
        if not mac.verify(body, tag):
            # Injected/replayed bytes on an authenticated connection: drop
            # the connection WITHOUT unpickling the body.
            raise AuthError("frame MAC verification failed")
    # Bulk data rides call_raw's RTR segment path, never this decoder.
    # graftlint: allow[hot-pickle] legacy control-frame codec
    return pickle.loads(body)


def _frame(obj, mac: Optional[_FrameMac] = None) -> bytes:
    # Raw-path payloads go through _write_raw as unpickled segments.
    # graftlint: allow[hot-pickle] legacy control-frame codec
    body = pickle.dumps(obj, protocol=5)
    out = _HDR.pack(_MAGIC, len(body)) + body
    if mac is not None:
        out += mac.seal(body)
    return out


def _write_raw(writer, mac: Optional[_FrameMac], kind: int,
               msg_id: Optional[int], method: str, m, payload) -> None:
    """Queue one RTR frame on `writer` (caller drains under its send lock).

    The bulk payload is written as its own segment — never concatenated
    into an intermediate buffer, never pickled; the MAC streams over the
    segments via seal_parts."""
    mb = method.encode()
    head = (_R_PRE.pack(kind, msg_id or 0, len(mb)) + mb
            + _R_MLEN.pack(len(m)) + bytes(m))
    writer.write(_HDR.pack(_R_MAGIC, len(head) + len(payload)))
    writer.write(head)
    if len(payload):
        writer.write(payload)
    if mac is not None:
        writer.write(mac.seal_parts(head, payload))


class RpcServer:
    """Serves named async handlers; handler(conn, **data) -> reply data."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._handlers: Dict[str, Callable[..., Awaitable[Any]]] = {}
        self._server: Optional[asyncio.Server] = None
        self._conns: set = set()
        self.on_disconnect: Optional[Callable[["ServerConnection"], Awaitable[None]]] = None

    def register(self, method: str, handler: Callable[..., Awaitable[Any]]):
        self._handlers[method] = handler

    def register_all(self, obj, prefix: str = "handle_"):
        for name in dir(obj):
            if name.startswith(prefix):
                self.register(name[len(prefix):], getattr(obj, name))

    def register_unported(self, component: str, methods) -> None:
        """Handlers the JAX package's `component` has and the port does not
        yet: each call raises the port's unported error, so a caller learns
        what is missing instead of a bare "no handler"."""
        from ray_tpu_torch.core.exceptions import _unported

        def refusal(method):
            async def refuse(conn, *args, **kwargs):
                raise _unported(f"the {component} handler {method!r}")
            return refuse

        for method in methods:
            self.register(method, refusal(method))

    async def start(self):
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    async def _on_conn(self, reader, writer):
        token = get_session_token()
        mac: Optional[_FrameMac] = None
        if token is not None:
            # Mutual challenge-response BEFORE any frame is read: a peer
            # that cannot produce HMAC(token, ...) is dropped without a
            # single pickle.loads of its bytes, and we prove knowledge of
            # the token back so the client talks to no impostor.
            import hmac as _hmac
            import os as _os

            sc = _os.urandom(_CHALLENGE_SIZE)
            try:
                writer.write(_AUTH_MAGIC + sc)
                await writer.drain()
                answer = await asyncio.wait_for(
                    reader.readexactly(_CHALLENGE_SIZE + 32), 10.0)
            except Exception:
                answer = None
            if answer is None or not _hmac.compare_digest(
                    answer[_CHALLENGE_SIZE:],
                    _client_proof(token, sc, answer[:_CHALLENGE_SIZE])):
                logger.warning(
                    "dropping unauthenticated connection from %s",
                    writer.get_extra_info("peername"))
                try:
                    writer.close()
                except Exception:
                    pass
                return
            cc = answer[:_CHALLENGE_SIZE]
            try:
                writer.write(_server_proof(token, sc, cc))
                await writer.drain()
            except Exception:
                try:
                    writer.close()
                except Exception:
                    pass
                return
            mac = _FrameMac(_session_mac_key(token, sc, cc), is_client=False)
        conn = ServerConnection(reader, writer, mac=mac)
        self._conns.add(conn)
        try:
            while True:
                try:
                    kind, msg_id, method, data = await _read_frame(
                        reader, mac, conn=conn)
                except (asyncio.IncompleteReadError, ConnectionResetError, EOFError):
                    break
                except AuthError as e:
                    logger.warning("dropping connection from %s: %s",
                                   conn.peername, e)
                    break
                except ProtocolMismatch as e:
                    logger.warning("dropping connection: %s", e)
                    # Best-effort: answer with OUR magic so a version-skewed
                    # ray_tpu_torch peer diagnoses the mismatch on its side too
                    # (its reader raises ProtocolMismatch naming versions)
                    # instead of seeing a bare EOF.
                    try:
                        writer.write(_frame((KIND_ERROR, None,
                                             "__protocol__", str(e)), mac))
                        await writer.drain()
                    except Exception:
                        pass
                    break
                if kind == KIND_REQUEST:
                    asyncio.ensure_future(self._dispatch(conn, msg_id, method, data))
                elif kind == KIND_PUSH:
                    asyncio.ensure_future(self._dispatch(conn, None, method, data))
        finally:
            self._conns.discard(conn)
            if self.on_disconnect is not None:
                try:
                    await self.on_disconnect(conn)
                except Exception:
                    logger.exception("on_disconnect handler failed")
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, conn, msg_id, method, data):
        handler = self._handlers.get(method)
        try:
            if handler is None:
                raise RpcError(f"no handler for method {method!r}")
            if _chaos_enabled():
                from ray_tpu_torch.runtime.chaos import chaos

                if await chaos().intercept_server(method):
                    return  # injected drop: caller times out (rpc_chaos.cc)
            if isinstance(data, Raw):
                result = await handler(conn, data.m, data.payload)
            else:
                result = await handler(conn, **data)
            if msg_id is not None:
                await conn.send((KIND_REPLY, msg_id, method, result))
        except Exception as e:
            if msg_id is not None:
                try:
                    await conn.send((KIND_ERROR, msg_id, method, e))
                except Exception:
                    logger.exception("failed to send error reply for %s", method)
            else:
                logger.exception("push handler %s failed", method)

    async def close(self):
        # Close live connections BEFORE wait_closed(): since 3.12,
        # wait_closed() blocks until every connection handler returns, and
        # our handlers run until the peer disconnects — two processes
        # closing their servers while holding clients to each other would
        # deadlock (GCS <-> raylet shutdown did exactly that).
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns):
            conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except asyncio.TimeoutError:
                pass


class ServerConnection:
    """Server side of one client connection (usable for pushes to client)."""

    def __init__(self, reader, writer, mac: Optional[_FrameMac] = None):
        self.reader = reader
        self.writer = writer
        self._mac = mac
        self._lock = asyncio.Lock()
        self.meta: Dict[str, Any] = {}  # handlers stash identity here

    async def send(self, payload):
        async with self._lock:
            # Sealing must happen under the lock: the MAC sequence number
            # must match the byte order frames hit the socket in.
            if isinstance(payload[3], Raw):
                kind, msg_id, method, pdata = payload
                _write_raw(self.writer, self._mac, kind, msg_id,
                           method or "", pdata.m, pdata.payload)
                await self.writer.drain()
                return
            data = _frame(payload, self._mac)
            self.writer.write(data)
            await self.writer.drain()

    async def push(self, method: str, data: dict):
        await self.send((KIND_PUSH, None, method, data))

    def close(self):
        try:
            self.writer.close()
        except Exception:
            pass

    @property
    def peername(self):
        try:
            return self.writer.get_extra_info("peername")
        except Exception:
            return None


class RpcClient:
    """Async client. Push frames from the server invoke `on_push`."""

    def __init__(self, host: str, port: int,
                 on_push: Optional[Callable[[str, dict], Awaitable[None]]] = None,
                 auto_reconnect: bool = False,
                 reconnect_timeout: float = 60.0,
                 on_reconnect: Optional[Callable[["RpcClient"],
                                                 Awaitable[None]]] = None):
        """auto_reconnect: on a lost connection, call() transparently redials
        (up to reconnect_timeout) and retries once — the
        retryable_grpc_client.cc analog for GCS restarts. on_reconnect runs
        after a successful redial (e.g. to resubscribe pubsub channels or
        re-register a node)."""
        self.host = host
        self.port = port
        self.on_push = on_push
        self.auto_reconnect = auto_reconnect
        self.reconnect_timeout = reconnect_timeout
        self.on_reconnect = on_reconnect
        self._reader = None
        self._writer = None
        self._mac: Optional[_FrameMac] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._lock: Optional[asyncio.Lock] = None
        self._recv_task = None
        self._closed = False
        self._dead = False
        self._reconnecting: Optional[asyncio.Future] = None

    async def connect(self, timeout: float = 30.0):
        deadline = asyncio.get_event_loop().time() + timeout
        delay = 0.02
        while True:
            try:
                self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
                break
            except OSError:
                if asyncio.get_event_loop().time() >= deadline:
                    raise
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.5)
        token = get_session_token()
        self._mac = None
        if token is not None:
            import hmac as _hmac
            import os as _os

            try:
                hello = await asyncio.wait_for(
                    self._reader.readexactly(len(_AUTH_MAGIC)
                                             + _CHALLENGE_SIZE), 10.0)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
                self._writer.close()
                raise AuthError(
                    "this process has a session token but the server did "
                    "not send an auth challenge (token/config mismatch)"
                ) from e
            if hello[:len(_AUTH_MAGIC)] != _AUTH_MAGIC:
                self._writer.close()
                raise AuthError(
                    f"expected auth challenge, got {hello[:4]!r}")
            sc = hello[len(_AUTH_MAGIC):]
            cc = _os.urandom(_CHALLENGE_SIZE)
            self._writer.write(cc + _client_proof(token, sc, cc))
            await self._writer.drain()
            # Mutual: the server must prove token knowledge BACK before we
            # parse a single frame from it — otherwise a spoofed endpoint
            # (port reuse after a raylet dies, TCP hijack) could feed this
            # process pickle frames.
            try:
                proof = await asyncio.wait_for(
                    self._reader.readexactly(32), 10.0)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
                self._writer.close()
                raise AuthError(
                    "server closed without proving token knowledge "
                    "(wrong token — multiple sessions on host? — or "
                    "impostor endpoint)") from e
            if not _hmac.compare_digest(proof,
                                        _server_proof(token, sc, cc)):
                self._writer.close()
                raise AuthError("server failed mutual authentication")
            self._mac = _FrameMac(_session_mac_key(token, sc, cc),
                                  is_client=True)
        self._lock = asyncio.Lock()
        self._recv_task = asyncio.ensure_future(self._recv_loop())
        return self

    async def _recv_loop(self):
        try:
            while True:
                kind, msg_id, method, data = await _read_frame(self._reader,
                                                               self._mac)
                if kind in (KIND_REPLY, KIND_ERROR):
                    fut = self._pending.pop(msg_id, None)
                    if fut is not None and not fut.done():
                        if kind == KIND_REPLY:
                            fut.set_result(data)
                        else:
                            fut.set_exception(data if isinstance(data, BaseException)
                                              else RpcError(str(data)))
                elif kind == KIND_PUSH and self.on_push is not None:
                    asyncio.ensure_future(self._run_push(method, data))
        except (asyncio.IncompleteReadError, ConnectionResetError, EOFError, OSError):
            pass
        except AuthError as e:
            # Injected bytes on the wire: poison the connection, never
            # unpickle. Reconnect (if enabled) re-runs the handshake.
            logger.error("dropping connection to %s:%s: %s",
                         self.host, self.port, e)
        except ProtocolMismatch as e:
            # Version skew is terminal and loud: no reconnect churn against
            # an incompatible peer, pending calls see the real reason.
            logger.error("wire protocol mismatch with %s:%s: %s",
                         self.host, self.port, e)
            self._closed = True
            self._dead = True
            self._fail_pending(e)
            return
        except Exception:
            logger.exception("rpc client recv loop error")
        finally:
            self._dead = True
            self._fail_pending(ConnectionLost(f"connection to {self.host}:{self.port} lost"))

    async def _run_push(self, method, data):
        try:
            await self.on_push(method, data)
        except Exception:
            logger.exception("push handler for %s failed", method)

    def _fail_pending(self, exc):
        for fut in self._pending.values():
            if not fut.done():
                try:
                    fut.set_exception(exc)
                    fut.exception()  # mark retrieved; avoid GC warnings
                except RuntimeError:
                    pass  # event loop already closed (interpreter shutdown)
        self._pending.clear()

    async def _reconnect(self):
        """Single-flight redial; concurrent callers share one attempt."""
        if self._reconnecting is not None:
            await asyncio.shield(self._reconnecting)
            if self._dead:
                raise ConnectionLost(
                    f"reconnect to {self.host}:{self.port} failed")
            return
        self._reconnecting = asyncio.get_event_loop().create_future()
        try:
            if self._recv_task is not None:
                self._recv_task.cancel()
            await self.connect(timeout=self.reconnect_timeout)
            self._dead = False
            if self.on_reconnect is not None:
                try:
                    await self.on_reconnect(self)
                except Exception:
                    logger.exception("on_reconnect callback failed")
            logger.info("reconnected to %s:%d", self.host, self.port)
        finally:
            fut, self._reconnecting = self._reconnecting, None
            if not fut.done():
                fut.set_result(None)

    async def call(self, method: str, timeout: Optional[float] = None, **data):
        attempts = 2 if self.auto_reconnect else 1
        for attempt in range(attempts):
            if self._dead and self.auto_reconnect and not self._closed:
                await self._reconnect()
            if self._closed or self._dead:
                raise ConnectionLost(
                    f"connection to {self.host}:{self.port} closed"
                    if self._closed
                    else f"connection to {self.host}:{self.port} lost")
            try:
                return await self._call_once(method, timeout, data)
            except ConnectionLost:
                if attempt == attempts - 1 or self._closed:
                    raise
                # Retry once after redial. GCS-side handlers are idempotent
                # (register/heartbeat/kv/publish); lease-protocol calls use
                # non-reconnecting clients so double-grants can't happen.

    async def call_send(self, method: str, **data) -> asyncio.Future:
        """Send a request NOW (write completes before this returns) and
        hand back the pending reply future without awaiting it. Callers
        that must guarantee wire order across many logical tasks (the
        actor-submission pump) send from ONE ordered coroutine via this
        and await replies concurrently elsewhere — spawning whole call
        coroutines per task lets late tasks overtake early ones that are
        still parked on a connection-setup lock."""
        if self._closed or self._dead:
            raise ConnectionLost(
                f"connection to {self.host}:{self.port} "
                + ("closed" if self._closed else "lost"))
        if _chaos_enabled():
            await _chaos_client(method)  # may raise/delay
        self._next_id += 1
        msg_id = self._next_id
        fut = asyncio.get_event_loop().create_future()
        self._pending[msg_id] = fut
        try:
            async with self._lock:
                # Seal under the lock: MAC sequence == socket byte order.
                payload = _frame((KIND_REQUEST, msg_id, method, data),
                                 self._mac)
                self._writer.write(payload)
                await self._writer.drain()
        except (ConnectionResetError, OSError) as e:
            self._pending.pop(msg_id, None)
            # Mark the transport dead so the retry loop in call() redials
            # instead of re-entering on the same broken writer (the recv
            # task may not have observed the failure yet).
            self._dead = True
            raise ConnectionLost(str(e))
        return fut

    async def _call_once(self, method: str, timeout: Optional[float], data):
        fut = await self.call_send(method, **data)
        if timeout is not None:
            return await asyncio.wait_for(fut, timeout)
        return await fut

    async def call_raw(self, method: str, m: bytes = b"", payload=b"",
                       timeout: Optional[float] = None):
        """Zero-pickle call: ships a schema'd header `m` (wire.Message
        bytes) plus an out-of-band bulk `payload` as one RTR frame and
        returns `(m_reply, payload_view)`. Neither direction runs pickle;
        the reply payload is a memoryview over the receive buffer. A
        handler error surfaces as the usual pickled error reply, raised
        here as RpcError."""
        if self._closed or self._dead:
            raise ConnectionLost(
                f"connection to {self.host}:{self.port} "
                + ("closed" if self._closed else "lost"))
        if _chaos_enabled():
            await _chaos_client(method)
        self._next_id += 1
        msg_id = self._next_id
        fut = asyncio.get_event_loop().create_future()
        self._pending[msg_id] = fut
        try:
            async with self._lock:
                _write_raw(self._writer, self._mac, KIND_REQUEST, msg_id,
                           method, m, payload)
                await self._writer.drain()
        except (ConnectionResetError, OSError) as e:
            self._pending.pop(msg_id, None)
            self._dead = True
            raise ConnectionLost(str(e))
        data = await (asyncio.wait_for(fut, timeout)
                      if timeout is not None else fut)
        if isinstance(data, Raw):
            return data.m, data.payload
        return data, b""  # peer answered with a pickled reply: tolerate

    async def push(self, method: str, **data):
        async with self._lock:
            payload = _frame((KIND_PUSH, None, method, data), self._mac)
            self._writer.write(payload)
            await self._writer.drain()

    async def close(self):
        self._closed = True
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass


class EventLoopThread:
    """A dedicated asyncio loop in a daemon thread.

    Drivers and workers are synchronous Python; all RPC I/O runs on this loop
    (the asio io_context analog, reference:
    src/ray/common/asio/instrumented_io_context.h).
    """

    def __init__(self, name: str = "ray_tpu_io"):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        if threading.current_thread() is self.thread:
            # Blocking on our own loop can never complete — fail loudly
            # instead of deadlocking the whole process.
            coro.close()
            raise RuntimeError(
                "EventLoopThread.run() called from the loop thread itself; "
                "use spawn() or await the coroutine")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)
