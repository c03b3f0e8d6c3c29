"""Worker process: executes tasks and hosts actors.

Reference analog: the worker side of src/ray/core_worker/ — HandlePushTask
(core_worker.cc:3810) -> TaskReceiver -> ExecuteTask (:3229), actor creation
(:2556 target side), with the Python function loading of
python/ray/_private/function_manager.py (pickled defs from GCS KV).

The process runs two halves:
  * an asyncio RPC server (this module) that receives pushed tasks, and
  * a CoreWorker (ray_tpu_torch.core.worker) so user code inside tasks can submit
    nested tasks / use the object store — the full API works in workers.
Execution happens on a thread pool (serial by default; actors can raise
max_concurrency), keeping the IO loop responsive.

The port's copy of ray_tpu/runtime/worker_main.py. The process starts
without importing torch; a task or actor that needs it imports it, and
sees only the cards its lease holds (the raylet set CUDA_VISIBLE_DEVICES
when it started this process). runtime_env, the compiled-graph (DAG) loop
and the span/stack/object dumps are not ported: the DAG loop and the
dumps refuse.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import logging
import os
import sys
import threading
import traceback
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.exceptions import TaskError, _unported
from ray_tpu_torch.core.task_spec import ActorSpec, TaskSpec
from ray_tpu_torch.config import cfg
from ray_tpu_torch.core.worker import CoreWorker, set_global_worker
from ray_tpu_torch.runtime.rpc import RpcClient, RpcServer
from ray_tpu_torch.utils.ids import ObjectID, TaskID

logger = logging.getLogger(__name__)

# Handlers of the JAX package's worker not ported yet (ROADMAP.md queue 1
# item 6).
UNPORTED_HANDLERS = ("dump_spans", "dump_stacks", "list_objects")


class WorkerRuntime:
    def __init__(self):
        self.worker_id = bytes.fromhex(os.environ["RAY_TPU_TORCH_WORKER_ID"])
        self.node_id = bytes.fromhex(os.environ["RAY_TPU_TORCH_NODE_ID"])
        raylet = os.environ["RAY_TPU_TORCH_RAYLET_ADDR"].rsplit(":", 1)
        gcs = os.environ["RAY_TPU_TORCH_GCS_ADDR"].rsplit(":", 1)
        self.raylet_addr = (raylet[0], int(raylet[1]))
        self.gcs_addr = (gcs[0], int(gcs[1]))
        self.store_path = os.environ["RAY_TPU_TORCH_STORE_PATH"]
        self.session_dir = os.environ["RAY_TPU_TORCH_SESSION_DIR"]
        self.server = RpcServer("127.0.0.1", 0)
        self.server.register_all(self)
        self.server.register_unported("worker", UNPORTED_HANDLERS)
        self.core: Optional[CoreWorker] = None
        self.exec_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task_exec")
        self.fn_cache: Dict[bytes, Any] = {}
        self._running_threads: Dict[bytes, int] = {}  # task_id -> thread id
        self._running_async: Dict[bytes, "asyncio.Task"] = {}
        self.actor_instance = None
        self.actor_spec: Optional[ActorSpec] = None
        self._raylet_client: Optional[RpcClient] = None
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._async_sem: Optional[asyncio.Semaphore] = None
        self._tasks_pending = 0   # pushed, not yet finished (queued + running)

    async def start(self):
        self.loop = asyncio.get_event_loop()
        # CoreWorker first: user code needs the full API during tasks.
        self.core = CoreWorker(
            mode="worker", gcs_address=self.gcs_addr,
            raylet_address=self.raylet_addr, store_path=self.store_path,
            session_dir=self.session_dir, node_id=self.node_id)
        set_global_worker(self.core)
        await self.server.start()
        self._raylet_client = RpcClient(*self.raylet_addr)
        await self._raylet_client.connect(timeout=30)
        await self._raylet_client.call(
            "worker_ready", worker_id=self.worker_id, address=self.server.address)
        asyncio.ensure_future(self._orphan_watchdog())
        logger.info("worker %s ready at %s", self.worker_id.hex()[:12],
                    self.server.address)

    async def _orphan_watchdog(self):
        """Exit when our raylet goes away (worker processes must not outlive
        their node, even when the raylet is SIGKILLed)."""
        while not self._raylet_client._dead:
            await asyncio.sleep(1.0)
        logger.warning("raylet connection lost; worker exiting")
        os._exit(1)

    # ---- function/class loading (function_manager.py analog) -------------

    def _load_function(self, fn_id: bytes):
        fn = self.fn_cache.get(fn_id)
        if fn is None:
            reply = self.core.io.run(self.core.gcs.call("kv_get", key=b"fn:" + fn_id))
            blob = reply["value"]
            if blob is None:
                raise RuntimeError(f"function {fn_id.hex()[:12]} not found in GCS")
            fn = cloudpickle.loads(blob)
            self.fn_cache[fn_id] = fn
        return fn

    def _load_class(self, class_id: bytes):
        cls = self.fn_cache.get(class_id)
        if cls is None:
            reply = self.core.io.run(self.core.gcs.call("kv_get", key=b"cls:" + class_id))
            blob = reply["value"]
            if blob is None:
                raise RuntimeError(f"class {class_id.hex()[:12]} not found in GCS")
            cls = cloudpickle.loads(blob)
            self.fn_cache[class_id] = cls
        return cls

    # ---- task execution ---------------------------------------------------

    STREAMING = -1  # num_returns sentinel (see CoreWorker.STREAMING)

    def _seal_return(self, oid: bytes, segments, total: int) -> None:
        """Write one large return value into the local plasma store."""
        store = self.core.store
        if store.contains(oid):
            # Retry of a task whose previous attempt already sealed this
            # return: reuse it (ids are deterministic).
            return
        # A crashed previous attempt may have left an unsealed create
        # behind; reclaim the id.
        store.abort(oid)
        buf = self.core.spill_create(oid, total)
        try:
            serialization.write_segments(buf, segments)
        except BaseException:
            buf.release()
            store.abort(oid)
            raise
        buf.release()
        store.seal(oid)

    def _package_returns(self, spec: TaskSpec, result) -> list:
        returns = []
        values = (result,) if spec.num_returns == 1 else tuple(result)
        if spec.num_returns > 1 and len(values) != spec.num_returns:
            raise ValueError(
                f"task declared num_returns={spec.num_returns} but returned "
                f"{len(values)} values")
        for i, value in enumerate(values):
            segments, total, contained = serialization.serialize_with_refs(
                value)
            oid = ObjectID.for_task_return(TaskID(spec.task_id), i).binary()
            # Nested refs in the return value: pin them with their owners
            # NOW (while this worker still holds borrows), keyed by the
            # return oid; the caller records the children and unpins when it
            # frees the return (reference_count.h nested-ref invariant).
            children = self._pin_return_children(oid, contained)
            if total <= cfg().inline_result_max:
                returns.append(("v", serialization.join_segments(segments),
                                children))
            else:
                self._seal_return(oid, segments, total)
                returns.append(("r", oid, children))
        return returns

    def _pin_return_children(self, container_oid: bytes, contained) -> list:
        children = []
        for ref in contained:
            child = ref.binary()
            addr = ref.owner_addr
            children.append((child, addr))
            if addr is None or tuple(addr) == tuple(self.core.owner_addr):
                with self.core._mem_lock:
                    rec = self.core._owned.get(child)
                    if rec is not None:
                        rec["containers"].add(container_oid)
            else:
                # Synchronous on the io loop caller context: we are on the
                # exec thread, so round-trip through the loop and WAIT — the
                # pin must land before the reply releases our borrows.
                asyncio.run_coroutine_threadsafe(
                    self.core._owner_call(tuple(addr), "pin_container",
                                          oid=child, container=container_oid),
                    self.core.io.loop).result(timeout=30)
        return children

    def _push_gen_item(self, conn, spec: TaskSpec, index: int, value) -> None:
        """Report one yielded item to the submitter (blocking, from the exec
        thread): small values ride the push inline; large values seal to the
        local plasma store and only the location is pushed.
        ReportGeneratorItemReturns analog (core_worker.proto:462)."""
        segments, total = serialization.serialize(value)
        msg = {"task_id": spec.task_id, "index": index,
               "node_id": self.node_id}
        if total <= cfg().inline_result_max or self.core.store is None:
            msg["payload"] = serialization.join_segments(segments)
        else:
            oid = ObjectID.for_task_return(TaskID(spec.task_id), index).binary()
            self._seal_return(oid, segments, total)
        asyncio.run_coroutine_threadsafe(
            conn.push("gen_item", msg), self.loop).result(timeout=60)

    def _stream_generator(self, conn, spec: TaskSpec, gen) -> dict:
        """Drain a sync generator, pushing each item; the final reply carries
        the item count (also on error, so the caller drains then raises)."""
        count = 0
        try:
            for item in gen:
                self._push_gen_item(conn, spec, count, item)
                count += 1
            return {"status": "ok", "streamed": count,
                    "node_id": self.node_id}
        except Exception as e:
            tb = traceback.format_exc()
            logger.error("streaming task %s failed at item %d:\n%s",
                         spec.name, count, tb)
            return {"status": "error", "streamed": count,
                    "error": TaskError(spec.name, tb, cause=_safe_cause(e))}

    def _execute(self, fn, spec: TaskSpec, conn=None) -> dict:
        """Runs on the exec thread; returns the RPC reply."""
        import threading

        from ray_tpu_torch.util import tracing

        # Cancellation registry: cancel_task injects TaskCancelledError
        # into this thread by id (ray.cancel analog; best-effort — a
        # blocking C call won't notice until it returns to Python).
        self._running_threads[spec.task_id] = threading.get_ident()
        from ray_tpu_torch.core import blocked as blocked_mod

        # Thread -> task attribution for stack dumps and wait-graph edges:
        # anything this thread blocks on is charged to this task/actor.
        blocked_mod.set_task_context(threading.get_ident(), {
            "task_id": spec.task_id.hex(),
            "name": spec.name,
            "actor_id": spec.actor_id.hex() if spec.actor_id else None,
        })
        try:
            args, kwargs = self.core.resolve_args(spec)
            self.core.current_task_name = spec.name
            # Adopt the submitter's trace context (TaskSpec wire fields
            # 17/18) so this execute span — and any nested submits the
            # task body makes — stitch under the driver's span by id.
            with tracing.trace_context(spec.trace_id, spec.parent_span_id), \
                    tracing.span(spec.name, "task:execute",
                                 task_id=spec.task_id.hex()[:12]):
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    # Sync-invoked coroutine (async def run through the
                    # thread-pool path): run it to completion on a private
                    # loop in this thread.
                    result = asyncio.run(result)
                if spec.num_returns == self.STREAMING:
                    if not inspect.isgenerator(result):
                        raise TypeError(
                            'num_returns="streaming" requires the task to '
                            "return a generator")
                    return self._stream_generator(conn, spec, result)
            returns = self._package_returns(spec, result)
            return {"status": "ok", "returns": returns, "node_id": self.node_id}
        except Exception as e:
            from ray_tpu_torch.core.exceptions import TaskCancelledError

            if isinstance(e, TaskCancelledError):
                logger.info("task %s cancelled", spec.name)
                return {"status": "error", "error": e}
            tb = traceback.format_exc()
            logger.error("task %s failed:\n%s", spec.name, tb)
            return {"status": "error",
                    "error": TaskError(spec.name, tb, cause=_safe_cause(e))}
        finally:
            self._running_threads.pop(spec.task_id, None)
            blocked_mod.set_task_context(threading.get_ident(), None)
            self.core.current_task_name = None

    async def _execute_async(self, fn, spec: TaskSpec, conn=None) -> dict:
        """Async execution path: coroutine and async-generator functions run
        directly on the worker's event loop (concurrency-group analog —
        reference: core_worker/transport/concurrency_group_manager.h with
        fibers; ours are asyncio tasks bounded by a semaphore). Blocking prep
        (arg resolution from plasma) stays off-loop."""
        loop = asyncio.get_event_loop()
        sem = self._async_sem
        if sem is None:
            sem = self._async_sem = asyncio.Semaphore(100)
        async with sem:
            try:
                args, kwargs = await loop.run_in_executor(
                    None, self.core.resolve_args, spec)
                self.core.current_task_name = spec.name
                if inspect.isasyncgenfunction(getattr(fn, "__func__", fn)):
                    if spec.num_returns != self.STREAMING:
                        raise TypeError(
                            "async generator methods require "
                            'num_returns="streaming"')
                    count = 0
                    try:
                        async for item in fn(*args, **kwargs):
                            await loop.run_in_executor(
                                None, self._push_gen_item_sealed, spec, count,
                                item, conn)
                            count += 1
                        return {"status": "ok", "streamed": count,
                                "node_id": self.node_id}
                    except Exception as e:
                        tb = traceback.format_exc()
                        logger.error("async streaming %s failed:\n%s",
                                     spec.name, tb)
                        return {"status": "error", "streamed": count,
                                "error": TaskError(spec.name, tb,
                                                   cause=_safe_cause(e))}
                result = await fn(*args, **kwargs)
                if spec.num_returns == self.STREAMING:
                    if not inspect.isgenerator(result):
                        raise TypeError(
                            'num_returns="streaming" requires a generator')
                    return await loop.run_in_executor(
                        None, self._stream_generator, conn, spec, result)
                returns = await loop.run_in_executor(
                    None, self._package_returns, spec, result)
                return {"status": "ok", "returns": returns,
                        "node_id": self.node_id}
            except Exception as e:
                tb = traceback.format_exc()
                logger.error("async task %s failed:\n%s", spec.name, tb)
                return {"status": "error",
                        "error": TaskError(spec.name, tb,
                                           cause=_safe_cause(e))}
            finally:
                self.core.current_task_name = None

    def _push_gen_item_sealed(self, spec, index, item, conn):
        """Executor-thread shim so async generators reuse the blocking push
        (which itself round-trips through the loop for the socket write)."""
        self._push_gen_item(conn, spec, index, item)

    @staticmethod
    def _is_async_callable(fn) -> bool:
        target = getattr(fn, "__func__", fn)
        return (inspect.iscoroutinefunction(target)
                or inspect.isasyncgenfunction(target))

    async def _tracked(self, awaitable):
        """Count in-flight executions (queued + running) for actor_stats."""
        self._tasks_pending += 1
        try:
            return await awaitable
        finally:
            self._tasks_pending -= 1

    async def _drain_borrows(self):
        """Borrow RPCs spawned while deserializing args/results must land
        before the reply releases the submitter's pins (use-after-free
        window otherwise — see CoreWorker.register_ref)."""
        futs = self.core.take_pending_borrows()
        if futs:
            await asyncio.gather(
                *[asyncio.wrap_future(f) for f in futs],
                return_exceptions=True)

    async def handle_push_task2(self, conn, m: bytes):
        """Typed-schema task push (wire.TaskSpecMsg in, TaskReplyMsg out):
        the envelope evolves per-field across versions; args/returns stay
        pickled payloads."""
        from ray_tpu_torch.runtime import wire

        reply = await self._run_task(conn, TaskSpec.from_wire(m))
        return wire.TaskReplyMsg.from_reply(reply).encode()

    async def handle_push_actor_task2(self, conn, m: bytes):
        """Typed-schema actor call (same envelope: TaskSpecMsg carries
        actor_id/method_name/seq_no for the ordered actor send path)."""
        from ray_tpu_torch.runtime import wire

        reply = await self._run_actor_task(conn, TaskSpec.from_wire(m))
        return wire.TaskReplyMsg.from_reply(reply).encode()

    async def _run_task(self, conn, spec: TaskSpec):
        fn = self._load_function(spec.fn_id)
        loop = asyncio.get_event_loop()
        if self._is_async_callable(fn):
            exec_task = asyncio.ensure_future(
                self._execute_async(fn, spec, conn))
            self._running_async[spec.task_id] = exec_task
            try:
                reply = await self._tracked(exec_task)
            except asyncio.CancelledError:
                from ray_tpu_torch.core.exceptions import TaskCancelledError

                reply = {"status": "error", "error": TaskCancelledError(
                    f"task {spec.name} was cancelled")}
            finally:
                self._running_async.pop(spec.task_id, None)
        else:
            reply = await self._tracked(loop.run_in_executor(
                self.exec_pool, self._execute, fn, spec, conn))
        await self._drain_borrows()
        return reply

    async def handle_cancel_task(self, conn, task_id: bytes,
                                 force: bool = False):
        """Best-effort in-flight cancellation (ray.cancel analog).

        Sync tasks: TaskCancelledError is raised asynchronously in the
        executing thread (PyThreadState_SetAsyncExc — takes effect at the
        next Python bytecode; a blocking C call defers it). Async tasks:
        the asyncio task is cancelled. force=True exits the worker
        process after replying — the owner maps the resulting connection
        loss to TaskCancelledError, never a retry."""
        import ctypes

        from ray_tpu_torch.core.exceptions import TaskCancelledError

        delivered = False
        atask = self._running_async.get(task_id)
        if atask is not None and not atask.done():
            atask.cancel()
            delivered = True
        tid = self._running_threads.get(task_id)
        if not delivered and tid is not None:
            n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(TaskCancelledError))
            delivered = n == 1
            if delivered and self._running_threads.get(task_id) != tid:
                # TOCTOU: the target finished and the reused pool thread
                # started a DIFFERENT task between lookup and injection —
                # revoke before the pending exception fires in it.
                # bare None ctypes-converts to NULL = "clear pending exc"
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(tid), None)
                delivered = False
        if force and (delivered or tid is not None or atask is not None):
            loop = asyncio.get_event_loop()
            loop.call_later(0.05, os._exit, 1)
        return {"ok": delivered, "force": force}

    # ---- actor lifecycle --------------------------------------------------

    async def handle_create_actor(self, conn, spec: ActorSpec):
        logger.debug("create_actor %s (%s) max_concurrency=%d",
                     spec.actor_id.hex()[:12], spec.class_name,
                     spec.max_concurrency)

        def _create():
            cls = self._load_class(spec.class_id)
            args, kwargs = self.core.resolve_args(
                TaskSpec(task_id=b"\0" * 20, fn_id=b"", name="__init__",
                         args=spec.args, kwarg_names=spec.kwarg_names))
            self.actor_instance = cls(*args, **kwargs)
            self.actor_spec = spec
            self.core.current_actor_id = spec.actor_id
            return {"ok": True}

        if spec.max_concurrency > 1:
            self.exec_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=spec.max_concurrency, thread_name_prefix="actor_exec")
            self._async_sem = asyncio.Semaphore(spec.max_concurrency)
        else:
            # Async actors default to high concurrency unless the user caps
            # it (reference: async actors' max_concurrency defaults to 1000).
            self._async_sem = asyncio.Semaphore(1000)
        loop = asyncio.get_event_loop()
        try:
            result = await loop.run_in_executor(self.exec_pool, _create)
            logger.debug("create_actor %s: instance constructed",
                         spec.actor_id.hex()[:12])
            # Borrow RPCs for ObjectRefs deserialized in constructor args
            # must land before the creator sees the reply and unpins them
            # (same window _run_task closes).
            await self._drain_borrows()
            logger.debug("create_actor %s: borrows drained",
                         spec.actor_id.hex()[:12])
            await self._raylet_client.call("mark_actor", worker_id=self.worker_id,
                                           actor_id=spec.actor_id)
            logger.debug("create_actor %s: marked", spec.actor_id.hex()[:12])
            return result
        except Exception as e:
            tb = traceback.format_exc()
            logger.error("actor creation failed:\n%s", tb)
            return {"ok": False, "error": f"{e!r}\n{tb}"}

    async def _run_actor_task(self, conn, spec: TaskSpec):
        if self.actor_instance is None:
            return {"status": "error",
                    "error": TaskError(spec.name, "no actor instance on this worker")}
        if spec.method_name == "__ray_dag_loop__":
            # The JAX package's compiled-graph loop (dag/executor.py there).
            return {"status": "error",
                    "error": TaskError(spec.name, repr(_unported(
                        "the compiled-graph (DAG) loop")))}
        method = getattr(self.actor_instance, spec.method_name, None)
        if method is None:
            return {"status": "error",
                    "error": TaskError(
                        spec.name,
                        f"actor has no method {spec.method_name!r}")}
        loop = asyncio.get_event_loop()
        if self._is_async_callable(method):
            reply = await self._tracked(self._execute_async(method, spec, conn))
        else:
            reply = await self._tracked(loop.run_in_executor(
                self.exec_pool, self._execute, method, spec, conn))
        await self._drain_borrows()
        return reply

    async def handle_actor_stats(self, conn):
        """Execution-queue stats, served directly on the IO loop so callers
        (serve autoscaling) never queue behind user code."""
        return {"pending": self._tasks_pending,
                "max_concurrency": (self.actor_spec.max_concurrency
                                    if self.actor_spec else 1)}

    async def handle_ping(self, conn):
        return {"ok": True}

    async def handle_exit(self, conn):
        asyncio.get_event_loop().call_later(0.05, sys.exit, 0)
        return {"ok": True}


def _safe_cause(e: BaseException):
    """Exceptions must survive pickling across the wire; fall back to repr."""
    try:
        cloudpickle.dumps(e)
        return e
    except Exception:
        return None


def main():
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="[worker %(asctime)s %(levelname)s %(name)s] %(message)s")
    from ray_tpu_torch.utils.debug import register_stack_dump_signal

    register_stack_dump_signal()
    runtime = WorkerRuntime()

    async def run():
        await runtime.start()
        await asyncio.Event().wait()  # serve until killed

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
