"""The in-process runtime: tasks and actors on daemon threads, objects in a
dict (the thread-execution half of ray_tpu/core/runtime.py).

What serve needs, with the reference's semantics:
- ``put`` / ``get`` / ``get_async`` / ``wait`` over one store guarded by one
  condition variable. ``get`` raises ``GetTimeoutError`` at its deadline and
  re-raises a task's error as ``TaskError`` carrying the original.
- Tasks on a bounded pool of daemon threads, admitted against the ``CPU``
  and ``GPU`` resources given to ``init``. A call returns one ref, or, with
  ``num_returns="streaming"``, an ``ObjectRefGenerator``.
- Thread actors: one mailbox each, served by up to ``max_concurrency``
  threads that start as calls back up; named actors and ``get_if_exists``;
  ``num_returns="streaming"`` methods that feed an ``ObjectRefGenerator``
  item by item; ``kill``, after which pending and new calls fail with
  ``ActorDiedError``.
- ``shutdown`` poisons every mailbox, fails every unresolved ref, joins every
  thread against one deadline and clears the global runtime.

Nothing leaves the process: no worker process, no shared memory, no native
store, no RPC. Every thread is a daemon thread, and every wait wakes at
least every ``_WAIT_SLICE_S`` to see a shutdown.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional

from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, RayTpuError, TaskError

STREAMING = "streaming"
_WAIT_SLICE_S = 0.5
_MAX_TASK_THREADS = 64  # the task pool's bound; resources bound it further
_SHUTDOWN_JOIN_S = 10.0

_runtime: Optional["Runtime"] = None


def get_runtime() -> "Runtime":
    if _runtime is None:
        raise RayTpuError("ray_tpu_torch is not initialized; call ray_tpu_torch.init()")
    return _runtime


def get_runtime_or_none() -> Optional["Runtime"]:
    return _runtime


def set_runtime(rt: Optional["Runtime"]) -> None:
    global _runtime
    _runtime = rt


class _Call:
    """One task or actor-method call: what to run and where its result goes
    (``oid`` for a plain return, ``stream_id`` for a streaming call)."""

    __slots__ = ("fn", "args", "kwargs", "oid", "stream_id", "desc")

    def __init__(self, fn, args, kwargs, oid, stream_id, desc):
        self.fn, self.args, self.kwargs = fn, args, kwargs
        self.oid, self.stream_id, self.desc = oid, stream_id, desc


class _Stream:
    __slots__ = ("items", "done")

    def __init__(self):
        self.items: list = []  # (is_error, value); a consumed item becomes None
        self.done = False


class _Actor:
    def __init__(self, actor_id: ActorID, cls, args, kwargs, opts: dict,
                 resources: dict, ready_ref: ObjectRef):
        self.actor_id = actor_id
        self.cls = cls
        self.args, self.kwargs = args, kwargs
        self.name = opts.get("name")
        self.max_concurrency = max(1, int(opts.get("max_concurrency", 1)))
        self.resources = resources
        self.ready_ref = ready_ref  # resolves when __init__ returns (or raises)
        self.mailbox: "queue.Queue" = queue.Queue()
        self.lock = threading.Lock()  # state, instance, threads, idle, mailbox puts
        self.state = "PENDING"  # -> ALIVE -> DEAD, or PENDING -> DEAD
        self.death_cause = ""
        self.instance = None
        self.threads: list[threading.Thread] = []
        self.idle = 0  # threads free for a new call (see Runtime._claim)
        self.holds_resources = False


class Runtime:
    def __init__(self, resources: dict[str, float]):
        self.job_id = JobID.from_random()
        self._put_owner = TaskID.for_normal_task(self.job_id)  # the task id puts carry
        self.is_shutdown = False
        # One condition variable guards the store, the streams, the
        # resources and the task pool. Reentrant: an ObjectRef may be
        # collected, and count itself out, while its thread holds it.
        self._cv = threading.Condition(threading.RLock())
        self._objects: dict[ObjectID, tuple[bool, Any]] = {}  # oid -> (is_error, value)
        self._refcounts: dict[ObjectID, int] = {}
        self._callbacks: dict[ObjectID, list[Callable]] = {}
        self._streams: dict[ObjectID, _Stream] = {}
        self._put_index = 0
        self._total = {k: float(v) for k, v in resources.items()}
        self._avail = dict(self._total)
        self._pending: collections.deque = collections.deque()  # (request, start, fail)
        self._task_queue: "queue.Queue" = queue.Queue()
        self._task_threads = 0
        self._idle_task_threads = 0
        self._actors: dict[ActorID, _Actor] = {}
        self._named: dict[str, ActorID] = {}
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------ objects
    def add_ref(self, oid: ObjectID) -> None:
        with self._cv:
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1

    def remove_ref(self, oid: ObjectID) -> None:
        with self._cv:
            n = self._refcounts.get(oid, 0) - 1
            if n > 0:
                self._refcounts[oid] = n
            else:
                self._refcounts.pop(oid, None)
                self._objects.pop(oid, None)

    def _store(self, oid: ObjectID, is_error: bool, value: Any) -> None:
        """Seal ``oid`` once: kept only while a ref to it lives; the
        callbacks of ``get_async`` run outside the lock."""
        with self._cv:
            if oid in self._objects:
                return
            if oid in self._refcounts:
                self._objects[oid] = (is_error, value)
            callbacks = self._callbacks.pop(oid, ())
            self._cv.notify_all()
        for cb in callbacks:
            cb(is_error, value)

    def put(self, value: Any) -> ObjectRef:
        with self._cv:
            self._put_index += 1
            oid = ObjectID.for_put(self._put_owner, self._put_index)
        ref = ObjectRef(oid, self)
        self._store(oid, False, value)
        return ref

    def _deadline(self, timeout: float | None) -> float | None:
        return None if timeout is None else time.monotonic() + timeout

    def _wait_slice(self, deadline: float | None, what: str) -> None:
        """One bounded wait on the condition (caller holds it); raises at the
        deadline or once the runtime is shut down."""
        if self.is_shutdown:
            raise RayTpuError(f"ray_tpu_torch was shut down while waiting for {what}")
        if deadline is None:
            self._cv.wait(_WAIT_SLICE_S)
            return
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise GetTimeoutError(f"timed out waiting for {what}")
        self._cv.wait(min(remaining, _WAIT_SLICE_S))

    def get(self, refs: list[ObjectRef], timeout: float | None = None) -> list[Any]:
        deadline = self._deadline(timeout)
        out = []
        with self._cv:
            for ref in refs:
                while ref._id not in self._objects:
                    self._wait_slice(deadline, repr(ref))
                is_error, value = self._objects[ref._id]
                if is_error:
                    raise value
                out.append(value)
        return out

    def get_async(self, ref: ObjectRef) -> Future:
        """A future resolved by the store when ``ref``'s object arrives; no
        thread parks for it. The callback holds ``ref`` until then."""
        fut: Future = Future()

        def resolve(is_error, value, _hold=ref):
            if is_error:
                fut.set_exception(value)
            else:
                fut.set_result(value)

        with self._cv:
            sealed = self._objects.get(ref._id)
            if sealed is None:
                self._callbacks.setdefault(ref._id, []).append(resolve)
                return fut
        resolve(*sealed)
        return fut

    def wait(self, refs: list[ObjectRef], num_returns: int = 1,
             timeout: float | None = None) -> tuple[list, list]:
        if not 0 <= num_returns <= len(refs):
            raise ValueError(f"num_returns {num_returns} must be within 0..{len(refs)}")
        deadline = self._deadline(timeout)
        with self._cv:
            while True:
                ready = [r for r in refs if r._id in self._objects]
                if len(ready) >= num_returns or (
                        deadline is not None and time.monotonic() >= deadline):
                    break
                self._wait_slice(deadline, f"{num_returns} of {len(refs)} refs")
        ready = ready[:num_returns]
        taken = set(r._id for r in ready)
        return ready, [r for r in refs if r._id not in taken]

    # ------------------------------------------------------------ streams
    def _new_stream(self, task_id: TaskID) -> ObjectRefGenerator:
        sid = ObjectID.for_task_return(task_id, 0)
        with self._cv:
            self._streams[sid] = _Stream()
        return ObjectRefGenerator(sid, self)

    def _stream_put(self, sid: ObjectID, is_error: bool, value: Any) -> None:
        with self._cv:
            st = self._streams.get(sid)
            if st is not None and not st.done:
                st.items.append((is_error, value))
                self._cv.notify_all()

    def _stream_end(self, sid: ObjectID) -> None:
        with self._cv:
            st = self._streams.get(sid)
            if st is not None:
                st.done = True
                self._cv.notify_all()

    def next_stream_item(self, sid: ObjectID, index: int,
                         timeout: float | None = None) -> Optional[ObjectRef]:
        """The ref of item ``index`` once it is produced; None at the end."""
        deadline = self._deadline(timeout)
        with self._cv:
            while True:
                st = self._streams.get(sid)
                if st is None:
                    return None
                if index < len(st.items):
                    is_error, value = st.items[index]
                    st.items[index] = None
                    break
                if st.done:
                    return None
                self._wait_slice(deadline, f"stream item {index}")
        ref = ObjectRef(ObjectID.for_task_return(sid.task_id(), index + 1), self)
        self._store(ref._id, is_error, value)
        return ref

    def stream_completed(self, sid: ObjectID, index: int) -> bool:
        with self._cv:
            st = self._streams.get(sid)
            return st is None or (st.done and index >= len(st.items))

    def release_stream(self, sid: ObjectID) -> None:
        with self._cv:
            self._streams.pop(sid, None)

    # ------------------------------------------------------------ calls
    def _new_call(self, task_id: TaskID, fn, args, kwargs, streaming: bool, desc: str):
        """The call and what it hands back: its return ref, or, for a
        streaming call, its ObjectRefGenerator."""
        if streaming:
            out = self._new_stream(task_id)
            return _Call(fn, args, kwargs, None, out._stream_id, desc), out
        out = ObjectRef(ObjectID.for_task_return(task_id, 1), self)
        return _Call(fn, args, kwargs, out._id, None, desc), out

    def _resolve_args(self, args, kwargs):
        args = tuple(self.get([a])[0] if isinstance(a, ObjectRef) else a for a in args)
        kwargs = {k: self.get([v])[0] if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        return args, kwargs

    def _run(self, call: _Call, instance=None) -> None:
        """Run ``call`` (a function, or a method of ``instance``) and seal its
        result or its error."""
        try:
            if isinstance(call.fn, str):  # an actor method
                if instance is None:
                    raise ActorDiedError("the actor died before this call ran")
                fn = getattr(instance, call.fn)
            else:
                fn = call.fn
            args, kwargs = self._resolve_args(call.args, call.kwargs)
            out = fn(*args, **kwargs)
            if call.stream_id is not None:
                for item in out:
                    self._stream_put(call.stream_id, False, item)
                self._stream_end(call.stream_id)
                return
        except ActorDiedError as e:
            self._fail(call, e)
            return
        except Exception as e:  # noqa: BLE001 - the caller's get re-raises it
            self._fail(call, TaskError(e, call.desc))
            return
        self._store(call.oid, False, out)

    def _fail(self, call: _Call, err: BaseException) -> None:
        if call.stream_id is not None:
            self._stream_put(call.stream_id, True, err)
            self._stream_end(call.stream_id)
        else:
            self._store(call.oid, True, err)

    # ------------------------------------------------------------ resources
    def _check_feasible(self, request: dict) -> None:
        over = {k: v for k, v in request.items() if v > self._total.get(k, 0.0)}
        if over:
            raise ValueError(f"infeasible resource request {over}: the runtime has "
                             f"{self._total}")

    def _admit(self, request: dict, start: Callable, fail: Callable) -> None:
        """Queue ``start`` until ``request`` fits, then reserve and run it."""
        request = {k: float(v) for k, v in request.items() if v}
        self._check_feasible(request)
        with self._cv:
            if self.is_shutdown:
                raise RayTpuError("ray_tpu_torch is shut down")
            self._pending.append((request, start, fail))
        self._dispatch()

    def _dispatch(self) -> None:
        starts = []
        with self._cv:
            keep = collections.deque()
            for request, start, fail in self._pending:
                if all(self._avail.get(k, 0.0) >= v for k, v in request.items()):
                    for k, v in request.items():
                        self._avail[k] -= v
                    starts.append(start)
                else:
                    keep.append((request, start, fail))
            self._pending = keep
        for start in starts:
            start()

    def _release(self, request: dict) -> None:
        with self._cv:
            for k, v in request.items():
                if v:
                    self._avail[k] = self._avail.get(k, 0.0) + float(v)
        self._dispatch()

    def total_resources(self) -> dict[str, float]:
        with self._cv:
            return dict(self._total)

    def available_resources(self) -> dict[str, float]:
        with self._cv:
            return dict(self._avail)

    def _start_thread(self, target, name: str, *args) -> None:
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        with self._cv:
            self._threads.append(t)
        t.start()

    # ------------------------------------------------------------ tasks
    def submit_task(self, fn: Callable, args, kwargs, *, streaming: bool,
                    resources: dict, name: str):
        call, out = self._new_call(TaskID.for_normal_task(self.job_id), fn, args, kwargs,
                                   streaming, name)

        def run():
            try:
                self._run(call)
            finally:
                self._release(resources)

        def start():
            with self._cv:  # claim an idle worker, or start one for this call
                grow = self._idle_task_threads == 0 and self._task_threads < _MAX_TASK_THREADS
                if grow:
                    self._task_threads += 1
                elif self._idle_task_threads:
                    self._idle_task_threads -= 1
            self._task_queue.put((run, call))
            if grow:
                self._start_thread(self._task_worker, f"ray_tpu_torch-task-{self._task_threads}")

        self._admit(resources, start, lambda err: self._fail(call, err))
        return out

    def _task_worker(self) -> None:
        while not self.is_shutdown:
            try:
                item = self._task_queue.get(timeout=_WAIT_SLICE_S)
            except queue.Empty:
                continue
            if item is None:
                return
            try:
                item[0]()
            finally:
                with self._cv:
                    self._idle_task_threads += 1

    # ------------------------------------------------------------ actors
    def create_actor(self, cls, args, kwargs, opts: dict, resources: dict) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        name = opts.get("name")
        ready = ObjectRef(ObjectID.for_task_return(TaskID.for_actor_task(actor_id), 1), self)
        actor = _Actor(actor_id, cls, args, kwargs, opts,
                       {k: float(v) for k, v in resources.items() if v}, ready)
        self._check_feasible(actor.resources)
        with self._cv:
            if self.is_shutdown:
                raise RayTpuError("ray_tpu_torch is shut down")
            if name:
                if name in self._named:
                    if opts.get("get_if_exists"):
                        return self._named[name]
                    raise ValueError(f"Actor with name '{name}' already exists")
                self._named[name] = actor_id
            self._actors[actor_id] = actor

        def start():
            with actor.lock:
                if actor.state == "DEAD":  # killed while it waited for resources
                    start_it = False
                else:
                    actor.holds_resources = start_it = True
                    actor.threads.append(None)  # the creating thread's place
            if not start_it:
                self._release(actor.resources)
                return
            self._start_thread(self._actor_main, f"ray_tpu_torch-actor-{cls.__name__}-0",
                               actor)

        self._admit(actor.resources, start, lambda err: self._actor_died(actor, str(err)))
        return actor_id

    def actor_ready(self, actor_id: ActorID) -> ObjectRef:
        """A ref that resolves to None once the actor's constructor returned,
        and holds its error (a TaskError) if it raised."""
        return self._actor(actor_id).ready_ref

    def _actor(self, actor_id: ActorID) -> _Actor:
        with self._cv:
            actor = self._actors.get(actor_id)
        if actor is None:
            raise ValueError(f"unknown actor {actor_id!r}")
        return actor

    def _actor_main(self, actor: _Actor) -> None:
        """The creating thread: run the constructor, then serve the mailbox."""
        desc = f"{actor.cls.__name__}.__init__"
        try:
            args, kwargs = self._resolve_args(actor.args, actor.kwargs)
            instance = actor.cls(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the actor dies with the cause
            self._actor_died(actor, f"__init__ failed: {e!r}", ready_error=TaskError(e, desc))
            return
        with actor.lock:
            alive = actor.state == "PENDING"
            if alive:
                actor.instance, actor.state = instance, "ALIVE"
                actor.threads[0] = threading.current_thread()
                # this thread is free; claim it, or new threads, for the
                # calls that queued while the constructor ran
                actor.idle = 1
                spawn = sum(self._claim(actor) for _ in range(actor.mailbox.qsize()))
        del instance
        if not alive:
            return
        self._store(actor.ready_ref._id, False, None)
        for _ in range(spawn):
            self._spawn_actor_thread(actor)
        self._actor_loop(actor)

    @staticmethod
    def _claim(actor: _Actor) -> bool:
        """Give a newly queued call a thread (caller holds ``actor.lock``):
        an idle one, else a new one up to ``max_concurrency`` (True: the
        caller starts it), else it waits for a thread to free up."""
        if actor.idle > 0:
            actor.idle -= 1
            return False
        if len(actor.threads) < actor.max_concurrency:
            actor.threads.append(None)  # its place, filled when it starts
            return True
        return False

    def _actor_loop(self, actor: _Actor) -> None:
        while True:
            try:
                call = actor.mailbox.get(timeout=_WAIT_SLICE_S)
            except queue.Empty:
                if actor.state == "DEAD" or self.is_shutdown:
                    return
                continue
            if call is None:
                return
            self._run(call, actor.instance)  # None once killed: the call fails
            with actor.lock:
                actor.idle += 1

    def _spawn_actor_thread(self, actor: _Actor) -> None:
        def serve():
            with actor.lock:
                actor.threads[actor.threads.index(None)] = threading.current_thread()
            self._actor_loop(actor)

        self._start_thread(serve, f"ray_tpu_torch-actor-{actor.cls.__name__}")

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs, *,
                          streaming: bool):
        actor = self._actor(actor_id)
        call, out = self._new_call(TaskID.for_actor_task(actor_id), method_name, args,
                                   kwargs, streaming, f"{actor.cls.__name__}.{method_name}")
        spawn = False
        with actor.lock:
            dead = actor.state == "DEAD"
            if not dead:
                actor.mailbox.put(call)
                spawn = actor.state == "ALIVE" and self._claim(actor)
        if dead:
            self._fail(call, ActorDiedError(actor.death_cause or "actor is dead"))
        elif spawn:
            self._spawn_actor_thread(actor)
        return out

    def _actor_died(self, actor: _Actor, cause: str, ready_error=None) -> None:
        """Mark ``actor`` dead: drop its instance and name, fail its queued
        calls, poison its threads and give back its resources."""
        with actor.lock:
            if actor.state == "DEAD":
                return
            actor.state, actor.death_cause = "DEAD", cause
            # dropped outside the lock: the last reference may run a
            # __del__ that stops an engine
            instance, actor.instance = actor.instance, None
            queued = []
            while True:
                try:
                    item = actor.mailbox.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    queued.append(item)
            for _ in actor.threads:
                actor.mailbox.put(None)
            release = actor.holds_resources
            actor.holds_resources = False
        del instance
        with self._cv:
            if actor.name and self._named.get(actor.name) == actor.actor_id:
                del self._named[actor.name]
        err = ActorDiedError(cause)
        for call in queued:
            self._fail(call, err)
        self._store(actor.ready_ref._id, True, ready_error or err)
        if release:
            self._release(actor.resources)

    def kill_actor(self, actor_id: ActorID) -> None:
        self._actor_died(self._actor(actor_id), "ray_tpu_torch.kill() called")

    def get_actor(self, name: str) -> ActorID:
        with self._cv:
            actor_id = self._named.get(name)
        if actor_id is None:
            raise ValueError(f"Failed to look up actor '{name}'")
        return actor_id

    def actor_class(self, actor_id: ActorID):
        return self._actor(actor_id).cls

    # ------------------------------------------------------------ shutdown
    def shutdown(self, timeout: float = _SHUTDOWN_JOIN_S) -> None:
        with self._cv:
            if self.is_shutdown:
                return
            self.is_shutdown = True
            actors = list(self._actors.values())
            pending, self._pending = list(self._pending), collections.deque()
            self._cv.notify_all()
        err = RayTpuError("ray_tpu_torch was shut down before this object was ready")
        for actor in actors:
            self._actor_died(actor, "ray_tpu_torch.shutdown() called")
        for _, _, fail in pending:
            fail(err)
        while True:
            try:
                item = self._task_queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail(item[1], err)
        with self._cv:
            for _ in range(self._task_threads):
                self._task_queue.put(None)
            unresolved = [oid for oid in list(self._refcounts) + list(self._callbacks)
                          if oid not in self._objects]
            for st in self._streams.values():
                if not st.done:
                    st.items.append((True, err))
                    st.done = True
        for oid in unresolved:
            self._store(oid, True, err)
        deadline = time.monotonic() + timeout
        with self._cv:
            threads = list(self._threads)
        me = threading.current_thread()
        for t in threads:
            if t is not me:
                t.join(max(0.0, deadline - time.monotonic()))
        with self._cv:
            self._actors.clear()
            self._named.clear()
            self._threads.clear()
            self._callbacks.clear()
            self._cv.notify_all()
        global _runtime
        if _runtime is self:
            _runtime = None
