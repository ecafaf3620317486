"""Dynamic request batching, ``@serve.batch`` (copied from
ray_tpu/serve/batching.py).

Calls buffer until ``max_batch_size`` or ``batch_wait_timeout_s``, then the
wrapped function runs once on the list of requests, and each caller gets
its element of the returned list: one batched forward pass instead of one
per request.

The port's thread rules: the flush timer is a daemon thread, a caller
waits for its result in slices of at most 0.5 s, and ``serve.shutdown()``
stops every batcher's pending flush and fails its queued callers (a later
call starts a fresh batch).
"""

from __future__ import annotations

import functools
import inspect
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

_WAIT_SLICE_S = 0.5

# every live batcher, so serve.shutdown() can stop their flushes
_batchers: "weakref.WeakSet[_Batcher]" = weakref.WeakSet()
_batchers_lock = threading.Lock()


@dataclass
class _Pending:
    item: Any
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._flusher: threading.Timer | None = None
        with _batchers_lock:
            _batchers.add(self)

    def _start_flusher(self, delay: float) -> None:
        """Arm the flush timer (caller holds ``_lock``)."""
        self._flusher = threading.Timer(delay, self._flush)
        self._flusher.daemon = True
        self._flusher.start()

    def submit(self, item: Any) -> Any:
        p = _Pending(item)
        flush_now = False
        with self._lock:
            self._queue.append(p)
            if len(self._queue) >= self.max_batch_size:
                flush_now = True
            elif self._flusher is None:
                self._start_flusher(self.timeout)
        if flush_now:
            self._flush()
        while not p.event.wait(_WAIT_SLICE_S):
            pass  # a flush or a shutdown sets the event
        if p.error is not None:
            raise p.error
        return p.result

    def _flush(self) -> None:
        with self._lock:
            # take at most max_batch_size; late arrivals stay queued for the next batch
            batch = self._queue[: self.max_batch_size]
            self._queue = self._queue[self.max_batch_size :]
            if self._flusher is not None:
                self._flusher.cancel()
                self._flusher = None
            if self._queue:  # schedule the leftover promptly
                self._start_flusher(0.0)
        if not batch:
            return
        try:
            results = self.fn([p.item for p in batch])
            if inspect.iscoroutine(results):
                import asyncio

                results = asyncio.run(results)
            if len(results) != len(batch):
                raise ValueError(
                    f"@serve.batch fn returned {len(results)} results for {len(batch)} requests"
                )
            for p, r in zip(batch, results):
                p.result = r
                p.event.set()
        except BaseException as e:  # noqa: BLE001 - every caller of the batch gets it
            for p in batch:
                p.error = e
                p.event.set()

    def stop(self) -> None:
        """Cancel the pending flush and fail every queued caller."""
        with self._lock:
            pending, self._queue = self._queue, []
            flusher, self._flusher = self._flusher, None
        if flusher is not None:
            flusher.cancel()
        err = RuntimeError("serve shut down before this batch ran")
        for p in pending:
            p.error = err
            p.event.set()


def stop_all() -> None:
    """``serve.shutdown()``: stop every batcher's pending flush."""
    with _batchers_lock:
        batchers = list(_batchers)
    for b in batchers:
        b.stop()


def batch(_fn=None, *, max_batch_size: int = 8, batch_wait_timeout_s: float = 0.01):
    """``@serve.batch`` (reference: serve/batching.py)."""

    def deco(fn):
        params = list(inspect.signature(fn).parameters)
        is_method = bool(params) and params[0] == "self"
        lock = threading.Lock()

        if is_method:
            attr = f"__serve_batcher_{fn.__name__}"

            @functools.wraps(fn)
            def method_wrapper(self, item):
                # batcher lives on the instance, so it dies with the replica
                b = getattr(self, attr, None)
                if b is None:
                    with lock:
                        b = getattr(self, attr, None)
                        if b is None:
                            b = _Batcher(
                                lambda items: fn(self, items), max_batch_size, batch_wait_timeout_s
                            )
                            setattr(self, attr, b)
                return b.submit(item)

            return method_wrapper

        batcher = _Batcher(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        def wrapper(item):
            return batcher.submit(item)

        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
