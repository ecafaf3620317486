"""Model multiplexing: many models served by one replica pool (copied from
ray_tpu/serve/multiplex.py).

``@serve.multiplexed`` makes a deployment's model loader an LRU of at most
``max_num_models_per_replica`` models per replica, loaded on demand, and
``get_multiplexed_model_id()`` names the model of the current request. The
model id travels in the request, and the replica-local LRU keeps a model
that requests come back to.

The port's thread rules: a request that waits for another request's load
of the same model, or for an async loader's thread, waits in slices of at
most 0.5 s and gives up with an error once ``serve.shutdown()`` has run.
"""

from __future__ import annotations

import collections
import functools
import inspect
import threading
import time
from typing import Any, Callable

_WAIT_SLICE_S = 0.5
LOAD_WAIT_S = 300.0  # the longest a request waits for another's load of its model

_request_ctx = threading.local()
# serve.shutdown() counts itself here; a wait that began before gives up
_shutdowns = 0


def get_multiplexed_model_id() -> str:
    """Inside a replica call: the model id of the current request."""
    return getattr(_request_ctx, "model_id", "")


def _set_model_id(model_id: str) -> None:
    _request_ctx.model_id = model_id


def shutdown() -> None:
    """``serve.shutdown()``: every wait in progress gives up."""
    global _shutdowns
    _shutdowns += 1


def _wait(done, what: str, timeout: float) -> None:
    """Wait until ``done(slice_s)`` is true, in slices of at most 0.5 s;
    raise once serve shut down meanwhile or ``timeout`` passed."""
    seen = _shutdowns
    deadline = time.monotonic() + timeout
    while not done(_WAIT_SLICE_S):
        if _shutdowns != seen:
            raise RuntimeError(f"serve shut down while waiting for {what}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"waited {timeout} s for {what}")


def _run_coro_sync(coro):
    """Run a coroutine to completion whether or not this thread has a running
    event loop (the replica executes async handlers via asyncio.run, so a sync
    loader wrapper called from inside one must hop to a fresh thread)."""
    import asyncio

    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    out: dict = {}

    def runner():
        try:
            out["v"] = asyncio.run(coro)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            out["e"] = e

    t = threading.Thread(target=runner, daemon=True, name="serve-mux-loader")
    t.start()

    def joined(slice_s: float) -> bool:
        t.join(slice_s)
        return not t.is_alive()

    _wait(joined, "an async model loader", LOAD_WAIT_S)
    if "e" in out:
        raise out["e"]
    return out["v"]


def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for the model-loader method of a deployment class.

    The wrapped ``async/sync def load_model(self, model_id)`` becomes an
    LRU-cached loader; calling it inside a request both loads (if needed) and
    marks the model most-recently-used, evicting beyond the cap.
    """

    def deco(load_fn: Callable):
        attr = f"__serve_mux_{load_fn.__name__}"
        lock = threading.Lock()

        inflight_attr = attr + "_inflight"

        @functools.wraps(load_fn)
        def wrapper(self, model_id: str):
            while True:
                with lock:
                    cache: "collections.OrderedDict[str, Any]" = getattr(self, attr, None)
                    if cache is None:
                        cache = collections.OrderedDict()
                        setattr(self, attr, cache)
                    inflight: dict = getattr(self, inflight_attr, None)
                    if inflight is None:
                        inflight = {}
                        setattr(self, inflight_attr, inflight)
                    if model_id in cache:
                        cache.move_to_end(model_id)
                        _set_model_id(model_id)
                        return cache[model_id]
                    ev = inflight.get(model_id)
                    if ev is None:
                        inflight[model_id] = threading.Event()
                        break  # we are the loader
                # another request is loading this model: wait, then re-check
                _wait(ev.wait, f"model {model_id!r} to load", LOAD_WAIT_S)
            try:
                model = load_fn(self, model_id)
                if inspect.iscoroutine(model):
                    model = _run_coro_sync(model)
            except BaseException:
                with lock:
                    done_ev = inflight.pop(model_id)
                done_ev.set()
                raise
            with lock:
                cache[model_id] = model
                cache.move_to_end(model_id)
                evicted = []
                while len(cache) > max_num_models_per_replica:
                    _, old = cache.popitem(last=False)
                    evicted.append(old)
                done_ev = inflight.pop(model_id)
            done_ev.set()
            for old in evicted:
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:  # noqa: BLE001 - an unload error must not fail the request
                        pass
            _set_model_id(model_id)
            return model

        wrapper.__is_multiplexed__ = True
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
