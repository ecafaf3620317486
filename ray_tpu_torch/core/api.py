"""The runtime's public calls (the in-process part of ray_tpu/core/api.py):
``init``/``shutdown``, ``@remote`` functions and actors, ``put``/``get``/
``wait``, ``kill``, ``get_actor`` and the resource views.

``init(num_gpus=None)`` counts the CUDA devices (``torch.cuda.device_count()``)
as the ``"GPU"`` resource, where the reference counts TPU chips.
"""

from __future__ import annotations

import functools
import inspect
import os
import threading
from typing import Any, Callable

import torch

from ray_tpu_torch.core import runtime as rt_mod
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.runtime import STREAMING, get_runtime

_init_lock = threading.Lock()

_TASK_OPTIONS = dict(num_cpus=1.0, num_gpus=0.0, num_returns=1, name=None)
_ACTOR_OPTIONS = dict(num_cpus=1.0, num_gpus=0.0, max_concurrency=1, name=None,
                      get_if_exists=False)


def init(*, num_cpus: float | None = None, num_gpus: float | None = None,
         ignore_reinit_error: bool = False) -> None:
    """Start the in-process runtime. ``num_cpus`` defaults to the host's
    cores (at least 8), ``num_gpus`` to the CUDA devices torch sees."""
    with _init_lock:
        if rt_mod.get_runtime_or_none() is not None:
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True")
        res = {"CPU": float(num_cpus if num_cpus is not None else max(os.cpu_count() or 1, 8))}
        gpus = torch.cuda.device_count() if num_gpus is None else num_gpus
        if gpus:
            res["GPU"] = float(gpus)
        rt_mod.set_runtime(rt_mod.Runtime(res))


def is_initialized() -> bool:
    return rt_mod.get_runtime_or_none() is not None


def shutdown() -> None:
    """Stop the runtime (``Runtime.shutdown``: pending refs fail, threads are
    joined against a deadline, the global is cleared)."""
    with _init_lock:
        rt = rt_mod.get_runtime_or_none()
        if rt is not None:
            rt.shutdown()


def put(value: Any) -> ObjectRef:
    return get_runtime().put(value)


def get(refs, timeout: float | None = None):
    """The value of one ref, or the values of a list of refs, waiting at most
    ``timeout`` seconds for all of them (``GetTimeoutError`` past it)."""
    if isinstance(refs, ObjectRef):
        return get_runtime().get([refs], timeout)[0]
    if isinstance(refs, list):
        return get_runtime().get(refs, timeout)
    raise TypeError(f"get() expects an ObjectRef or a list of them, got {type(refs)}")


def wait(refs: list[ObjectRef], *, num_returns: int = 1, timeout: float | None = None):
    """(ready, not_ready): the first ``num_returns`` ready refs, in the
    order given, once that many are ready or ``timeout`` has passed."""
    if not isinstance(refs, list):
        raise TypeError("wait() expects a list of ObjectRefs")
    return get_runtime().wait(refs, num_returns, timeout)


def kill(actor: "ActorHandle") -> None:
    get_runtime().kill_actor(actor._actor_id)


def get_actor(name: str) -> "ActorHandle":
    rt = get_runtime()
    actor_id = rt.get_actor(name)
    return ActorHandle(actor_id, rt.actor_class(actor_id))


def cluster_resources() -> dict[str, float]:
    return get_runtime().total_resources()


def available_resources() -> dict[str, float]:
    return get_runtime().available_resources()


def _checked(defaults: dict, opts: dict, what: str) -> dict:
    unknown = sorted(set(opts) - set(defaults))
    if unknown:
        raise ValueError(f"unknown {what} option(s) {unknown}; the in-process runtime "
                         f"takes {sorted(defaults)}")
    return {**defaults, **opts}


def _checked_num_returns(num_returns):
    if num_returns not in (1, STREAMING):
        raise ValueError(f"num_returns must be 1 or {STREAMING!r}, got {num_returns!r}")
    return num_returns


def _resources(opts: dict) -> dict[str, float]:
    return {"CPU": float(opts["num_cpus"]), "GPU": float(opts["num_gpus"])}


class RemoteFunction:
    """A function run as a task by ``.remote()``."""

    def __init__(self, fn: Callable, options: dict):
        self._fn = fn
        self._options = _checked(_TASK_OPTIONS, options, "task")
        _checked_num_returns(self._options["num_returns"])
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs):
        opts = self._options
        return get_runtime().submit_task(self._fn, args, kwargs,
                                         streaming=opts["num_returns"] == STREAMING,
                                         resources=_resources(opts),
                                         name=opts["name"] or self._fn.__name__)

    def options(self, **opts) -> "RemoteFunction":
        return RemoteFunction(self._fn, {**self._options, **opts})

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Remote function '{self._fn.__name__}' cannot be called "
                        f"directly; use .remote().")


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns=1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = _checked_num_returns(num_returns)

    def remote(self, *args, **kwargs):
        return get_runtime().submit_actor_task(self._handle._actor_id, self._method_name,
                                               args, kwargs,
                                               streaming=self._num_returns == STREAMING)

    def options(self, **opts) -> "ActorMethod":
        opts = _checked({"num_returns": self._num_returns}, opts, "actor method")
        return ActorMethod(self._handle, self._method_name, opts["num_returns"])

    def __call__(self, *args, **kwargs):
        raise TypeError("Actor methods cannot be called directly; use .remote().")


class ActorHandle:
    def __init__(self, actor_id, cls):
        self._actor_id = actor_id
        self._cls = cls

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        if not hasattr(self._cls, item):
            raise AttributeError(f"Actor {self._cls.__name__} has no method '{item}'")
        return ActorMethod(self, item)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __hash__(self):
        return hash(self._actor_id)

    def __repr__(self):
        return f"ActorHandle({self._cls.__name__}, {self._actor_id.hex()[:12]})"


class ActorClass:
    """A class whose ``.remote()`` creates a thread actor."""

    def __init__(self, cls, options: dict):
        self._cls = cls
        self._options = _checked(_ACTOR_OPTIONS, options, "actor")

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._options
        actor_id = get_runtime().create_actor(self._cls, args, kwargs, opts, _resources(opts))
        return ActorHandle(actor_id, self._cls)

    def options(self, **opts) -> "ActorClass":
        return ActorClass(self._cls, {**self._options, **opts})

    def __call__(self, *args, **kwargs):
        raise TypeError(f"Actor class '{self._cls.__name__}' cannot be instantiated "
                        f"directly; use .remote().")


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(**options)`` on a function (a task) or a class
    (an actor)."""

    def make(target):
        if inspect.isclass(target):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("remote() takes keyword options only, e.g. @remote(num_cpus=2)")
    return make


__all__ = ["init", "is_initialized", "shutdown", "put", "get", "wait", "kill", "get_actor",
           "remote", "cluster_resources", "available_resources", "ObjectRef",
           "ObjectRefGenerator", "ActorHandle", "STREAMING"]
