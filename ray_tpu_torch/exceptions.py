"""The errors the port's runtime and serve layer raise (copied from
ray_tpu/exceptions.py: the classes the in-process path uses)."""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task or actor method raised; re-raised at ``get``.

    Carries the original exception (``cause``) and its traceback as text, so
    the caller sees where the failure happened."""

    def __init__(self, cause: BaseException, task_desc: str = "", remote_tb: str | None = None):
        self.cause = cause
        self.task_desc = task_desc
        self.remote_tb = remote_tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__))
        super().__init__(f"Task {task_desc} failed:\n{self.remote_tb}")

    def as_cause(self) -> BaseException:
        return self.cause


class ActorError(RayTpuError):
    """The actor died before or during this method call."""

    def __init__(self, msg: str = "The actor died unexpectedly before finishing this task."):
        super().__init__(msg)


class ActorDiedError(ActorError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_desc: str = ""):
        super().__init__(f"Task {task_desc} was cancelled.")
