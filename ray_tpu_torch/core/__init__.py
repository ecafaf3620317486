"""The port's in-process runtime: tasks, thread actors and an object store
in one process (see ``core/runtime.py``)."""

from ray_tpu_torch.core.api import (ActorHandle, ObjectRef, ObjectRefGenerator,
                                    available_resources, cluster_resources, get, get_actor,
                                    init, is_initialized, kill, put, remote, shutdown, wait)

__all__ = ["init", "is_initialized", "shutdown", "put", "get", "wait", "kill", "get_actor",
           "remote", "cluster_resources", "available_resources", "ObjectRef",
           "ObjectRefGenerator", "ActorHandle"]
