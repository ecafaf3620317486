"""Binary ids for jobs, actors, tasks and objects (copied from
ray_tpu/_private/ids.py).

Layouts (bytes):
  JobID:    4  random
  ActorID:  12 = 8 unique + 4 job
  TaskID:   24 = 8 unique + 4 job + 12 actor (nil actor for normal tasks)
  ObjectID: 28 = 24 task + 4 index (big-endian; high bit = puts)
"""

from __future__ import annotations

import os
import struct


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, b: bytes):
        if len(b) != self.SIZE:
            raise ValueError(f"{type(self).__name__} needs {self.SIZE} bytes, got {len(b)}")
        self._bytes = b

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __repr__(self):
        if self.is_nil():
            return f"{type(self).__name__}(nil)"
        return f"{type(self).__name__}({self.hex()[:12]}…)"


class JobID(BaseID):
    SIZE = 4


class ActorID(BaseID):
    SIZE = 12

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(8) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[8:])


class TaskID(BaseID):
    SIZE = 24

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(os.urandom(8) + job_id.binary() + ActorID.nil().binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(os.urandom(8) + actor_id.job_id().binary() + actor_id.binary())


_PUT_BIT = 1 << 31


class ObjectID(BaseID):
    SIZE = 28

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack(">I", _PUT_BIT | put_index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:24])
