"""ObjectRef and ObjectRefGenerator (copied from ray_tpu/core/object_ref.py).

Nothing leaves the process, so the serialization hooks of the reference are
not copied. A ref counts itself in its runtime while it lives: the runtime
drops an object once no ref to it is left."""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

from ray_tpu_torch.core.ids import ObjectID

if TYPE_CHECKING:
    from ray_tpu_torch.core.runtime import Runtime


class ObjectRef:
    __slots__ = ("_id", "_runtime", "__weakref__")

    def __init__(self, object_id: ObjectID, runtime: "Runtime"):
        self._id = object_id
        self._runtime = runtime
        runtime.add_ref(object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        try:
            self._runtime.remove_ref(self._id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class ObjectRefGenerator:
    """Iterator over a streaming call's items, as they are produced: each
    ``next`` waits for the next item and gives its ref; the iteration ends
    when the producer has returned."""

    def __init__(self, stream_id: ObjectID, runtime: "Runtime"):
        self._stream_id = stream_id
        self._runtime = runtime
        self._next_index = 0

    def __iter__(self) -> Iterator[ObjectRef]:
        return self

    def __next__(self) -> ObjectRef:
        ref = self._runtime.next_stream_item(self._stream_id, self._next_index)
        if ref is None:
            raise StopIteration
        self._next_index += 1
        return ref

    def completed(self) -> bool:
        return self._runtime.stream_completed(self._stream_id, self._next_index)

    def __del__(self):
        try:
            self._runtime.release_stream(self._stream_id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
