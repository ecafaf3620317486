"""Pub/sub channels of one process (copied from ray_tpu/core/pubsub.py,
without its remote peers: the runtime has no worker process to push to).

``Publisher.subscribe`` hands out a ``Subscriber`` whose ``poll`` yields the
channel's messages in order. Each subscriber's buffer holds
``BUFFER_LIMIT`` messages and drops the oldest beyond that. ``publish(...,
retain=True)`` keeps the message as the channel's last value, which a later
subscriber receives at once (routing epochs ride this).

The runtime publishes each thread actor's state changes on ``"actors"``:
``{actor_id, class_name, state, name, num_restarts}``. It publishes nothing
on ``"nodes"``: one process is one node, which neither registers nor dies.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Optional

BUFFER_LIMIT = 10_000  # per-subscriber; oldest dropped beyond (bounded queues)


class Subscriber:
    """A channel subscription; poll() yields published messages in order."""

    def __init__(self, publisher: "Publisher", channel: str):
        self._publisher = publisher
        self.channel = channel
        self._q: "queue.Queue" = queue.Queue(maxsize=BUFFER_LIMIT)
        self.dropped = 0

    def _offer(self, msg: Any) -> None:
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            self.dropped += 1
            try:
                self._q.get_nowait()  # drop the oldest
                self._q.put_nowait(msg)
            except (queue.Empty, queue.Full):
                pass  # lost a race with a concurrent publisher: msg dropped

    def poll(self, timeout: float | None = None) -> Optional[Any]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._publisher.unsubscribe(self)


class Publisher:
    """Channel fan-out to the subscribers of this process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local: dict[str, list[Subscriber]] = {}
        # channel -> last retained message: a late subscriber gets current
        # state at once instead of waiting for the next publish
        self._retained: dict[str, Any] = {}
        self.published_total = 0

    def subscribe(self, channel: str) -> Subscriber:
        sub = Subscriber(self, channel)
        with self._lock:
            self._local.setdefault(channel, []).append(sub)
            retained = self._retained.get(channel)
        if retained is not None:
            sub._offer(retained)
        return sub

    def unsubscribe(self, sub: Subscriber) -> None:
        with self._lock:
            subs = self._local.get(sub.channel, [])
            if sub in subs:
                subs.remove(sub)

    def publish(self, channel: str, message: Any, retain: bool = False) -> int:
        """Deliver to every subscriber; returns the number delivered.
        ``retain`` keeps the message as the channel's last value, replayed to
        future subscribers."""
        with self._lock:
            local = list(self._local.get(channel, []))
            if retain:
                self._retained[channel] = message
            self.published_total += 1
        for sub in local:
            sub._offer(message)
        return len(local)
