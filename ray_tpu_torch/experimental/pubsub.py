"""Public pub/sub surface: publish and subscribe on the runtime's channels
(copied from ray_tpu/experimental/pubsub.py). The runtime publishes each
actor's state changes on ``"actors"``; nothing is published on ``"nodes"``
(one process is one node)."""

from __future__ import annotations

from typing import Any

from ray_tpu_torch.core.pubsub import Subscriber
from ray_tpu_torch.core.runtime import get_runtime


def publish(channel: str, message: Any, retain: bool = False) -> int:
    """Deliver ``message`` to every subscriber of ``channel``; returns the
    count. ``retain=True`` keeps it as the channel's last value: a future
    subscriber receives it on subscribe (routing epochs use this, so an
    ingress started later serves from its first request)."""
    return get_runtime().publisher.publish(channel, message, retain=retain)


def subscribe(channel: str) -> Subscriber:
    """Subscribe to ``channel``; poll() the returned Subscriber for messages."""
    return get_runtime().publisher.subscribe(channel)
