"""Flight recorder: bounded per-subsystem rings of recent structured events
(the rings of ray_tpu/util/flight_recorder.py, copied).

Subsystems record rare but telling events (an SLO breach, a shed) into
small in-memory rings, one deque per subsystem, O(1) append, bounded
memory, and ``records()`` reads them back. Events are plain dicts:
``{"seq": n, "ts": wall_clock, "subsystem": ..., "event": ..., **fields}``.
The reference's crash dump (a SIGTERM handler that writes the rings out)
is not copied.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional

MAX_EVENTS_PER_SUBSYSTEM = 256

_lock = threading.Lock()
_rings: dict[str, deque] = {}
_seq = itertools.count(1)  # monotone id: the cursor of drain_since


def record(subsystem: str, event: str, **fields) -> None:
    """Append one structured event."""
    entry = {"seq": next(_seq), "ts": time.time(),
             "subsystem": subsystem, "event": event}
    entry.update(fields)
    with _lock:
        ring = _rings.get(subsystem)
        if ring is None:
            ring = _rings[subsystem] = deque(maxlen=MAX_EVENTS_PER_SUBSYSTEM)
        ring.append(entry)


def records(subsystem: Optional[str] = None, limit: int = 1000) -> list[dict]:
    """Recent events, oldest first: one subsystem's ring or all rings
    merged by sequence. ``limit`` caps the merge; <= 0 returns nothing."""
    if limit <= 0:
        return []
    with _lock:
        if subsystem is not None:
            out = list(_rings.get(subsystem, ()))
        else:
            out = [e for ring in _rings.values() for e in ring]
    out.sort(key=lambda e: e["seq"])
    return out[-limit:]


def subsystems() -> list[str]:
    with _lock:
        return sorted(_rings)


def drain_since(cursor: int) -> tuple[list[dict], int]:
    """Events newer than ``cursor`` plus the new cursor."""
    out = []
    with _lock:
        for ring in _rings.values():
            for e in ring:
                if e["seq"] > cursor:
                    out.append(e)
    out.sort(key=lambda e: e["seq"])
    new_cursor = out[-1]["seq"] if out else cursor
    return out, new_cursor


def clear() -> None:
    """Forget every ring (the old rings are dropped after the lock)."""
    global _rings
    with _lock:
        dropped, _rings = _rings, {}
    del dropped
