"""The part of ray_tpu/util/timeline.py that request anatomy calls.

The reference estimates each node's clock offset from the head's (from
pushed samples) so stamps taken on different machines line up in one
ledger. Every stamp of the port is taken in one process, on one clock, so
there is no offset to estimate: ``clock_offsets()`` is empty, as the
reference's is before any node has pushed.
"""

from __future__ import annotations


def clock_offsets() -> dict:
    """node hex -> (node wall - head wall) in seconds; empty in one process."""
    return {}
