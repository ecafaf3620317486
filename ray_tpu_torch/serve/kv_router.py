"""KV-cache-aware request routing (copied from ray_tpu/serve/kv_router.py).

The router sends a request to the replica whose paged-KV prefix cache most
likely holds the request's prompt prefix, so shared-prefix traffic (system
prompts, few-shot preambles, multi-turn chats) hits the cache instead of
prefilling again on a random replica.

The router tracks its own past decisions: block-aligned prompt-prefix
hashes map to the replica that last served them (the content-hash scheme
of the engine's allocator, serve/paged_kv.py). On pick, the replica holding
the longest matching prefix wins, unless its in-flight depth exceeds the
least loaded replica's by more than ``imbalance_tolerance`` (cache affinity
must not defeat load balancing). No affinity: power of two choices. The
state is router-local (no replica call on the request path), bounded by an
LRU, and owners of removed replicas are pruned on refresh. The hint is the
body's ``prompt_ids``.

Decode-side placement (a body that carries a KV-handoff descriptor) scores
``in-flight + node I/O pressure - locality bonus``. It is ported as the
reference has it, but in one process every replica is on node ``"head"``
and there is no node I/O telemetry: the I/O view is empty, so the score is
the in-flight depth less the bonus for the holder's node.
"""

from __future__ import annotations

import random
import time
from collections import OrderedDict

import ray_tpu_torch
from ray_tpu_torch.serve.controller import Router


def _default_io_view() -> dict:
    """Pending KV/object pull bytes per node. The reference reads its
    telemetry plane; one process has no node pushing any, so no node is
    under pressure."""
    return {"nodes": {}}


class KVAwareRouter(Router):
    KIND = "kv_aware"

    # pending pull bytes per unit of queue-depth-equivalent pressure: a node
    # with 32 MB of KV/object bytes in flight scores like one extra
    # in-flight request (capped so a saturated NIC can't dominate forever)
    IO_PRESSURE_SCALE = 32 << 20
    IO_PRESSURE_CAP = 4.0
    # replica->node map fetch cadence: node placement changes only when
    # replicas are (re)spawned, so this rides a slower clock than the base
    # 0.5s replica refresh — otherwise every handle doubles the
    # controller's routing RPC load with a second round-trip per cycle
    NODE_MAP_PERIOD_S = 2.0

    def __init__(self, controller, deployment_name: str, *, block_size: int = 16,
                 max_tracked_prefixes: int = 8192, imbalance_tolerance: int = 4,
                 locality_bonus: float = 1.0):
        self.block_size = block_size
        self.max_tracked_prefixes = max_tracked_prefixes
        self.imbalance_tolerance = imbalance_tolerance
        self.locality_bonus = locality_bonus
        # prefix hash -> replica key, LRU-ordered (most recent last)
        self._prefix_owner: "OrderedDict[int, str]" = OrderedDict()
        # replica key -> node hex ("head" for head-host replicas); refreshed
        # with the replica list — the decode placement signal
        self._replica_nodes: dict[str, str] = {}
        self._live_snapshot: frozenset = frozenset()
        self._nodes_fetched = 0.0  # last node-map fetch (NODE_MAP_PERIOD_S)
        self._io_cache: tuple = (0.0, {})
        self._io_view_fn = _default_io_view  # test seam
        super().__init__(controller, deployment_name)

    # ---- hint extraction ----
    def _routing_hint(self, method_name: str, args, kwargs):
        body = args[0] if args else kwargs.get("body")
        if isinstance(body, dict):
            hint = None
            handoff = body.get("handoff")
            if isinstance(handoff, dict) and isinstance(
                    handoff.get("kv_ref"), dict):
                hint = ("decode", handoff["kv_ref"])
            else:
                ids = body.get("prompt_ids")
                if isinstance(ids, (list, tuple)) and ids:
                    hint = ("prefix", list(ids))
            if hint is not None:
                a = body.get("_anatomy")
                if isinstance(a, dict):
                    # the ledger's router_decision stamp records WHICH
                    # routing mode placed the request (prefix affinity vs
                    # decode placement scoring)
                    a["route"] = hint[0]
                return hint
        return None

    def _block_hashes(self, prompt_ids: list) -> list[int]:
        """Cumulative content hashes of block-aligned prefixes (longest last),
        mirroring BlockPool.lookup_prefix's addressing."""
        out = []
        h = 0
        bs = self.block_size
        for i in range(0, len(prompt_ids) - len(prompt_ids) % bs, bs):
            h = hash((h, tuple(prompt_ids[i : i + bs])))
            out.append(h)
        return out

    # ---- refresh: prune owners/nodes of removed replicas ----
    def _fetch_node_map(self) -> "dict | None":
        """Pull the replica->node map from the controller (None: keep the
        last map). Overridable seam: the front door's epoch-fed variant
        reads the map from its local routing epoch instead of this RPC."""
        try:
            return ray_tpu_torch.get(self._controller.get_replica_nodes.remote(
                self._name), timeout=2)
        except Exception:
            return None  # older controller / transient failure

    def _refresh(self) -> None:
        before = self._last_refresh
        super()._refresh()
        if self._last_refresh == before:
            return  # base refresh didn't run this cycle
        nodes = None
        now = time.monotonic()
        if now - self._nodes_fetched >= self.NODE_MAP_PERIOD_S:
            self._nodes_fetched = now
            nodes = self._fetch_node_map()
        # warm the io-pressure cache OUTSIDE the lock: node_io_view() is a
        # full metrics rollup, and _select_decode (which reads it) runs
        # under the router lock on the request path
        self._io_pressure()
        with self._lock:
            live = frozenset(self._rkey(r) for r in self._replicas)
            if isinstance(nodes, dict):
                self._replica_nodes = {k: n for k, n in nodes.items()
                                       if k in live}
            self._prune_stale_owners(live)

    def _prune_stale_owners(self, live: frozenset) -> None:
        """Drop prefix entries owned by removed replicas (under the lock).
        A removed replica's cache is gone with it: keeping its entries
        burns every longest-prefix lookup on ``owner not in live`` misses
        and pins LRU slots until the bound finally evicts them."""
        if live == self._live_snapshot:
            return  # replica set unchanged: nothing to prune
        self._live_snapshot = live
        for h in [h for h, o in self._prefix_owner.items()
                  if o not in live]:
            del self._prefix_owner[h]

    # ---- selection ----
    def _select(self, hint):
        # called under self._lock with >=2 replicas. ``hint`` is
        # ("prefix", prompt_ids) | ("decode", kv_ref) | a bare prompt-id
        # list (legacy callers) | None.
        if isinstance(hint, tuple) and len(hint) == 2:
            kind, payload = hint
        elif hint:
            kind, payload = "prefix", hint
        else:
            kind, payload = None, None
        if kind == "decode":
            return self._select_decode(payload)
        if kind == "prefix":
            live = {self._rkey(r): r for r in self._replicas}
            min_load = min(self._inflight.get(k, 0) for k in live)
            hashes = self._block_hashes(payload)
            for h in reversed(hashes):  # longest prefix first
                owner = self._prefix_owner.get(h)
                if owner is None or owner not in live:
                    continue
                if (self._inflight.get(owner, 0)
                        <= min_load + self.imbalance_tolerance):
                    self._prefix_owner.move_to_end(h)
                    self._claim(hashes, owner)
                    return live[owner]
                break  # affinity exists but the owner is overloaded: balance
            chosen = super()._select(None)
            self._claim(hashes, self._rkey(chosen))
            return chosen
        return super()._select(None)

    def _select_decode(self, kv_ref):
        """Decode-side placement: least loaded replica, discounted toward
        the handoff holder's node, penalized by per-node I/O pressure.
        Runs under the router lock: ``_io_pressure`` is a cache hit here in
        steady state because ``_refresh`` warms it outside the lock."""
        live = {self._rkey(r): r for r in self._replicas}
        holder = kv_ref.get("node") if isinstance(kv_ref, dict) else None
        io = self._io_pressure()
        best_key = None
        best_score = None
        keys = list(live)
        random.shuffle(keys)  # break score ties fairly
        for key in keys:
            node = self._replica_nodes.get(key)
            score = float(self._inflight.get(key, 0))
            if node is not None:
                score += io.get(node, 0.0)
                if holder is not None and node == holder:
                    score -= self.locality_bonus
            if best_score is None or score < best_score:
                best_key, best_score = key, score
        return live[best_key]

    def _io_pressure(self) -> dict:
        """node hex -> queue-depth-equivalent I/O pressure, from
        ``state.node_io_view()`` (head-local aggregation; sampled at most
        once a second; {} where the view is unavailable, e.g. in workers)."""
        now = time.monotonic()
        ts, cached = self._io_cache
        if now - ts < 1.0:
            return cached
        pressure: dict = {}
        try:
            view = self._io_view_fn()
            for node, row in (view.get("nodes") or {}).items():
                pending = float(row.get("pending_pull_bytes", 0) or 0)
                pending += sum(
                    (row.get("holder_pending_bytes") or {}).values())
                pressure[node] = min(self.IO_PRESSURE_CAP,
                                     pending / float(self.IO_PRESSURE_SCALE))
        except Exception:
            pressure = {}
        self._io_cache = (now, pressure)
        return pressure

    def _claim(self, hashes: list[int], replica_key: str) -> None:
        for h in hashes:
            self._prefix_owner[h] = replica_key
            self._prefix_owner.move_to_end(h)
        while len(self._prefix_owner) > self.max_tracked_prefixes:
            self._prefix_owner.popitem(last=False)


ROUTER_CLASSES = {"pow2": Router, "kv_aware": KVAwareRouter}


def make_router(kind: str, controller, deployment_name: str) -> Router:
    cls = ROUTER_CLASSES.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown request_router {kind!r} (known: {sorted(ROUTER_CLASSES)})"
        )
    return cls(controller, deployment_name)
