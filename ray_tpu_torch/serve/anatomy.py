"""Serve request anatomy: a per-request phase ledger and an SLO scoreboard
(copied from ray_tpu/serve/anatomy.py).

Every serve request gets a ledger of monotonic phase clocks along its path:

    ingress_admit -> router_decision -> replica_queue_wait -> prefill_exec
    -> kv_publish -> kv_pull -> decode_first_token -> stream_complete

so a TTFT regression is attributable to a phase, not just visible. A stamp
is one append into a bounded process-local ring (no instruments, no lock
beyond the ring's). Reading a view folds the ring into per-request ledgers
and a per-deployment SLO scoreboard: rolling TTFT/TPOT quantiles, goodput
against ``DeploymentConfig.slo_ttft_ms``, and a predicted TTFT per replica
(its routers' in-flight depth times the deployment's recent service time),
which admission control and the SLO autoscaler read.

The port runs in one process, so every stamp lands in this ring and folds
under node ``"head"`` on one clock. ``ingest_remote`` and ``adopt`` (a
batch of another process's entries) and ``link_kv``/``kv_window`` (the PD
transport's handoff windows) keep the reference's signatures, though
nothing in one process feeds them yet. Kill switch:
``RAY_TPU_SERVE_ANATOMY=0``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
from collections import OrderedDict, deque

from ray_tpu_torch.util import flight_recorder
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

# Canonical phase order. "Complete" means all
# eight are present and their aligned t0s are non-decreasing in this order.
PHASES = (
    "ingress_admit",
    "router_decision",
    "replica_queue_wait",
    "prefill_exec",
    "kv_publish",
    "kv_pull",
    "decode_first_token",
    "stream_complete",
)

# env-gated so the overhead A/B can switch the whole recording path off;
# checked per stamp as one module-global load (timeline._ENABLED idiom)
_ENABLED = os.environ.get("RAY_TPU_SERVE_ANATOMY", "1") != "0"
# wall = monotonic + anchor for THIS process (one-time clock pair read)
_MONO_ANCHOR = time.time() - time.monotonic()

MAX_EVENTS = int(os.environ.get("RAY_TPU_SERVE_ANATOMY_EVENTS", "8192"))
MAX_LEDGERS = 512        # head-side assembled ledgers (LRU by admission)
MAX_KV_WINDOWS = 1024    # unjoined oid-keyed publish/pull windows
BOARD_WINDOW = 512       # rolling TTFT/TPOT samples per deployment
_BREACH_EVENT_MIN_GAP_S = 1.0   # flight-ring cardinality bound per (dep, ev)

_lock = threading.Lock()
_ring: deque = deque(maxlen=MAX_EVENTS)
_seq = itertools.count(1)

# ------------------------------------------------------------- instruments
# Bound handles are cached per deployment (names are dynamic, so the bind
# happens on a deployment's FIRST settled request, then every later request
# records through the cached handle — amortized bind-only). All recording
# happens head-side at fold/settle time, never on the request path.
_M_TTFT = Histogram(
    "ray_tpu_serve_ttft_ms",
    "Client-visible time-to-first-token per deployment (ms)",
    boundaries=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 10000),
    tag_keys=("deployment",))
_M_TPOT = Histogram(
    "ray_tpu_serve_tpot_ms",
    "Time-per-output-token after the first token (ms)",
    boundaries=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250),
    tag_keys=("deployment",))
_M_DONE = Counter(
    "ray_tpu_serve_requests_total",
    "Settled serve requests per deployment and outcome",
    tag_keys=("deployment", "outcome"))
_M_BREACH = Counter(
    "ray_tpu_serve_slo_breach_total",
    "Settled requests whose TTFT exceeded the deployment's declared SLO",
    tag_keys=("deployment",))
_M_PRED = Gauge(
    "ray_tpu_serve_predicted_ttft_ms",
    "Predicted TTFT per replica: queue depth x recent service time + "
    "pending KV pull bytes on the replica's node",
    tag_keys=("deployment", "replica"))
_M_SHED = Counter(
    "ray_tpu_serve_shed_total",
    "Requests refused by admission control before admit (never ledgered: "
    "sheds are invisible to the SLO scoreboard's goodput accounting)",
    tag_keys=("deployment", "reason"))

_bind_lock = threading.Lock()
_bind_cache: dict[tuple, object] = {}


def _bound(metric, **tags):
    key = (metric.name, tuple(sorted(tags.items())))
    with _bind_lock:
        h = _bind_cache.get(key)
        if h is None:
            h = _bind_cache[key] = metric.bind(tags)
        return h


def enabled() -> bool:
    return _ENABLED


def now_wall() -> float:
    return time.monotonic() + _MONO_ANCHOR


# ---------------------------------------------------------------- stamping
# Entry shapes (msgpack-native lists, like util/timeline's ring):
#   ["sp",   seq, rid, phase, t0_w, t1_w, extra|None]   request phase stamp
#   ["kv",   seq, oid_hex, kind, t0_w, t1_w, nbytes]    transport window
#   ["lk",   seq, rid, oid_hex]                         rid <-> oid join key
#   ["done", seq, rid, dep, replica, t_w, ntokens, ok, err|None]


def stamp(rid, phase: str, t0_w: float, t1_w: "float | None" = None,
          extra: "dict | None" = None) -> None:
    """One phase stamp: a single bounded-ring append (hot-path safe)."""
    if not _ENABLED or rid is None:
        return
    entry = ["sp", next(_seq), rid, phase, t0_w,
             t0_w if t1_w is None else t1_w, extra]
    with _lock:
        _ring.append(entry)


def kv_window(oid_hex, kind: str, t0_w: float, t1_w: float,
              nbytes: int) -> None:
    """Transport-side handoff window, keyed by plane object id (publish
    runs on the engine thread where no request id is in scope); joined to
    a ledger head-side via a ``link_kv`` entry. One ring append."""
    if not _ENABLED or oid_hex is None:
        return
    entry = ["kv", next(_seq), oid_hex, kind, t0_w, t1_w, nbytes]
    with _lock:
        _ring.append(entry)


def link_kv(rid, oid_hex) -> None:
    if not _ENABLED or rid is None or oid_hex is None:
        return
    entry = ["lk", next(_seq), rid, oid_hex]
    with _lock:
        _ring.append(entry)


def complete(rid, deployment: str, replica=None, ntokens: int = 0,
             ok: bool = True, err=None) -> None:
    """Front-door completion record (stream fully written / JSON reply
    built). Also stamps the ``stream_complete`` phase."""
    if not _ENABLED or rid is None:
        return
    t = now_wall()
    stamp(rid, "stream_complete", t)
    entry = ["done", next(_seq), rid, deployment, replica, t,
             int(ntokens), bool(ok), err]
    with _lock:
        _ring.append(entry)


# ------------------------------------------------- request-context helpers
def admit(body, deployment: str):
    """Front-door admission: attach a request id + admit stamp to a dict
    body. Returns the rid when THIS caller newly admitted (it then owns the
    ``complete()`` record), else None (already admitted upstream — e.g. the
    HTTP proxy admitted before the PD controller saw the body). Idempotent;
    no-op (None) when disabled or the body isn't a dict."""
    if not _ENABLED or not isinstance(body, dict):
        return None
    if isinstance(body.get("_anatomy"), dict):
        return None
    rid = uuid.uuid4().hex[:16]
    body["_anatomy"] = {"rid": rid, "dep": deployment}
    stamp(rid, "ingress_admit", now_wall(), extra={"dep": deployment})
    return rid


def rid_of(body):
    """The request id riding a body dict (None when absent/disabled)."""
    if not _ENABLED or not isinstance(body, dict):
        return None
    a = body.get("_anatomy")
    return a.get("rid") if isinstance(a, dict) else None


def router_stamp(body, deployment: str, replica_key, t0_w: float) -> None:
    """Router half: stamp the routing decision window and mark the dispatch
    wall clock on the body so the replica can account its queue wait. Two
    dict writes + one ring append, gated on the body carrying a ledger."""
    if not _ENABLED or not isinstance(body, dict):
        return
    a = body.get("_anatomy")
    if not isinstance(a, dict):
        return
    t1 = now_wall()
    a["sent_w"] = t1
    # the dispatch mark rides the body to the replica, where it becomes
    # replica_queue_wait.t0 — stamped on THIS process's clock, so carry
    # this node too for per-endpoint offset alignment at fold time
    a["sent_node"] = os.environ.get("RAY_TPU_NODE_ID", "head")
    extra = {"dep": deployment, "replica": str(replica_key)}
    route = a.get("route")
    if route:
        extra["route"] = route
    stamp(a.get("rid"), "router_decision", t0_w, t1, extra)


def replica_dequeue(body) -> None:
    """Replica half: the request left the replica's mailbox and started
    executing — the queue-wait window is [router dispatch, now]."""
    if not _ENABLED or not isinstance(body, dict):
        return
    a = body.get("_anatomy")
    if not isinstance(a, dict):
        return
    t1 = now_wall()
    t0 = a.get("sent_w")
    extra = {"pid": os.getpid()}
    sn = a.get("sent_node")
    if isinstance(t0, (int, float)) and isinstance(sn, str):
        extra["sent_node"] = sn  # t0 lives on the sender's clock
    stamp(a.get("rid"), "replica_queue_wait",
          t0 if isinstance(t0, (int, float)) else t1, t1, extra)


# --------------------------------------------------------------- shipping
def drain_since(cursor: int) -> "tuple[list, int]":
    """Entries newer than ``cursor`` + the new cursor — the metrics_push
    ``serve_phases`` incremental ship loop (timeline.drain_since contract:
    the pusher advances the cursor only after a successful notify)."""
    out = []
    with _lock:
        for e in _ring:
            if e[1] > cursor:
                out.append(e)
    return out, (out[-1][1] if out else cursor)


def local_events() -> list:
    with _lock:
        return list(_ring)


def adopt(entries) -> None:
    """Re-home another process's drained entries into THIS ring, reissuing
    sequence numbers. Pool workers own no head peer — their stamps ride the
    reply pipe (the phase_reply route) and the pool parent, which DOES run
    a metrics push loop, adopts them so its next push ships them."""
    if not _ENABLED or not isinstance(entries, (list, tuple)):
        return
    fresh = [[e[0], next(_seq), *e[2:]]
             for e in entries if _sane_entry(e)]
    if not fresh:
        return
    with _lock:
        _ring.extend(fresh)


# ------------------------------------------------------ head-side assembly
# The head folds entries (local ring + pushed serve_phases) into bounded
# ledger/scoreboard tables. Folding is lazy for the local ring (a cursor
# walk at view/scrape time) and eager for pushed batches. _is_head gates
# instrument recording so worker processes — whose entries ALSO reach the
# head via push — never double-count the cluster series.
_head_lock = threading.Lock()
_is_head = False
_local_cursor = 0
_ledgers: "OrderedDict[str, dict]" = OrderedDict()
_kv_windows: "OrderedDict[str, dict]" = OrderedDict()
_kv_links: "OrderedDict[str, str]" = OrderedDict()   # oid -> rid
_board: dict[str, dict] = {}
_slo_ms: dict[str, float] = {}
_routers: dict[int, object] = {}    # id -> weakref-like live Router
_breach_last: dict[tuple, float] = {}
# settle delay: a done ledger waits this long for straggler pushed stamps
# (first token from a remote decode replica) before its TTFT is scored
_SETTLE_S = 1.5 * float(os.environ.get("RAY_TPU_METRICS_PUSH_PERIOD_S", "2")
                        or 2)


def mark_head() -> None:
    global _is_head
    _is_head = True


def set_slo(deployment: str, slo_ttft_ms) -> None:
    """Controller-side registration of a deployment's declared TTFT SLO
    (``DeploymentConfig.slo_ttft_ms``); the controller runs on the head."""
    mark_head()
    with _head_lock:
        if slo_ttft_ms is None:
            dropped = _slo_ms.pop(deployment, None)
        else:
            dropped = None
            _slo_ms[deployment] = float(slo_ttft_ms)
    del dropped  # dies after release (ref-drop-under-lock contract)


def slo_ttft_ms(deployment: str) -> "float | None":
    """The TTFT SLO ``set_slo`` declared for ``deployment`` (None: none)."""
    with _head_lock:
        return _slo_ms.get(deployment)


def register_router(router) -> None:
    """Expose a live Router's per-replica in-flight depths to the
    predicted-TTFT estimator (head-visible routers only — the estimator is
    a head-side view). Held weakly via the registry's identity key."""
    import weakref

    try:
        _routers[id(router)] = weakref.ref(router)
    except TypeError:
        pass


def retire_replica(deployment: str, replica_keys) -> None:
    """Drop a removed replica's scoreboard presence + its predicted-TTFT
    series immediately (the controller calls it when it kills a replica)."""
    keys = {str(k) for k in replica_keys}
    with _head_lock:
        b = _board.get(deployment)
        if b:
            for k in keys:
                b["replicas"].pop(k, None)
    with _bind_lock:
        # popped handles held past the lock (ref-drop-under-lock contract)
        dropped = [_bind_cache.pop(bk, None)
                   for bk in [k for k in _bind_cache
                              if k[0] == _M_PRED.name
                              and dict(k[1]).get("replica") in keys]]
    del dropped


def _board_for(dep: str) -> dict:
    b = _board.get(dep)
    if b is None:
        b = _board[dep] = {
            "admitted": 0, "completed": 0, "errors": 0,
            "slo_ok": 0, "slo_breach": 0,
            "ttft_ms": deque(maxlen=BOARD_WINDOW),
            "tpot_ms": deque(maxlen=BOARD_WINDOW),
            "service_ewma_s": None,
            "replicas": {},
        }
    return b


def _sane_entry(e) -> bool:
    if not isinstance(e, (list, tuple)) or len(e) < 4:
        return False
    kind = e[0]
    if kind == "sp":
        return (len(e) >= 7 and isinstance(e[3], str)
                and isinstance(e[4], (int, float))
                and isinstance(e[5], (int, float)))
    if kind == "kv":
        return (len(e) >= 7 and isinstance(e[3], str)
                and isinstance(e[4], (int, float))
                and isinstance(e[5], (int, float)))
    if kind == "lk":
        return len(e) >= 4
    if kind == "done":
        return len(e) >= 9 and isinstance(e[5], (int, float))
    return False


def _ledger_for(rid: str) -> dict:
    led = _ledgers.get(rid)
    if led is None:
        led = _ledgers[rid] = {
            "rid": rid, "dep": None, "phases": {}, "done": None,
            "settled": False, "seen": time.monotonic(),
        }
        while len(_ledgers) > MAX_LEDGERS:
            _ledgers.popitem(last=False)
    return led


def _fold_one(e, node: str) -> None:
    """Fold one sanitized entry into the head tables (caller holds
    _head_lock)."""
    kind = e[0]
    if kind == "sp":
        rid, phase, t0, t1, extra = str(e[2]), e[3], e[4], e[5], e[6]
        if phase not in PHASES:
            return
        led = _ledger_for(rid)
        prev = led["phases"].get(phase)
        if (prev is not None
                and phase in ("router_decision", "replica_queue_wait")
                and prev[0] <= float(t0)):
            # the PD path routes twice with one rid (prefill leg, then
            # decode leg): the FIRST leg is the canonical routing/queue
            # phase, or the ledger's phase clocks go non-monotonic
            return
        led["phases"][phase] = [float(t0), float(t1), node,
                                extra if isinstance(extra, dict) else None]
        if (phase == "ingress_admit" and isinstance(extra, dict)
                and extra.get("dep")):
            if led["dep"] is None:
                _board_for(str(extra["dep"]))["admitted"] += 1
            led["dep"] = str(extra["dep"])
    elif kind == "kv":
        oid, wkind, t0, t1, nbytes = (str(e[2]), e[3], float(e[4]),
                                      float(e[5]), e[6])
        rid = _kv_links.get(oid)
        if rid is not None and rid in _ledgers:
            if wkind in PHASES:
                _ledgers[rid]["phases"][wkind] = [
                    t0, t1, node, {"nbytes": nbytes}]
            return
        win = _kv_windows.get(oid)
        if win is None:
            win = _kv_windows[oid] = {}
            while len(_kv_windows) > MAX_KV_WINDOWS:
                _kv_windows.popitem(last=False)
        win[wkind] = [t0, t1, node, nbytes]
    elif kind == "lk":
        rid, oid = str(e[2]), str(e[3])
        _kv_links[oid] = rid
        while len(_kv_links) > MAX_KV_WINDOWS:
            _kv_links.popitem(last=False)
        win = _kv_windows.pop(oid, None)
        if win:
            led = _ledger_for(rid)
            for wkind, (t0, t1, wnode, nbytes) in win.items():
                if wkind in PHASES:
                    led["phases"][wkind] = [t0, t1, wnode,
                                            {"nbytes": nbytes}]
    elif kind == "done":
        rid, dep, replica, t, ntok, ok, err = (
            str(e[2]), e[3], e[4], float(e[5]), e[6], e[7], e[8])
        led = _ledger_for(rid)
        if dep:
            led["dep"] = str(dep)
        led["done"] = {"t": t, "node": node,
                       "replica": str(replica) if replica else None,
                       "ntokens": int(ntok or 0), "ok": bool(ok),
                       "err": str(err) if err else None,
                       "folded": time.monotonic()}


def ingest_remote(node_hex: str, source: str, entries) -> None:
    """Head side: fold one process's pushed ``serve_phases`` batch in,
    tagged with the origin node (shape-sanitized like timeline's — one
    buggy pusher degrades to missing phases, never a head crash)."""
    mark_head()
    if not isinstance(entries, (list, tuple)):
        return
    with _head_lock:
        for e in entries:
            if _sane_entry(e):
                _fold_one(e, str(node_hex))


def _fold_local() -> None:
    """Fold this process's own ring into the tables (the head's front door
    and in-thread replicas stamp into the local ring — they never push to
    themselves). Cursor-tracked so each entry folds once; the ring itself
    stays intact for the push path's independent cursor."""
    global _local_cursor
    with _lock:
        fresh = [e for e in _ring if e[1] > _local_cursor]
        if fresh:
            _local_cursor = fresh[-1][1]
    if not fresh:
        return
    with _head_lock:
        for e in fresh:
            if _sane_entry(e):
                _fold_one(e, "head")


def _aligned(t: float, node: str, offsets: dict) -> float:
    # timeline clock offsets estimate node_wall - head_wall; subtracting
    # rebases a remote stamp onto the head's clock
    return t - offsets.get(node, 0.0) if node != "head" else t


def _ledger_times(led: dict, offsets: dict):
    """(ttft_s, tpot_s, total_s) for a done ledger, head-clock aligned.
    TTFT prefers the decode first token; a ledger that never grew one
    (non-PD path, lost stamps) falls back to completion time."""
    done = led["done"]
    admit = led["phases"].get("ingress_admit")
    if done is None or admit is None:
        return None, None, None
    t0 = _aligned(admit[0], admit[2], offsets)
    t_end = _aligned(done["t"], done["node"], offsets)
    ft = led["phases"].get("decode_first_token")
    t_first = _aligned(ft[1], ft[2], offsets) if ft else t_end
    ttft = max(0.0, t_first - t0)
    ntok = done["ntokens"]
    tpot = (max(0.0, t_end - t_first) / (ntok - 1)) if ntok > 1 else None
    return ttft, tpot, max(0.0, t_end - t0)


def _flight_limited(dep: str, event: str, **fields) -> None:
    """Flight-ring event with per-(deployment, event) rate limiting —
    bounded cardinality no matter the request rate."""
    now = time.monotonic()
    key = (dep, event)
    last = _breach_last.get(key)
    if last is not None and now - last < _BREACH_EVENT_MIN_GAP_S:
        return
    _breach_last[key] = now
    flight_recorder.record("serve", event, deployment=dep, **fields)


def record_shed(deployment: str, reason: str) -> None:
    """Admission-control shed event (serve/admission.py is the consumer:
    each ingress calls this BEFORE ``admit``, so a shed request never
    creates a ledger and never scores as an SLO breach)."""
    _bound(_M_DONE, deployment=deployment, outcome="shed").inc()
    _bound(_M_SHED, deployment=deployment, reason=reason).inc()
    _flight_limited(deployment, "shed", reason=reason)


def record_reprefill(deployment: str, replica, err: str) -> None:
    """A decode replica lost the KV handoff and the controller re-ran
    prefill — rare but load-bearing (capacity burned twice)."""
    _flight_limited(deployment, "reprefill_after_lost_handoff",
                    replica=str(replica), error=err[:200])


def _settle(offsets: dict) -> None:
    """Score done ledgers into the scoreboard. A done ledger waits up to
    _SETTLE_S for straggler pushed stamps (the decode replica's first-token
    stamp arrives on the next push beat) so TTFT is scored from the real
    first token whenever one exists. Caller holds _head_lock."""
    now = time.monotonic()
    for led in _ledgers.values():
        done = led["done"]
        if done is None or led["settled"]:
            continue
        has_ft = "decode_first_token" in led["phases"]
        if not has_ft and now - done["folded"] < _SETTLE_S:
            continue
        led["settled"] = True
        dep = led["dep"] or "unknown"
        b = _board_for(dep)
        b["completed"] += 1
        outcome = "ok" if done["ok"] else "error"
        if not done["ok"]:
            b["errors"] += 1
        _bound(_M_DONE, deployment=dep, outcome=outcome).inc()
        if done["replica"]:
            rep = b["replicas"].setdefault(
                done["replica"], {"requests": 0, "last_seen": 0.0})
            rep["requests"] += 1
            rep["last_seen"] = time.time()
        ttft, tpot, _total = _ledger_times(led, offsets)
        if ttft is None:
            continue
        b["ttft_ms"].append(ttft * 1000.0)
        _bound(_M_TTFT, deployment=dep).observe(ttft * 1000.0)
        if tpot is not None:
            b["tpot_ms"].append(tpot * 1000.0)
            _bound(_M_TPOT, deployment=dep).observe(tpot * 1000.0)
        ewma = b["service_ewma_s"]
        b["service_ewma_s"] = (ttft if ewma is None
                               else 0.8 * ewma + 0.2 * ttft)
        slo = _slo_ms.get(dep)
        if slo is not None:
            if ttft * 1000.0 <= slo:
                b["slo_ok"] += 1
            else:
                b["slo_breach"] += 1
                _bound(_M_BREACH, deployment=dep).inc()
                _flight_limited(dep, "slo_breach", ttft_ms=ttft * 1000.0,
                                slo_ttft_ms=slo,
                                replica=done["replica"] or "")


def _fold_and_settle() -> dict:
    from ray_tpu_torch.util import timeline

    _fold_local()
    offsets = timeline.clock_offsets()
    with _head_lock:
        _settle(offsets)
    return offsets


# ------------------------------------------------------- predicted TTFT
def _predicted_pairs() -> list:
    """(tags, predicted_ttft_ms) per (deployment, replica): in-flight depth
    x the deployment's recent service time + the replica node's pending KV
    pull bytes over its observed pull bandwidth (node_io_view inputs)."""
    if not _is_head:
        return []
    from ray_tpu_torch.util import metrics as _metrics

    rollup = _metrics.node_io_rollup()
    pend = rollup.get("inflight", {})
    rate = rollup.get("pull_rate", {})
    out = []
    dead = []
    with _head_lock:
        boards = {d: b.get("service_ewma_s") for d, b in _board.items()}
    for key, ref in list(_routers.items()):
        r = ref() if callable(ref) else None
        if r is None:
            dead.append(key)
            continue
        try:
            dep = getattr(r, "_name", None) or "unknown"
            depths = r.inflight_snapshot()
            nodes = getattr(r, "_replica_nodes", None) or {}
        except Exception:
            continue
        svc = boards.get(dep) or 0.05
        for rep_key, depth in depths.items():
            node = nodes.get(rep_key)
            pend_b = pend.get(node, 0.0) if node else 0.0
            bw = max(rate.get(node, 0.0), 64e6) if node else 64e6
            pred = (depth * svc + pend_b / bw) * 1000.0
            out.append(({"deployment": dep, "replica": str(rep_key)}, pred))
    for key in dead:
        _routers.pop(key, None)
    return out


_M_PRED.attach_producer(_predicted_pairs)


def service_estimate(deployment: str) -> "float | None":
    """The deployment's scoreboard service-time EWMA in seconds (None until
    a request completes). The controller folds this into routing epochs as
    the ingress fleet's admission-predictor hint."""
    with _head_lock:
        b = _board.get(deployment)
        return b.get("service_ewma_s") if b else None


def predicted_ttft_by_deployment() -> dict:
    """deployment -> worst-replica predicted TTFT in ms (head-side rollup
    of the per-replica estimator; the SLO autoscaler's breach signal)."""
    out: dict = {}
    for tags, pred in _predicted_pairs():
        dep = tags["deployment"]
        if pred > out.get(dep, -1.0):
            out[dep] = pred
    return out


# ---------------------------------------------------------------- views
def _quantiles(samples) -> dict:
    if not samples:
        return {"n": 0}
    s = sorted(samples)
    n = len(s)

    def q(p):
        return s[min(n - 1, int(p * (n - 1) + 0.5))]

    return {"n": n, "p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
            "max": s[-1]}


def _phase_durs(led: dict, offsets: dict) -> dict:
    """Attributable per-phase durations: a window phase contributes its own
    width; an instant phase contributes the gap since the previous present
    phase's end — so the eight durations decompose the request's latency."""
    out = {}
    prev_t1 = None
    for p in PHASES:
        w = led["phases"].get(p)
        if w is None:
            continue
        t0 = _aligned(w[0], w[2], offsets)
        t1 = _aligned(w[1], w[2], offsets)
        if t1 > t0:
            out[p] = t1 - t0
        elif prev_t1 is not None:
            out[p] = max(0.0, t1 - prev_t1)
        else:
            out[p] = 0.0
        prev_t1 = t1
    return out


def ledger_complete(led_view: dict) -> bool:
    """All eight phases present with non-decreasing aligned start clocks."""
    phases = led_view.get("phases", {})
    if any(p not in phases for p in PHASES):
        return False
    t0s = [phases[p]["t0"] for p in PHASES]
    return all(b >= a for a, b in zip(t0s, t0s[1:]))


def serve_view(limit: int = 64) -> dict:
    """The head's serve anatomy view: per-deployment SLO scoreboard +
    predicted TTFT and the most recent assembled request ledgers (phase
    windows aligned to the head clock)."""
    mark_head()
    offsets = _fold_and_settle()
    with _head_lock:
        leds = list(_ledgers.values())[-limit:]
        requests = []
        for led in leds:
            phases = {}
            for p, (t0, t1, node, extra) in led["phases"].items():
                # a queue-wait window straddles two clocks: t0 (the router's
                # dispatch mark) was stamped on the SENDER's clock, t1 on the
                # replica's — align each end with its own node's offset
                t0_node = node
                if isinstance(extra, dict) and "sent_node" in extra:
                    t0_node = extra["sent_node"]
                phases[p] = {"t0": _aligned(t0, t0_node, offsets),
                             "t1": _aligned(t1, node, offsets),
                             "node": node}
                if extra:
                    phases[p]["extra"] = extra
            ttft, tpot, total = _ledger_times(led, offsets)
            row = {"rid": led["rid"], "deployment": led["dep"],
                   "phases": phases, "done": led["done"] is not None,
                   "ok": bool(led["done"] and led["done"]["ok"]),
                   "ntokens": led["done"]["ntokens"] if led["done"] else 0,
                   "ttft_ms": ttft * 1000.0 if ttft is not None else None,
                   "tpot_ms": tpot * 1000.0 if tpot is not None else None,
                   "total_ms": total * 1000.0 if total is not None else None}
            row["complete"] = ledger_complete(row)
            requests.append(row)
        deployments = {}
        for dep, b in _board.items():
            scored = b["slo_ok"] + b["slo_breach"]
            deployments[dep] = {
                "admitted": b["admitted"], "completed": b["completed"],
                "errors": b["errors"],
                "ttft_ms": _quantiles(b["ttft_ms"]),
                "tpot_ms": _quantiles(b["tpot_ms"]),
                "slo_ttft_ms": _slo_ms.get(dep),
                "slo_ok": b["slo_ok"], "slo_breach": b["slo_breach"],
                "goodput": (b["slo_ok"] / scored) if scored else None,
                "service_ewma_s": b["service_ewma_s"],
                "replicas": {k: dict(v) for k, v in b["replicas"].items()},
            }
    for tags, pred in _predicted_pairs():
        d = deployments.get(tags["deployment"])
        if d is not None:
            d.setdefault("predicted_ttft_ms", {})[tags["replica"]] = pred
    return {"enabled": _ENABLED, "deployments": deployments,
            "requests": requests, "clock_offsets": dict(offsets)}


def phase_breakdown(since_wall: "float | None" = None) -> dict:
    """Per-phase duration quantiles (ms) over done ledgers admitted at or
    after ``since_wall`` — the serve_bench per-rate attribution table."""
    offsets = _fold_and_settle()
    per_phase: dict[str, list] = {p: [] for p in PHASES}
    n = 0
    with _head_lock:
        for led in _ledgers.values():
            if led["done"] is None:
                continue
            admit_w = led["phases"].get("ingress_admit")
            if admit_w is None:
                continue
            if (since_wall is not None
                    and _aligned(admit_w[0], admit_w[2], offsets)
                    < since_wall):
                continue
            n += 1
            for p, dur in _phase_durs(led, offsets).items():
                per_phase[p].append(dur * 1000.0)
    out = {"requests": n, "phases": {}}
    for p, durs in per_phase.items():
        if not durs:
            continue
        q = _quantiles(durs)
        out["phases"][p] = {"n": q["n"], "p50_ms": q["p50"],
                            "p99_ms": q["p99"]}
    return out


# ------------------------------------------------------- timeline export
def trace_events(limit: int = 64) -> list:
    """Perfetto rows for the serve request lanes, merged into the
    timeline export: one thread per recent request carrying its phase
    spans, plus flow arrows stitching ingress -> prefill -> decode (the KV
    handoff window rides the kv_publish -> kv_pull arrow)."""
    offsets = _fold_and_settle()
    PID = 95
    # "cat" present on every event — the timeline contract (consumers
    # index by it freely, e.g. state.timeline() filters)
    events: list = [
        {"ph": "M", "pid": PID, "cat": "meta", "name": "process_name",
         "args": {"name": "serve: request anatomy"}},
        {"ph": "M", "pid": PID, "cat": "meta", "name": "process_sort_index",
         "args": {"sort_index": 95}},
    ]
    # arrows between these phase pairs make the cross-node path one
    # connected trace in the Perfetto flow UI
    FLOWS = (("router_decision", "replica_queue_wait"),
             ("kv_publish", "kv_pull"),
             ("kv_pull", "decode_first_token"))
    with _head_lock:
        leds = list(_ledgers.values())[-limit:]
        for tid, led in enumerate(leds, start=1):
            name = f"{led['dep'] or '?'} {led['rid'][:8]}"
            events.append({"ph": "M", "pid": PID, "tid": tid, "cat": "meta",
                           "name": "thread_name", "args": {"name": name}})
            spans = {}
            for p, (t0, t1, node, extra) in led["phases"].items():
                a0 = _aligned(t0, node, offsets)
                a1 = _aligned(t1, node, offsets)
                args = {"node": node, "rid": led["rid"]}
                if extra:
                    args.update({k: v for k, v in extra.items()
                                 if isinstance(v, (str, int, float, bool))})
                ev = {"ph": "X", "pid": PID, "tid": tid, "cat": "serve",
                      "name": p, "ts": a0 * 1e6,
                      "dur": max((a1 - a0) * 1e6, 1.0), "args": args}
                spans[p] = ev
                events.append(ev)
            for i, (src, dst) in enumerate(FLOWS):
                s, f = spans.get(src), spans.get(dst)
                if s is None or f is None:
                    continue
                fid = f"serve:{led['rid']}:{i}"
                events.append({"ph": "s", "pid": PID, "tid": tid,
                               "cat": "serve", "name": "serve_flow",
                               "id": fid,
                               "ts": s["ts"] + s["dur"]})
                events.append({"ph": "f", "pid": PID, "tid": tid,
                               "cat": "serve", "name": "serve_flow",
                               "id": fid, "bp": "e", "ts": f["ts"]})
    return events


def clear() -> None:
    """Test isolation: forget every ring, ledger, and scoreboard entry.
    Containers are swapped for fresh ones under their locks and the old
    ones die AFTER release (the ref-drop-under-lock contract)."""
    global _ring, _local_cursor, _ledgers, _kv_windows, _kv_links
    global _board, _slo_ms, _breach_last, _bind_cache
    dropped = []
    with _lock:
        dropped.append(_ring)
        _ring = deque(maxlen=MAX_EVENTS)
    with _head_lock:
        dropped.extend((_ledgers, _kv_windows, _kv_links, _board,
                        _slo_ms, _breach_last))
        _ledgers = OrderedDict()
        _kv_windows = OrderedDict()
        _kv_links = OrderedDict()
        _board = {}
        _slo_ms = {}
        _breach_last = {}
    _local_cursor = 0
    with _bind_lock:
        dropped.append(_bind_cache)
        _bind_cache = {}
    del dropped
