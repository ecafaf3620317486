"""Request anatomy in the port (ray_tpu_torch.serve.anatomy) against the
reference module (ray_tpu.serve.anatomy) on the same stamp sequences, the
assertions of tests/test_serve_anatomy.py that one process can make, and
the hooks the port's controller, router, replica and HTTP proxy stamp.

Every test runs under a deadline of its own (SIGALRM), binds port 0 and
fails on a leftover non-daemon thread."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.serve import anatomy as ref_anatomy
from ray_tpu.util import flight_recorder as ref_flight
from ray_tpu.util import metrics as ref_metrics
from ray_tpu.util import timeline as ref_timeline
from ray_tpu_torch import serve
from ray_tpu_torch.serve import anatomy
from ray_tpu_torch.util import flight_recorder, metrics

DEADLINE_S = 60
MODULES = {"reference": (ref_anatomy, ref_flight, ref_metrics),
           "port": (anatomy, flight_recorder, metrics)}


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    anatomy.clear()
    ref_anatomy.clear()
    try:
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            anatomy.clear()
            ref_anatomy.clear()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


# ------------------------------------------------ the same stamps, both modules
def _scenario(mod, seed: int, tag: str, monkeypatch) -> dict:
    """Drive one seeded request mix through ``mod``'s stamping API on a
    fake clock and fake ids (identical for both modules), then read every
    view back with the fields that hold wall or process time removed."""
    rng = np.random.default_rng(seed)
    clock = iter(np.cumsum(rng.uniform(1e-4, 5e-2, 4096)) + 1.0e9)
    ids = iter(range(1, 10_000))
    monkeypatch.setattr(mod, "now_wall", lambda: float(next(clock)))
    monkeypatch.setattr(mod, "_SETTLE_S", 0.0)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids) << 64))
    # the reference folds in the clock offsets its process learned from
    # other nodes' heartbeats, which an earlier test in the same worker may
    # have left; one node, as the port is, has none
    monkeypatch.setattr(ref_timeline, "clock_offsets", lambda: {})
    mod.mark_head()
    deps = [f"{tag}-a", f"{tag}-b"]
    mod.set_slo(deps[0], 40.0)
    replicas = ["r0", "r1", "r2"]
    for _ in range(int(rng.integers(12, 20))):
        dep = deps[int(rng.integers(0, 2))]
        body = {"prompt_ids": [1, 2, 3]}
        rid = mod.admit(body, dep)
        if rng.random() < 0.1:
            continue  # still in flight: a ledger that never completes
        mod.router_stamp(body, dep, replicas[int(rng.integers(0, 3))], mod.now_wall())
        mod.replica_dequeue(body)
        if rng.random() < 0.7:
            t0 = mod.now_wall()
            mod.stamp(rid, "prefill_exec", t0, mod.now_wall())
        if rng.random() < 0.8:
            mod.stamp(rid, "decode_first_token", mod.now_wall())
        ok = bool(rng.random() < 0.9)
        mod.complete(rid, dep, replica=replicas[int(rng.integers(0, 3))],
                     ntokens=int(rng.integers(0, 9)), ok=ok, err=None if ok else "boom")
    view = mod.serve_view(limit=512)
    for d in view["deployments"].values():
        for rep in d["replicas"].values():
            rep.pop("last_seen")
    for row in view["requests"]:
        for p in row["phases"].values():
            if isinstance(p.get("extra"), dict):
                p["extra"].pop("pid", None)
    return {"view": view, "breakdown": mod.phase_breakdown(),
            "trace": mod.trace_events(limit=512),
            "estimate": [mod.service_estimate(d) for d in deps]}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_stamps_fold_to_the_same_ledgers_and_scoreboard(seed, monkeypatch):
    """Ledgers, phase windows and durations, TTFT/TPOT quantiles, goodput,
    the service-time estimate and the Perfetto rows are the reference's."""
    got = {}
    for name, (mod, flight, mets) in MODULES.items():
        got[name] = _scenario(mod, seed, f"parity{seed}", monkeypatch)
    assert got["port"] == got["reference"]
    assert got["port"]["view"]["deployments"][f"parity{seed}-a"]["slo_ttft_ms"] == 40.0


@pytest.mark.parametrize("seed", [3, 4])
def test_same_breaches_and_series_in_both_registries(seed, monkeypatch):
    """The settled requests land in the same TTFT histogram, the same
    requests_total outcomes and the same breach counter in the port's
    registry as in the reference's, and the same slo_breach flight events."""
    tag = f"series{seed}-{uuid.uuid4().hex[:6]}"
    out = {}
    for name, (mod, flight, mets) in MODULES.items():
        _scenario(mod, seed, tag, monkeypatch)
        snap = mets.registry_snapshot()
        series = {}
        for metric in ("ray_tpu_serve_ttft_ms", "ray_tpu_serve_tpot_ms",
                       "ray_tpu_serve_requests_total", "ray_tpu_serve_slo_breach_total"):
            for key, val in snap.get(metric, {}).items():
                if str(dict(key).get("deployment", "")).startswith(tag):
                    series[(metric, key)] = val
        breaches = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                    for e in flight.records("serve")
                    if e.get("deployment", "").startswith(tag)]
        out[name] = (series, breaches)
        monkeypatch.undo()
    assert out["port"] == out["reference"]
    assert out["port"][0]


# ------------------------------------------- tests/test_serve_anatomy.py, ported
def _walk_all_phases(dep="walkdep", replica="rep0", oid="ab" * 16, pause=0.002):
    body = {"prompt": "hi"}
    rid = anatomy.admit(body, dep)
    assert rid is not None
    time.sleep(pause)
    t0 = anatomy.now_wall()
    time.sleep(pause)
    anatomy.router_stamp(body, dep, replica, t0)
    time.sleep(pause)
    anatomy.replica_dequeue(body)
    time.sleep(pause)
    t0 = anatomy.now_wall()
    time.sleep(pause)
    anatomy.stamp(rid, "prefill_exec", t0, anatomy.now_wall())
    t0 = anatomy.now_wall()
    time.sleep(pause)
    anatomy.kv_window(oid, "kv_publish", t0, anatomy.now_wall(), 1 << 20)
    anatomy.link_kv(rid, oid)
    t0 = anatomy.now_wall()
    time.sleep(pause)
    anatomy.kv_window(oid, "kv_pull", t0, anatomy.now_wall(), 1 << 20)
    time.sleep(pause)
    anatomy.stamp(rid, "decode_first_token", anatomy.now_wall())
    time.sleep(pause)
    anatomy.complete(rid, dep, replica=replica, ntokens=8)
    return rid


def _row(view, rid):
    rows = [r for r in view["requests"] if r["rid"] == rid]
    assert rows, f"rid {rid} not in serve_view"
    return rows[0]


def test_admit_idempotent_and_ownership():
    body = {"prompt": "x"}
    rid = anatomy.admit(body, "d1")
    assert rid is not None and anatomy.rid_of(body) == rid
    assert anatomy.admit(body, "d2") is None
    assert body["_anatomy"]["dep"] == "d1"
    assert anatomy.admit([1, 2], "d1") is None
    assert anatomy.rid_of(None) is None


def test_full_ledger_assembles_complete():
    rid = _walk_all_phases(dep="ldep")
    view = anatomy.serve_view()
    row = _row(view, rid)
    assert set(anatomy.PHASES) <= set(row["phases"])
    assert row["done"] and row["ok"] and row["complete"], row
    t0s = [row["phases"][p]["t0"] for p in anatomy.PHASES]
    assert all(b >= a for a, b in zip(t0s, t0s[1:]))
    assert row["ntokens"] == 8 and row["ttft_ms"] >= 0 and row["tpot_ms"] >= 0
    b = view["deployments"]["ldep"]
    assert b["admitted"] == 1 and b["completed"] == 1 and b["errors"] == 0
    assert b["ttft_ms"]["n"] == 1 and "rep0" in b["replicas"]


def test_first_routing_leg_wins_and_kv_windows_join_either_order():
    body = {}
    rid = anatomy.admit(body, "pd")
    t = anatomy.now_wall()
    anatomy.stamp(rid, "router_decision", t, t + 0.01)
    anatomy.stamp(rid, "router_decision", t + 0.5, t + 0.6)  # the decode leg
    w = _row(anatomy.serve_view(), rid)["phases"]["router_decision"]
    assert abs(w["t0"] - t) < 1e-6 and abs(w["t1"] - (t + 0.01)) < 1e-6
    b1, b2 = {}, {}
    r1, r2 = anatomy.admit(b1, "kv"), anatomy.admit(b2, "kv")
    anatomy.kv_window("aa" * 16, "kv_publish", t, t + 0.002, 4096)
    anatomy.link_kv(r1, "aa" * 16)  # window first, link second
    anatomy.link_kv(r2, "bb" * 16)  # link first, window second
    anatomy.kv_window("bb" * 16, "kv_pull", t, t + 0.003, 4096)
    view = anatomy.serve_view()
    assert "kv_publish" in _row(view, r1)["phases"]
    assert "kv_pull" in _row(view, r2)["phases"]


def test_incomplete_ledger_and_breakdown():
    body = {}
    rid = anatomy.admit(body, "partial")
    anatomy.complete(rid, "partial", ntokens=1)
    row = _row(anatomy.serve_view(), rid)
    assert row["done"] and not row["complete"]
    _walk_all_phases(dep="bk")
    bd = anatomy.phase_breakdown()
    assert bd["requests"] >= 1
    for p in anatomy.PHASES:
        assert bd["phases"][p]["p50_ms"] >= 0
        assert bd["phases"][p]["p99_ms"] >= bd["phases"][p]["p50_ms"] - 1e-9


def test_slo_breach_goodput_flight_event_and_prometheus():
    dep = "slodep"
    anatomy.set_slo(dep, 5.0)
    b1 = {}
    r1 = anatomy.admit(b1, dep)
    time.sleep(0.05)
    anatomy.stamp(r1, "decode_first_token", anatomy.now_wall())
    anatomy.complete(r1, dep, replica="repA", ntokens=4)
    b2 = {}
    r2 = anatomy.admit(b2, dep)
    anatomy.stamp(r2, "decode_first_token", anatomy.now_wall())
    anatomy.complete(r2, dep, replica="repA", ntokens=4)
    b = anatomy.serve_view()["deployments"][dep]
    assert b["slo_ttft_ms"] == 5.0 and b["slo_breach"] == 1 and b["slo_ok"] == 1
    assert b["goodput"] == 0.5
    recs = [r for r in flight_recorder.records("serve")
            if r["event"] == "slo_breach" and r.get("deployment") == dep]
    assert recs and recs[-1]["ttft_ms"] > 5.0
    text = metrics.prometheus_text()
    assert "ray_tpu_serve_slo_breach_total" in text and "ray_tpu_serve_ttft_ms_bucket" in text
    anatomy.set_slo(dep, None)
    assert anatomy.serve_view()["deployments"][dep]["slo_ttft_ms"] is None


def test_breach_flight_events_rate_limited():
    dep = "stormdep"
    anatomy.set_slo(dep, 0.0)
    for _ in range(20):
        b = {}
        r = anatomy.admit(b, dep)
        time.sleep(0.001)
        anatomy.stamp(r, "decode_first_token", anatomy.now_wall())
        anatomy.complete(r, dep, ntokens=2)
    anatomy.serve_view()
    recs = [r for r in flight_recorder.records("serve")
            if r["event"] == "slo_breach" and r.get("deployment") == dep]
    assert len(recs) <= 2


class _StubRouter:
    def __init__(self, name, depths, nodes):
        self._name = name
        self._depths = depths
        self._replica_nodes = nodes

    def inflight_snapshot(self):
        return dict(self._depths)


@pytest.mark.parametrize("name", ["reference", "port"])
def test_predicted_ttft_from_router_depths(name):
    """Depth x service EWMA, the same in both modules; in one process the
    node I/O rollup is empty, so no pull-bytes term is added."""
    mod = MODULES[name][0]
    dep = f"preddep-{name}"
    b = {}
    r = mod.admit(b, dep)
    time.sleep(0.02)
    mod.stamp(r, "decode_first_token", mod.now_wall())
    mod.complete(r, dep, replica="r1", ntokens=2)
    mod.serve_view()
    stub = _StubRouter(dep, {"r1": 3, "r2": 0}, {"r1": None, "r2": None})
    mod.register_router(stub)
    pred = mod.serve_view()["deployments"][dep]["predicted_ttft_ms"]
    svc = mod.service_estimate(dep)
    assert pred["r1"] == pytest.approx(3 * svc * 1000.0) and pred["r2"] == 0.0
    assert mod.predicted_ttft_by_deployment()[dep] == pred["r1"]
    del stub  # a dead router drops out of the registry
    assert not any(t["deployment"] == dep for t, _ in mod._predicted_pairs())


def test_node_io_rollup_is_empty_in_one_process():
    """The estimator's pull-bytes term reads the per-node rollup the
    reference folds from pushed snapshots; one process has none."""
    assert metrics.node_io_rollup() == {"pull_rate": {}, "pull_total": {}, "inflight": {},
                                        "reactor_depth": {}, "holder_pending": {}}


def test_retire_replica_drops_scoreboard_entry():
    dep = "retdep"
    b = {}
    r = anatomy.admit(b, dep)
    anatomy.stamp(r, "decode_first_token", anatomy.now_wall())
    anatomy.complete(r, dep, replica="deadbeef", ntokens=2)
    assert "deadbeef" in anatomy.serve_view()["deployments"][dep]["replicas"]
    anatomy.retire_replica(dep, ["deadbeef"])
    assert "deadbeef" not in anatomy.serve_view()["deployments"][dep]["replicas"]


def test_trace_events_rows_and_flows():
    rid = _walk_all_phases(dep="tdep")
    events = anatomy.trace_events()
    xrows = [e for e in events if e.get("ph") == "X" and e["args"].get("rid") == rid]
    assert {e["name"] for e in xrows} == set(anatomy.PHASES)
    assert all(e["cat"] == "serve" and e["pid"] == 95 for e in xrows)
    flows = [e for e in events if e.get("ph") in ("s", "f")
             and str(e.get("id", "")).startswith(f"serve:{rid}")]
    assert len([e for e in flows if e["ph"] == "s"]) == 3
    assert len([e for e in flows if e["ph"] == "f"]) == 3


def test_remote_entries_fold_under_their_node():
    """ingest_remote and adopt keep the reference's signatures: a batch of
    another process's entries folds in (nothing in one process sends one)."""
    entries = [["sp", 1, "rx", "ingress_admit", 10.0, 10.0, {"dep": "remote"}],
               ["done", 2, "rx", "remote", "rep", 10.5, 3, True, None]]
    anatomy.ingest_remote("node9", "worker", entries)
    row = _row(anatomy.serve_view(), "rx")
    assert row["phases"]["ingress_admit"]["node"] == "node9" and row["done"]
    anatomy.adopt([["sp", 7, "ry", "prefill_exec", 1.0, 2.0, None], ["bogus"]])
    assert [e[2] for e in anatomy.local_events() if e[0] == "sp"] == ["ry"]


def test_kill_switch_disables_recording():
    code = (
        "from ray_tpu_torch.serve import anatomy\n"
        "assert not anatomy.enabled()\n"
        "body = {}\n"
        "assert anatomy.admit(body, 'd') is None\n"
        "assert '_anatomy' not in body\n"
        "anatomy.stamp('r', 'prefill_exec', 0.0)\n"
        "anatomy.kv_window('aa', 'kv_publish', 0.0, 1.0, 1)\n"
        "anatomy.complete('r', 'd')\n"
        "assert anatomy.local_events() == []\n"
        "print('KILLSWITCH_OK')\n"
    )
    env = dict(os.environ, RAY_TPU_SERVE_ANATOMY="0")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=50)
    assert "KILLSWITCH_OK" in out.stdout, out.stderr


# ------------------------------------------------- the hooks, over the port's serve
def _post(port: int, path: str, body: dict, stream: bool = False):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=15) as r:
        if stream:
            return [ln.decode().strip() for ln in r if ln.strip()]
        return json.loads(r.read())


def test_http_requests_leave_ordered_ledgers_and_a_scoreboard():
    """The proxy admits and completes, the router stamps its decision, the
    replica its dequeue and the deployment its first token: each ledger
    holds those phases in order, and the deployment's declared SLO scores
    them. A stream's first frame gives its first token."""
    rt.init(num_cpus=8, num_gpus=0)

    @serve.deployment(slo_ttft_ms=10_000.0, num_replicas=2)
    class Engine:
        def __call__(self, body):
            rid = anatomy.rid_of(body)
            t0 = anatomy.now_wall()
            time.sleep(0.005)
            anatomy.stamp(rid, "prefill_exec", t0, anatomy.now_wall())
            anatomy.stamp(rid, "decode_first_token", anatomy.now_wall())
            return {"token_ids": [1, 2, 3]}

        def stream_tokens(self, body):
            yield from (1, 2, 3)

    serve.run(Engine.bind(), route_prefix="/engine")
    port = serve.start_http_proxy(port=0).port
    for _ in range(4):
        assert _post(port, "/engine", {"prompt": "x"})["result"] == {"token_ids": [1, 2, 3]}
    frames = _post(port, "/engine", {"stream": True}, stream=True)
    assert frames[-1] == "data: [DONE]" and len(frames) == 4
    view = anatomy.serve_view()
    rows = [r for r in view["requests"] if r["deployment"] == "Engine"]
    assert len(rows) == 5 and all(r["done"] and r["ok"] for r in rows)
    order = ("ingress_admit", "router_decision", "replica_queue_wait", "prefill_exec",
             "decode_first_token", "stream_complete")
    for row in rows[:4]:
        assert [p for p in order if p in row["phases"]] == list(order), row["phases"]
        t0s = [row["phases"][p]["t0"] for p in order]
        assert all(b >= a for a, b in zip(t0s, t0s[1:])), row["phases"]
        assert row["ntokens"] == 3
        assert row["phases"]["router_decision"]["extra"]["dep"] == "Engine"
    assert rows[4]["ntokens"] == 3 and "decode_first_token" in rows[4]["phases"]
    board = view["deployments"]["Engine"]
    assert board["admitted"] == board["completed"] == 5
    assert board["slo_ttft_ms"] == 10_000.0 and board["goodput"] == 1.0
    # the HTTP handle's router is registered with the estimator
    keys = {r._actor_id.hex() for r in rt.get(
        rt.get_actor("_serve_controller").get_replicas.remote("Engine"), timeout=10)}
    assert set(board["predicted_ttft_ms"]) == keys
    bd = anatomy.phase_breakdown()
    assert bd["requests"] >= 5 and set(order) <= set(bd["phases"])


def test_removed_replicas_leave_the_scoreboard():
    """A replica the controller stops (scale-down, delete, a failed health
    check) is retired from the scoreboard at once."""
    rt.init(num_cpus=8, num_gpus=0)

    @serve.deployment(num_replicas=2)
    class Two:
        def __call__(self, body):
            return 1

    serve.run(Two.bind())
    controller = rt.get_actor("_serve_controller")
    keys = [r._actor_id.hex() for r in rt.get(controller.get_replicas.remote("Two"),
                                               timeout=10)]
    for key in keys:
        body = {}
        rid = anatomy.admit(body, "Two")
        anatomy.stamp(rid, "decode_first_token", anatomy.now_wall())
        anatomy.complete(rid, "Two", replica=key, ntokens=2)
    assert set(anatomy.serve_view()["deployments"]["Two"]["replicas"]) == set(keys)
    serve.run(Two.options(num_replicas=1).bind())  # a redeploy replaces both
    assert anatomy.serve_view()["deployments"]["Two"]["replicas"] == {}
    for key in [r._actor_id.hex() for r in rt.get(controller.get_replicas.remote("Two"),
                                                   timeout=10)]:
        body = {}
        rid = anatomy.admit(body, "Two")
        anatomy.stamp(rid, "decode_first_token", anatomy.now_wall())
        anatomy.complete(rid, "Two", replica=key, ntokens=1)
    assert len(anatomy.serve_view()["deployments"]["Two"]["replicas"]) == 1
    serve.delete("Two")
    assert anatomy.serve_view()["deployments"]["Two"]["replicas"] == {}


def test_attached_handoff_stamps_its_first_decoded_token():
    """A PD handoff that carries a ledger id (``_rid``) gets its
    decode_first_token stamp from the decode engine's first step that
    appends a token for it; a request done at attach (one token) gets none,
    as in the reference engine."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    conf = PagedLLMConfig(model_config=cfg, max_batch_size=2, max_seq_len=64, block_size=16)
    prefill = PagedLLMEngine(conf, params=params, device="cpu")
    decode = PagedLLMEngine(conf, params=params, device="cpu")
    try:
        stamped = {}
        for rid, max_new in (("attach-rid", 5), ("one-token", 1)):
            handoff = prefill.prefill_extract([5, 9, 13, 2, 7, 11])
            handoff["_rid"] = rid
            res = decode.attach_sequence(handoff, max_new).result(30)
            assert res.num_generated == max_new
            stamped[rid] = [e for e in anatomy.local_events()
                            if e[0] == "sp" and e[2] == rid and e[3] == "decode_first_token"]
        assert len(stamped["attach-rid"]) == 1 and stamped["one-token"] == []
        assert decode._anatomy_pending == {}
    finally:
        prefill.shutdown()
        decode.shutdown()
