"""The port's front door (ray_tpu_torch.serve.front_door) and the
controller's routing epochs, against the reference (ray_tpu.serve.
front_door, tests/test_front_door.py):

- ``EpochCache``: the same stream of epoch docs (stale, junk, out of order)
  through the reference's cache and the port's gives the same ``update``
  results, versions, rejections and docs, and ``wait_newer`` agrees;
- the controller publishes versioned epochs on a retained channel at
  deploy, delete, ingress (un)registration and a health drop, versions only
  rise, and ``force=False`` publishes nothing while the fingerprint holds
  (tests/test_front_door.py:228, without drain_node);
- the epoch-fed handle and an ingress's HTTP request path make zero
  controller calls (``ServeController.call_counts``; :307);
- ``IngressActor._predict`` gives the reference's numbers on the same epoch
  doc and in-flight depths;
- two ``LlamaConfig.tiny()`` paged replicas behind ``start_front_door``
  give the JAX PagedLLMEngine's greedy tokens on ``from_jax`` weights, and
  a burst over the epoch's ``slo_ttft_ms`` is shed with 503.

Every test runs under a deadline of its own (SIGALRM), binds port 0 and
fails on a leftover non-daemon thread."""

import json
import signal
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import llama as jl
from ray_tpu.serve import front_door as ref_front_door
from ray_tpu.serve.llm_paged import PagedLLMConfig as JaxPagedConfig
from ray_tpu.serve.llm_paged import PagedLLMEngine as JaxPagedEngine
from ray_tpu_torch import serve
from ray_tpu_torch.experimental import pubsub
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import anatomy, front_door
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            anatomy.clear()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _post(addr, path: str, body: dict, timeout: float = 30) -> tuple:
    req = urllib.request.Request(f"http://{addr[0]}:{addr[1]}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------------- epoch cache
EPOCH_STREAM = ["junk", None, {"version": "zebra"}, {"version": 3, "routes": {"/a": "A"}},
                {"version": 2, "routes": {}}, {"version": 3, "routes": {}}, [1, 2],
                {"version": 4, "routes": {}, "future_field": 1}, {"routes": {"/b": "B"}},
                {"version": 7, "routes": {"/c": "C"}}, {"version": 5}, {"version": None},
                {"version": 8.9}, {"version": "9", "routes": {"/d": "D"}}]


def _feed(cache_cls) -> list:
    c = cache_cls()
    return [(c.update(doc), c.version, c.rejected, c.get()) for doc in EPOCH_STREAM]


def test_epoch_cache_matches_the_reference():
    ref, port = _feed(ref_front_door.EpochCache), _feed(front_door.EpochCache)
    assert port == ref
    assert port[-1][1] == 9 and port[-1][3]["routes"] == {"/d": "D"}


@pytest.mark.parametrize("module", [ref_front_door, front_door], ids=["reference", "port"])
def test_epoch_cache_wait_newer(module):
    c = module.EpochCache()
    c.update({"version": 1})
    got = []
    t = threading.Thread(target=lambda: got.append(c.wait_newer(1, timeout=5.0)))
    t.start()
    c.update({"version": 2})
    t.join(timeout=10)
    assert got == [True]
    assert c.wait_newer(2, timeout=0.05) is False


# ---------------------------------------------------- controller epochs
@serve.deployment(name="EpochDep", num_replicas=1)
class EpochDep:
    def __call__(self, body):
        return {"ok": True}


def _next_doc(sub, pred, timeout=10.0):
    """The next published epoch that satisfies ``pred``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        doc = sub.poll(timeout=0.5)
        if doc is not None and pred(doc):
            return doc
    raise AssertionError("no such epoch was published")


def test_controller_publishes_versioned_epochs():
    rt.init(num_cpus=8, num_gpus=0)
    ctrl = ServeController()
    ctrl.EPOCH_REFRESH_S = 1e9  # no heartbeat republish inside the test
    sub = None
    try:
        ctrl.deploy(EpochDep.options(health_check_period_s=0.1).bind().deployment, "/epoch")
        sub = pubsub.subscribe(ctrl.EPOCH_CHANNEL)
        doc = sub.poll(timeout=10)  # the retained epoch, with no new publish
        assert doc is not None and doc["routes"] == {"/epoch": "EpochDep"}
        ent = doc["deployments"]["EpochDep"]
        assert len(ent["replicas"]) == 1 and set(ent["nodes"].values()) == {"head"}
        assert ent["router"] == "pow2" and ent["compiled"] is False
        assert doc["draining"] == [] and doc["ingress"] == {}
        versions = [doc["version"]]

        ctrl.set_ingress("nodeA", "127.0.0.1", 9999)
        doc = _next_doc(sub, lambda d: "nodeA" in d["ingress"])
        assert doc["ingress"]["nodeA"] == ["127.0.0.1", 9999]
        versions.append(doc["version"])
        assert ctrl.get_ingress() == {"nodeA": ["127.0.0.1", 9999]}

        ctrl._publish_epoch(force=False)  # the fingerprint holds: nothing goes out
        assert sub.poll(timeout=0.3) is None

        # the health loop drops a killed replica and publishes at once
        dead_key = ent["replicas"][0]._actor_id.hex()
        rt.kill(ent["replicas"][0])
        doc = _next_doc(sub, lambda d: dead_key not in d["deployments"]["EpochDep"]["nodes"])
        versions.append(doc["version"])
        doc = _next_doc(sub, lambda d: len(d["deployments"]["EpochDep"]["replicas"]) == 1)
        versions.append(doc["version"])  # the replacement, from the reconcile loop

        ctrl.remove_ingress("nodeA")
        doc = _next_doc(sub, lambda d: d["ingress"] == {})
        versions.append(doc["version"])
        ctrl.remove_ingress("nodeA")  # not registered: nothing goes out
        assert sub.poll(timeout=0.3) is None

        ctrl.delete_deployment("EpochDep")
        doc = _next_doc(sub, lambda d: "EpochDep" not in d["deployments"])
        assert doc["routes"] == {}
        versions.append(doc["version"])
        assert versions == sorted(set(versions)), versions
        assert ctrl.get_epoch()["version"] == versions[-1]
    finally:
        if sub is not None:
            sub.close()
        ctrl.shutdown()


# -------------------------------------------- zero controller calls
@serve.deployment(name="FastDep", num_replicas=2)
class FastDep:
    def __call__(self, body):
        return {"echo": body["x"]}


def _request_calls(controller, fn) -> dict:
    """The controller's public-method calls made while ``fn`` ran."""
    before = rt.get(controller.call_counts.remote(), timeout=10)
    fn()
    after = rt.get(controller.call_counts.remote(), timeout=10)
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


def test_epoch_handle_dispatch_makes_zero_controller_calls():
    rt.init(num_cpus=8, num_gpus=0)
    serve.run(FastDep.bind(), route_prefix="/fast")
    controller = rt.get_actor(CONTROLLER_NAME)
    cache = front_door.EpochCache()
    sub = pubsub.subscribe(ServeController.EPOCH_CHANNEL)
    try:
        assert cache.update(sub.poll(timeout=10))  # the retained epoch
        h = front_door._EpochHandle(controller, "FastDep", cache)
        assert isinstance(h._router, front_door.EpochRouter)
        for i in range(4):
            assert rt.get(h.remote({"x": i}), timeout=30)["echo"] == i

        def traffic():
            for i in range(20):
                assert rt.get(h.remote({"x": i}), timeout=30)["echo"] == i

        assert _request_calls(controller, traffic) == {}
        assert len(h._router._replicas) == 2
    finally:
        sub.close()


def test_front_door_ingress_serves_with_zero_controller_calls():
    """start_front_door places one ingress (one node), registered in the
    epoch's ingress map; 20 POSTs through it make no controller call; an
    unknown route is 404; stop_front_door frees its port."""
    rt.init(num_cpus=8, num_gpus=0)
    serve.run(FastDep.bind(), route_prefix="/fast")
    (addr,) = serve.start_front_door()
    assert serve.start_front_door() == [addr]  # idempotent
    controller = rt.get_actor(CONTROLLER_NAME)
    epoch = rt.get(controller.get_epoch.remote(), timeout=10)
    assert epoch["ingress"] == {"head": list(addr)}
    assert _post(addr, "/fast", {"x": -1}) == (200, {"result": {"echo": -1}})

    def traffic():
        for i in range(20):
            assert _post(addr, "/fast", {"x": i}) == (200, {"result": {"echo": i}})

    assert _request_calls(controller, traffic) == {}
    assert _post(addr, "/nope", {})[0] == 404
    view = serve.front_door_view()
    assert view["running"] and view["ingress"]["head"]["addr"] == list(addr)
    assert view["shed_counts"]["head"] == {}
    (actor,) = front_door._fd_state["front_door"].ingress_actors().values()
    stats = rt.get(actor.router_stats.remote(), timeout=10)["FastDep"]
    assert stats["router"] == "epoch" and stats["replicas"] == 2
    assert stats["epoch_version"] == epoch["version"]
    serve.stop_front_door()
    assert serve.front_door_addresses() == []
    assert rt.get(controller.get_ingress.remote(), timeout=10) == {}
    with socket.socket() as s:  # no one listens on the port: a new server can bind it
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(addr)


def test_front_door_with_a_fixed_count_and_the_slo_autoscaler():
    """``count=2`` places two ingresses, each registered and each serving;
    ``autoscale=True`` starts the SLO autoscaler, which the view shows and
    stop_front_door stops."""
    rt.init(num_cpus=8, num_gpus=0)
    serve.run(FastDep.bind(), route_prefix="/fast")
    addrs = serve.start_front_door(count=2, autoscale=True)
    assert len(set(addrs)) == 2 and serve.front_door_addresses() == addrs
    controller = rt.get_actor(CONTROLLER_NAME)
    ingress = rt.get(controller.get_ingress.remote(), timeout=10)
    assert sorted(ingress) == ["ingress-0", "ingress-1"]
    assert sorted(map(tuple, ingress.values())) == sorted(addrs)
    for i, addr in enumerate(addrs):
        assert _post(addr, "/fast", {"x": i}) == (200, {"result": {"echo": i}})
    view = serve.front_door_view()
    assert set(view["ingress"]) == {"ingress-0", "ingress-1"} and "autoscaler" in view
    serve.stop_front_door()
    assert serve.front_door_view() == {"running": False}


def test_runtime_shut_down_under_the_front_door_stops_its_ingress():
    """The ingress's epoch loop sees the runtime shut down and stops its
    server; stop_front_door afterwards has nothing left to do."""
    rt.init(num_cpus=8, num_gpus=0)
    serve.run(FastDep.bind(), route_prefix="/fast")
    (addr,) = serve.start_front_door()
    assert _post(addr, "/fast", {"x": 1}) == (200, {"result": {"echo": 1}})
    rt.shutdown()
    deadline = time.monotonic() + 10
    while True:
        with socket.socket() as s:
            if s.connect_ex(addr) != 0:
                break  # nothing listens any more
        assert time.monotonic() < deadline, "the ingress still listens"
        time.sleep(0.05)
    serve.stop_front_door()
    assert serve.front_door_addresses() == []


# ------------------------------------------------------------- _predict
PREDICT_CASES = [
    ({"deployments": {"D": {"slo_ttft_ms": None}}}, {"a": 3}),
    ({"deployments": {"D": {"slo_ttft_ms": 100.0, "service_ewma_s": 0.2}}}, None),
    ({"deployments": {"D": {"slo_ttft_ms": 100.0, "service_ewma_s": 0.2}}}, {}),
    ({"deployments": {"D": {"slo_ttft_ms": 100.0, "service_ewma_s": 0.2}}}, {"a": 3, "b": 1}),
    ({"deployments": {"D": {"slo_ttft_ms": 250.0}}}, {"a": 2}),
    ({"deployments": {"D": {"slo_ttft_ms": 5.0, "service_ewma_s": None}}}, {"a": 0, "b": 0}),
    ({"deployments": {}}, {"a": 1}),
]


def _predict(module, doc, depths):
    """``module``'s IngressActor._predict on an ingress holding ``doc`` and,
    unless ``depths`` is None, a handle whose router has those depths."""
    ing = object.__new__(module.IngressActor)
    ing._cache = module.EpochCache()
    ing._cache.update({"version": 1, **doc})
    router = SimpleNamespace(inflight_snapshot=lambda: dict(depths))
    ing._handles = {} if depths is None else {"D": SimpleNamespace(_router=router)}
    return ing._predict("D")


@pytest.mark.parametrize("doc, depths", PREDICT_CASES)
def test_predict_matches_the_reference(doc, depths):
    assert _predict(front_door, doc, depths) == _predict(ref_front_door, doc, depths)


# ------------------- two tiny Llama replicas behind the front door
BLOCK, NEW_TOKENS = 16, 6


@serve.deployment(name="DoorFleet", num_replicas=2, request_router="kv_aware",
                  slo_ttft_ms=30_000.0, max_ongoing_requests=16)
class DoorFleet:
    """One PagedLLMEngine per replica; the body is what the KV-aware hint
    reads. The answer names the replica."""

    def __init__(self, config, params):
        import uuid

        self.key = uuid.uuid4().hex[:8]
        self.engine = PagedLLMEngine(config, params=params, device="cpu")

    def __del__(self):
        if getattr(self, "engine", None) is not None:
            self.engine.shutdown()

    def __call__(self, body):
        ids = [int(t) for t in self.engine.generate_stream(body["prompt_ids"],
                                                           body["max_tokens"])]
        return {"token_ids": ids, "replica": self.key}


def test_tiny_paged_app_behind_the_front_door(monkeypatch):
    monkeypatch.setenv("RAY_TPU_SERVE_QUEUE_BUDGET", "0")  # a breach sheds at once
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(13))
    tcfg = tl.LlamaConfig.tiny()
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    rng = np.random.default_rng(6)
    prefix = rng.integers(3, 256, 2 * BLOCK).tolist()
    prompts = [prefix + rng.integers(3, 256, 4 + 3 * i).tolist() for i in range(4)]
    jeng = JaxPagedEngine(JaxPagedConfig(model_config=jcfg, max_batch_size=4, max_seq_len=128,
                                         block_size=BLOCK), params=jparams)
    try:
        want = [jeng.generate_sync(p, NEW_TOKENS).token_ids for p in prompts]
    finally:
        jeng.shutdown()

    rt.init(num_cpus=8, num_gpus=0)
    conf = PagedLLMConfig(model_config=tcfg, max_batch_size=4, max_seq_len=128,
                          block_size=BLOCK)
    serve.run(DoorFleet.bind(conf, tparams), route_prefix="/fleet")
    (addr,) = serve.start_front_door()
    got = [_post(addr, "/fleet", {"prompt_ids": p, "max_tokens": NEW_TOKENS}) for p in prompts]
    assert all(code == 200 for code, _ in got), got
    assert [out["result"]["token_ids"] for _, out in got] == want
    assert len({out["result"]["replica"] for _, out in got}) == 1  # one family, one replica

    # redeploy with an SLO below any prediction: the new epoch carries it and
    # the ingress's gate sheds a burst before admission
    controller = rt.get_actor(CONTROLLER_NAME)
    v0 = rt.get(controller.get_epoch.remote(), timeout=10)["version"]
    serve.run(DoorFleet.options(slo_ttft_ms=1.0).bind(conf, tparams), route_prefix="/fleet")
    (actor,) = front_door._fd_state["front_door"].ingress_actors().values()
    deadline = time.monotonic() + 10
    while rt.get(actor.epoch.remote(), timeout=10)["deployments"]["DoorFleet"][
            "slo_ttft_ms"] != 1.0:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert rt.get(actor.epoch_version.remote(), timeout=10) > v0
    admitted = anatomy.serve_view()["deployments"]["DoorFleet"]["admitted"]
    burst: list = [None] * 4

    def send(i):
        burst[i] = _post(addr, "/fleet", {"prompt_ids": prompts[i], "max_tokens": NEW_TOKENS})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert [code for code, _ in burst] == [503] * 4, burst
    assert all(out["error"] == "shed" and out["deployment"] == "DoorFleet" for _, out in burst)
    assert serve.front_door_view()["shed_counts"]["head"] == {"DoorFleet:predicted_ttft": 4}
    assert anatomy.serve_view()["deployments"]["DoorFleet"]["admitted"] == admitted
