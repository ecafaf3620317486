"""KV-cache-aware routing in the port (ray_tpu_torch.serve.kv_router)
against the reference (ray_tpu.serve.kv_router): ``_block_hashes`` and
``_select`` on the same seeded hints, stub replicas and in-flight tables;
the assertions of tests/test_kv_router.py; and a fleet of two
``PagedLLMEngine`` replicas (LlamaConfig.tiny(), the JAX init's float32
weights through ``from_jax``) behind ``request_router="kv_aware"``, an
``slo_ttft_ms`` and the HTTP proxy, whose answers are the JAX engine's
tokens and whose prefix families stay on one replica.

Every test runs under a deadline of its own (SIGALRM), binds port 0 and
fails on a leftover non-daemon thread."""

import json
import random
import signal
import threading
import time
import urllib.request
from collections import OrderedDict

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import llama as jl
from ray_tpu.serve import kv_router as ref_kv_router
from ray_tpu.serve.llm_paged import PagedLLMConfig as JaxPagedConfig
from ray_tpu.serve.llm_paged import PagedLLMEngine as JaxPagedEngine
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import anatomy, kv_router
from ray_tpu_torch.serve.deployment import REQUEST_ROUTERS
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

DEADLINE_S = 60
MODULES = {"reference": ref_kv_router, "port": kv_router}


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


class FakeReplica:
    def __init__(self, key):
        self._actor_id = type("I", (), {"hex": lambda self2, k=key: k})()


def _mk_router(mod, replica_nodes: dict, inflight: dict, *, io_view=None,
               bonus: float = 1.0, tolerance: int = 2, max_tracked: int = 100):
    """A bare KVAwareRouter of ``mod`` with injected replica, node and I/O
    state (no serve), as tests/test_kv_router.py builds one."""
    r = mod.KVAwareRouter.__new__(mod.KVAwareRouter)
    r.block_size = 16
    r.max_tracked_prefixes = max_tracked
    r.imbalance_tolerance = tolerance
    r.locality_bonus = bonus
    r._prefix_owner = OrderedDict()
    r._lock = threading.Lock()
    r._replicas = [FakeReplica(k) for k in replica_nodes]
    r._replica_nodes = dict(replica_nodes)
    r._inflight = dict(inflight)
    r._live_snapshot = frozenset()
    r._io_cache = (0.0, {})
    r._io_view_fn = io_view or (lambda: {"nodes": {}})
    return r


# ------------------------------------------------ the same hints, both routers
@pytest.mark.parametrize("seed", range(3))
def test_block_hashes_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 15, 16, 17, 31, 32, 33, 100, 256):
        ids = rng.integers(0, 128_256, n).tolist()
        for bs in (1, 4, 16):
            port = _mk_router(kv_router, {"a": "head"}, {"a": 0})
            ref = _mk_router(ref_kv_router, {"a": "head"}, {"a": 0})
            port.block_size = ref.block_size = bs
            assert port._block_hashes(ids) == ref._block_hashes(ids)
            assert len(port._block_hashes(ids)) == n // bs


@pytest.mark.parametrize("seed", range(4))
def test_select_matches_the_reference_over_a_seeded_hint_sequence(seed):
    """Prefix families with fresh suffixes, bare id lists, decode handoffs
    and no hint, over moving in-flight tables and a changing replica set:
    the same pick and the same prefix-owner LRU after every call."""
    rng = np.random.default_rng(seed)
    nodes = {"a": "n1", "b": "n2", "c": "n1", "d": "n3"}
    families = [rng.integers(0, 1000, int(rng.integers(16, 80))).tolist() for _ in range(5)]
    views = [{"nodes": {}}, {"nodes": {"n2": {"pending_pull_bytes": 64 << 20,
                                              "holder_pending_bytes": {}}}}]
    routers = {name: _mk_router(mod, nodes, {k: 0 for k in nodes}, max_tracked=24,
                                io_view=lambda v=views[seed % 2]: v, tolerance=2)
               for name, mod in MODULES.items()}
    for step in range(200):
        inflight = {k: int(rng.integers(0, 6)) for k in nodes}
        live = [k for k in nodes if rng.random() < 0.85] or ["a"]
        if len(live) < 2:
            live = ["a", "b"]
        kind = rng.choice(["family", "family", "family", "bare", "decode", "none"])
        if kind == "family":
            fam = families[int(rng.integers(0, len(families)))]
            hint = ("prefix", fam + rng.integers(0, 1000, int(rng.integers(0, 40))).tolist())
        elif kind == "bare":
            hint = families[int(rng.integers(0, len(families)))][:32]
        elif kind == "decode":
            hint = ("decode", {"node": str(rng.choice(["n1", "n2", "n3", "n9"]))})
        else:
            hint = None
        picks, owners = {}, {}
        for name, r in routers.items():
            r._inflight = dict(inflight)
            r._replicas = [FakeReplica(k) for k in live]
            with r._lock:
                r._prune_stale_owners(frozenset(live))
                random.seed(seed * 1000 + step)
                picks[name] = r._rkey(r._select(hint))
            owners[name] = list(r._prefix_owner.items())
        assert picks["port"] == picks["reference"], (step, kind)
        assert owners["port"] == owners["reference"], step


# ------------------------------------------- tests/test_kv_router.py, ported
def test_affinity_holds_while_balanced_and_yields_under_imbalance():
    random.seed(0)
    r = _mk_router(kv_router, {"a": "head", "b": "head"}, {"a": 0, "b": 0})
    prompt = list(range(32))
    key = r._rkey(r._select(prompt))
    assert r._rkey(r._select(prompt)) == key
    r._inflight[key] = 10
    assert r._rkey(r._select(prompt)) == ("b" if key == "a" else "a")


def test_affinity_boundary_exactly_at_tolerance():
    r = _mk_router(kv_router, {"a": "n1", "b": "n2"}, {"a": 0, "b": 0}, tolerance=2)
    prompt = list(range(32))
    key = r._rkey(r._select(("prefix", prompt)))
    other = "b" if key == "a" else "a"
    r._inflight[key] = 2
    assert r._rkey(r._select(("prefix", prompt))) == key
    r._inflight[key] = 3
    assert r._rkey(r._select(("prefix", prompt))) == other


def test_decode_placement_locality_and_load():
    r = _mk_router(kv_router, {"a": "n1", "b": "n2"}, {"a": 0, "b": 0})
    for _ in range(8):
        assert r._rkey(r._select(("decode", {"node": "n2", "nbytes": 1}))) == "b"
    r = _mk_router(kv_router, {"a": "n1", "b": "n2"}, {"a": 0, "b": 2}, bonus=1.0)
    assert r._rkey(r._select(("decode", {"node": "n2"}))) == "a"


def test_decode_placement_folds_io_pressure_when_a_view_has_it():
    view = {"nodes": {"n2": {"pending_pull_bytes": 64 << 20, "holder_pending_bytes": {}},
                      "n1": {"pending_pull_bytes": 0, "holder_pending_bytes": {}}}}
    r = _mk_router(kv_router, {"a": "n1", "b": "n2"}, {"a": 0, "b": 0},
                   io_view=lambda: view, bonus=1.0)
    assert r._rkey(r._select(("decode", {"node": "n2"}))) == "a"


def test_io_view_and_node_map_are_empty_in_one_process():
    """The pressure term and the node map have nothing to read in one
    process: the default I/O view names no node, and every replica is on
    "head", so decode placement is the in-flight depth less the bonus."""
    assert kv_router._default_io_view() == {"nodes": {}}
    r = _mk_router(kv_router, {"a": "head", "b": "head"}, {"a": 1, "b": 0})
    r._io_view_fn = kv_router._default_io_view
    assert r._io_pressure() == {}
    assert r._rkey(r._select(("decode", {"node": "head"}))) == "b"


def test_hint_extraction_and_anatomy_route_tag():
    r = _mk_router(kv_router, {"a": "n1"}, {"a": 0})
    assert r._routing_hint("decode", ({"handoff": {"kv_ref": {"node": "n9"}}},), {}) == (
        "decode", {"node": "n9"})
    body = {"prompt_ids": [1, 2, 3], "_anatomy": {"rid": "x"}}
    assert r._routing_hint("__call__", (body,), {}) == ("prefix", [1, 2, 3])
    assert body["_anatomy"]["route"] == "prefix"
    assert r._routing_hint("__call__", ({"prompt": "text"},), {}) is None


def test_prefix_owners_pruned_when_replica_removed():
    r = _mk_router(kv_router, {"a": "n1", "b": "n2"}, {"a": 0, "b": 0})
    r._claim(r._block_hashes(list(range(32))), "a")
    r._claim(r._block_hashes(list(range(100, 132))), "dead")
    assert len(r._prefix_owner) == 4
    r._prune_stale_owners(frozenset({"a", "b"}))
    assert len(r._prefix_owner) == 2 and set(r._prefix_owner.values()) == {"a"}
    r._claim(r._block_hashes(list(range(200, 232))), "ghost")
    r._prune_stale_owners(frozenset({"a", "b"}))  # unchanged set: no-op
    assert "ghost" in set(r._prefix_owner.values())


def test_unknown_router_rejected():
    with pytest.raises(ValueError, match="unknown request_router"):
        kv_router.make_router("nope", None, "d")
    assert set(kv_router.ROUTER_CLASSES) == set(REQUEST_ROUTERS)


# ------------------------------------------------- over the port's serve
def _echo_deployment(**opts):
    @serve.deployment(name="Echo", num_replicas=2, **opts)
    class Echo:
        def __init__(self):
            self.tag = f"{id(self)}"

        def __call__(self, body):
            return {"replica": self.tag, "n": len(body.get("prompt_ids", []))}

    return Echo


def test_shared_prefix_sticks_and_distinct_prefixes_spread():
    rt.init(num_cpus=8, num_gpus=0)
    handle = serve.run(_echo_deployment(request_router="kv_aware").bind())
    sys_prompt = list(range(64))
    replicas = {rt.get(handle.remote({"prompt_ids": sys_prompt + [100 + i]}),
                       timeout=10)["replica"] for i in range(8)}
    assert len(replicas) == 1
    random.seed(1)
    spread = {rt.get(handle.remote({"prompt_ids": [1000 + i] * 32}), timeout=10)["replica"]
              for i in range(12)}
    assert len(spread) == 2


def test_pow2_default_and_redeploy_swaps_router_policy():
    rt.init(num_cpus=8, num_gpus=0)
    Echo = _echo_deployment()
    handle = serve.run(Echo.bind())
    assert type(handle._current_router()).KIND == "pow2"
    assert rt.get(handle.remote({"prompt_ids": [1, 2, 3]}), timeout=10)["n"] == 3
    serve.run(Echo.options(request_router="kv_aware").bind())
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        handle._router._last_refresh = 0.0  # force the periodic re-check
        rt.get(handle.remote({"prompt_ids": [1, 2]}), timeout=10)
        if isinstance(handle._current_router(), kv_router.KVAwareRouter):
            break
        time.sleep(0.1)
    assert isinstance(handle._current_router(), kv_router.KVAwareRouter)


# -------------------------- two tiny Llama replicas: the JAX engine's tokens
BLOCK, NEW_TOKENS = 16, 6


@serve.deployment(name="PagedFleet", num_replicas=2, request_router="kv_aware",
                  slo_ttft_ms=30_000.0, max_ongoing_requests=16)
class PagedFleet:
    """One PagedLLMEngine per replica; the body is what the KV-aware hint
    reads. The answer names the replica and its prefix-hit blocks."""

    def __init__(self, config, params):
        import uuid

        self.key = uuid.uuid4().hex[:8]
        self.engine = PagedLLMEngine(config, params=params, device="cpu")

    def __del__(self):
        if getattr(self, "engine", None) is not None:
            self.engine.shutdown()

    def __call__(self, body):
        rid = anatomy.rid_of(body)
        ids = []
        for tok in self.engine.generate_stream(body["prompt_ids"], body["max_tokens"]):
            if not ids and rid is not None:
                anatomy.stamp(rid, "decode_first_token", anatomy.now_wall())
            ids.append(int(tok))
        return {"token_ids": ids, "replica": self.key,
                "prefix_hit_blocks": self.engine.allocator.stats()["prefix_hit_blocks"]}


def test_two_tiny_llama_replicas_over_http_give_the_jax_engine_tokens():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(11))
    tcfg = tl.LlamaConfig.tiny()
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(3, 256, 2 * BLOCK).tolist() for _ in range(2)]
    # two families of three, sent in pairs: one of each family at a time
    order = []
    for i in range(3):
        for f in range(2):
            order.append((f, prefixes[f] + rng.integers(3, 256, int(5 + 3 * i + f)).tolist()))
    jeng = JaxPagedEngine(JaxPagedConfig(model_config=jcfg, max_batch_size=4, max_seq_len=128,
                                         block_size=BLOCK), params=jparams)
    try:
        want = [jeng.generate_sync(p, NEW_TOKENS).token_ids for _, p in order]
    finally:
        jeng.shutdown()

    rt.init(num_cpus=8, num_gpus=0)
    conf = PagedLLMConfig(model_config=tcfg, max_batch_size=4, max_seq_len=128,
                          block_size=BLOCK)
    serve.run(PagedFleet.bind(conf, tparams), route_prefix="/fleet")
    port = serve.start_http_proxy(port=0).port
    results: list = [None] * len(order)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/fleet",
            data=json.dumps({"prompt_ids": order[i][1], "max_tokens": NEW_TOKENS}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=40) as r:
            results[i] = json.loads(r.read())["result"]

    for pair in range(3):
        threads = [threading.Thread(target=post, args=(2 * pair + f,)) for f in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
    assert [r["token_ids"] for r in results] == want
    by_family = {f: [r for (fam, _), r in zip(order, results) if fam == f] for f in range(2)}
    for f, rows in by_family.items():
        assert len({r["replica"] for r in rows}) == 1, (f, rows)
    # each family's second and third members found its 2 prefix blocks on
    # the family's replica
    for replica in {r["replica"] for r in results}:
        families = [f for f, rows in by_family.items() if rows[0]["replica"] == replica]
        assert max(r["prefix_hit_blocks"] for r in results if r["replica"] == replica) == (
            2 * 2 * len(families))
    view = anatomy.serve_view()["deployments"]["PagedFleet"]
    assert view["admitted"] == view["completed"] == 6 and view["slo_ok"] == 6
