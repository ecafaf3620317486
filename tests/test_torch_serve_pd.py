"""Port parity of the PD deployments and DP attention (ray_tpu_torch.serve.pd,
ray_tpu_torch.serve.dp_attention): the ports of tests/test_serve_pd.py's
test_pd_deployment_matches_single_engine,
test_pd_disaggregated_app_matches_single_engine and
test_dp_attention_gang_lockstep, with torch engines on the CPU on the JAX
init's weights (converted by from_jax) giving the JAX PagedLLMEngine's
greedy tokens exactly (float32 on both sides).

Every test runs under a deadline of its own (SIGALRM: a hang fails that
test); teardown shuts serve and the runtime down and checks that no
non-daemon thread is left. Nothing binds a port: requests go through
deployment handles.
"""

import signal
import threading

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.models import llama as jl
from ray_tpu.serve.llm_paged import PagedLLMConfig as JaxPagedConfig
from ray_tpu.serve.llm_paged import PagedLLMEngine as JaxPagedEngine
from ray_tpu_torch import serve
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import pd
from ray_tpu_torch.serve.dp_attention import DPAttentionGroup
from ray_tpu_torch.exceptions import TaskError
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig

DEADLINE_S = 60
PROMPT = list(range(3, 40))
DP_FIRST = [1, 2, 3, 4]
DP_BURST = [[1 + i, 2, 3] for i in range(4)]


@pytest.fixture(autouse=True)
def _guard():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    before = set(threading.enumerate())
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        rt.init(num_cpus=8, num_gpus=0)
        yield
    finally:
        try:
            serve.shutdown()
            rt.shutdown()
            left = [t for t in threading.enumerate()
                    if t not in before and t.is_alive() and not t.daemon]
            assert not left, left
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


def _jax_tokens(jcfg, jparams, requests, **config):
    """The JAX single engine's greedy tokens for each (prompt, max_new)."""
    eng = JaxPagedEngine(JaxPagedConfig(model_config=jcfg, **config), params=jparams)
    try:
        futs = [eng.generate(p, n) for p, n in requests]
        return [f.result(120).token_ids for f in futs]
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def weights():
    """The reference tests' weights (the JAX init at PRNGKey(0)), converted,
    and the JAX engine's tokens for the PD prompt and the DP requests."""
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(0))
    tcfg = tl.LlamaConfig.tiny()
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    pd_tokens = _jax_tokens(jcfg, jparams, [(PROMPT, 8)], max_batch_size=4, max_seq_len=128,
                            block_size=16)[0]
    dp_tokens = _jax_tokens(jcfg, jparams, [(DP_FIRST, 5)] + [(p, 4) for p in DP_BURST],
                            max_batch_size=2, max_seq_len=64, block_size=16)
    return tcfg, tparams, pd_tokens, dp_tokens


def _pd_config(tcfg):
    return PagedLLMConfig(model_config=tcfg, max_batch_size=4, max_seq_len=128, block_size=16)


def test_pd_deployment_matches_single_engine(weights):
    tcfg, tparams, expect, _ = weights
    handle = serve.run(pd.build_pd_deployment(_pd_config(tcfg), params=tparams, device="cpu"),
                       route_prefix="/pd")
    out = rt.get(handle.remote({"prompt_ids": PROMPT, "max_tokens": 8}), timeout=30)
    assert out["disaggregated"] is False  # the co-located shape
    assert out["usage"]["completion_tokens"] == 8
    assert out["token_ids"] == expect
    stats = rt.get(handle.stats.remote(), timeout=30)
    assert stats["prefill"]["allocated_blocks"] == 0  # extracted pages freed
    assert stats["decode"]["decode_steps"] > 0


def test_pd_disaggregated_app_matches_single_engine(weights):
    """Separate prefill and decode deployments joined by the PDController,
    the KV pages riding the handle as host tensors: the JAX engine's tokens
    from two replicas, and no handoff left live on either side."""
    tcfg, tparams, expect, _ = weights
    handle = pd.deploy_pd_app(_pd_config(tcfg), route_prefix="/pd_dis", params=tparams,
                              device="cpu")
    out = rt.get(handle.remote({"prompt_ids": PROMPT, "max_tokens": 8}), timeout=30)
    assert out["disaggregated"] is True
    assert out["usage"]["completion_tokens"] == 8
    assert out["pd"]["prefill_replica"] != out["pd"]["decode_replica"]
    assert out["token_ids"] == expect
    stats = rt.get(handle.stats.remote(), timeout=30)
    assert stats["prefill"]["kv"]["live_handoffs"] == 0
    assert stats["decode"]["kv"]["live_handoffs"] == 0
    assert stats["decode"]["decode_steps"] > 0


def test_live_handoffs_count_what_is_in_flight():
    """The count behind ``live_handoffs``: a handoff is live from its
    extraction (or receipt) until it is closed, once attached or dropped;
    closing twice is a no-op."""
    live = pd._Handoffs()
    a, b = live.open(), live.open()
    assert len(live) == 2
    live.close(a)  # attached
    live.close(a)  # and closed again by the request's end
    assert len(live) == 1
    live.close(b)  # dropped
    assert len(live) == 0


def test_unported_transports_and_placement_raise_naming_their_items(weights):
    """What waits for later items raises instead of pretending: a handoff
    with no host pages (the object-plane transport and its lost-handoff
    re-prefill) and DP attention's placement group."""
    tcfg, tparams, _, _ = weights
    serve.run(pd.build_decode_deployment(_pd_config(tcfg), params=tparams, device="cpu"),
              route_prefix=None)
    decode = serve.get_deployment_handle("PDDecode")
    plane = {"kv_ref": {"oid": b"x"}, "first_token": 1, "prompt_len": 3}
    with pytest.raises(TaskError, match="NotImplementedError: .*queue 1 item 8"):
        rt.get(decode.decode.remote({"handoff": plane, "max_tokens": 2}), timeout=30)
    assert rt.get(decode.stats.remote(), timeout=30)["kv"]["live_handoffs"] == 0
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        DPAttentionGroup(PagedLLMConfig(model_config=tcfg), dp_size=2, device="cpu")


def test_dp_attention_gang_lockstep(weights):
    """DP-attention ranks step in lockstep; an idle rank keeps cadence with
    dummy decodes; a fully idle group only probes; requests route to the
    least-loaded rank and give the JAX engine's tokens."""
    tcfg, tparams, _, expect = weights
    cfg = PagedLLMConfig(model_config=tcfg, max_batch_size=2, max_seq_len=64, block_size=16,
                         temperature=0.0)
    group = DPAttentionGroup(cfg, dp_size=2, use_placement_group=False, params=tparams,
                             device="cpu")
    try:
        # one request: only one rank has work, the other must dummy-step.
        # The round that prefills also decodes, so 5 tokens take 4 decode
        # steps: one lockstep round each, the idle rank dummy-decoding in
        # every one of them
        out = group.generate(DP_FIRST, max_new_tokens=5, timeout=30)
        assert out["token_ids"] == expect[0] and out["prompt_len"] == 4
        idle_rank, busy_rank = sorted(group.stats(), key=lambda s: s["decode_steps"])
        assert idle_rank["decode_steps"] == 0 and busy_rank["decode_steps"] == 4
        assert group.rounds >= busy_rank["decode_steps"]
        assert idle_rank["dummy_decodes"] >= busy_rank["decode_steps"]
        # a fully idle group stops stepping and only probes
        assert group.wait_for(lambda g: g.idle, timeout=20)
        r0, p0 = group.rounds, group.probes
        assert group.wait_for(lambda g: g.probes >= p0 + 5, timeout=20)
        assert group.rounds == r0

        # concurrent requests spread across ranks and all complete
        results, errs = [None] * len(DP_BURST), []

        def one(i):
            try:
                results[i] = group.generate(DP_BURST[i], max_new_tokens=4, timeout=30)
            except Exception as e:  # noqa: BLE001 - reported below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(DP_BURST))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
        assert not errs and all(r is not None for r in results), errs
        assert [r["token_ids"] for r in results] == expect[1:]
    finally:
        group.shutdown()
