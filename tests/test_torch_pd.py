"""Port parity of the prefill/decode (PD) handoff: ray_tpu_torch's
PagedLLMEngine.prefill_extract / attach_sequence on the CPU against the JAX
PagedLLMEngine, on the JAX init's weights converted by from_jax. Greedy
decoding must give the JAX single engine's tokens, token for token, for a
handoff between two torch engines and across the two frameworks both ways.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve.llm_paged import PagedLLMConfig as JaxPagedConfig
from ray_tpu.serve.llm_paged import PagedLLMEngine as JaxPagedEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

PROMPTS = [list(range(2, 30)), [5, 9, 13, 2, 7], list(range(1, 40))]
NEW = 10


@pytest.fixture(scope="module")
def shared():
    """Weights from the JAX init, and the JAX single engine's tokens."""
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(7))
    tcfg = tl.LlamaConfig.tiny()
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jeng = _jax_engine(jcfg, jparams)
    try:
        futs = [jeng.generate(p, NEW) for p in PROMPTS]
        expect = [f.result(120).token_ids for f in futs]
    finally:
        jeng.shutdown()
    return jcfg, jparams, tcfg, tparams, expect


def _jax_engine(jcfg, jparams):
    return JaxPagedEngine(JaxPagedConfig(model_config=jcfg, max_batch_size=4,
                                         max_seq_len=128, block_size=16), params=jparams)


def _engine(tcfg, tparams, **kw):
    cfg = dict(model_config=tcfg, max_batch_size=4, max_seq_len=128, block_size=16)
    cfg.update(kw.pop("config", {}))
    return PagedLLMEngine(PagedLLMConfig(**cfg), params=tparams, device="cpu", **kw)


def test_handoff_between_torch_engines_matches_jax_single_engine(shared):
    _, _, tcfg, tparams, expect = shared
    prefiller, decoder = _engine(tcfg, tparams), _engine(tcfg, tparams)
    try:
        handoffs = [prefiller.prefill_extract(p) for p in PROMPTS]
        assert prefiller.allocator.stats()["allocated_blocks"] == 0  # blocks freed
        for p, h in zip(PROMPTS, handoffs):
            assert h["prompt_len"] == len(p) and h["prompt_ids"] == p
            assert h["kv_ticket"] is None and h["kv_ref"] is None
            n = -(-len(p) // 16)
            assert h["n_prefill_blocks"] == n
            for name in ("k", "v"):  # host tensors in the pool's layout
                t = h["kv"][name]
                assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
                assert t.shape == (tcfg.num_layers, tcfg.num_kv_heads, n, 16, tcfg.hd)
        futs = [decoder.attach_sequence(h, NEW) for h in handoffs]  # decoded as one batch
        results = [f.result(120) for f in futs]
    finally:
        prefiller.shutdown()
        decoder.shutdown()
    assert [r.token_ids for r in results] == expect
    assert [r.num_prompt_tokens for r in results] == [len(p) for p in PROMPTS]


def test_handoff_across_frameworks_both_ways(shared):
    """A JAX prefill_extract attaches into the torch engine, and a torch one,
    converted to numpy, attaches into the JAX engine."""
    jcfg, jparams, tcfg, tparams, expect = shared
    jeng, teng = _jax_engine(jcfg, jparams), _engine(tcfg, tparams)
    try:
        jax_handoffs = [jeng.prefill_extract(p) for p in PROMPTS]
        torch_handoffs = [teng.prefill_extract(p) for p in PROMPTS]
        for h in torch_handoffs:
            h["kv"] = {n: t.numpy() for n, t in h["kv"].items()}
        into_torch = [teng.attach_sequence(h, NEW) for h in jax_handoffs]
        into_jax = [jeng.attach_sequence(h, NEW) for h in torch_handoffs]
        got_torch = [f.result(120).token_ids for f in into_torch]
        got_jax = [f.result(120).token_ids for f in into_jax]
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert got_torch == expect
    assert got_jax == expect


def test_shutdown_fails_queued_ops(shared):
    _, _, tcfg, tparams, _ = shared
    prefiller = _engine(tcfg, tparams)
    try:
        handoff = prefiller.prefill_extract(PROMPTS[1])
    finally:
        prefiller.shutdown()
    decoder = _engine(tcfg, tparams, external_step=True)  # nothing drains the op queue
    fut = decoder.attach_sequence(handoff, NEW)
    decoder.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        fut.result(10)


def test_full_decode_side_requeues_the_attach(shared):
    """With every slot busy, attach requeues itself and runs once a slot is free."""
    _, _, tcfg, tparams, expect = shared
    prefiller = _engine(tcfg, tparams)
    try:
        handoff = prefiller.prefill_extract(PROMPTS[0])
    finally:
        prefiller.shutdown()
    decoder = _engine(tcfg, tparams, external_step=True, config=dict(max_batch_size=1))
    try:
        busy = decoder.generate(PROMPTS[2], 3)
        decoder.step_once()  # admits the request into the only slot
        fut = decoder.attach_sequence(handoff, NEW)
        decoder.step_once()
        assert not fut.done() and decoder._ops.qsize() == 1  # requeued
        for _ in range(50):
            if fut.done():
                break
            decoder.step_once()
        assert busy.result(10).token_ids == expect[2][:3]
        assert fut.result(10).token_ids == expect[0]
    finally:
        decoder.shutdown()


@pytest.mark.parametrize("change,max_new,match", [
    (dict(prompt_len=0), NEW, "prompt_len must be positive"),
    ({}, 128, "exceeds max_seq_len"),
    (dict(block_table=[1, 2, 3]), NEW, "block_table lists 3 pages"),
])
def test_attach_validation_errors(shared, change, max_new, match):
    _, _, tcfg, tparams, _ = shared
    eng = _engine(tcfg, tparams)
    try:
        handoff = {**eng.prefill_extract(PROMPTS[0]), **change}
        with pytest.raises(ValueError, match=match):
            eng.attach_sequence(handoff, max_new).result(60)
        assert eng.allocator.stats()["allocated_blocks"] == 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize("transfer", ["device", "plane"])
def test_unported_kv_transfers_raise(shared, transfer):
    _, _, tcfg, tparams, _ = shared
    with pytest.raises(NotImplementedError, match="queue 1 items 4 and 7"):
        _engine(tcfg, tparams, config=dict(kv_transfer=transfer))


def test_slot_prompts_set_at_admission_and_cleared(shared):
    _, _, tcfg, tparams, _ = shared
    eng = _engine(tcfg, tparams, external_step=True)
    try:
        fut = eng.generate(PROMPTS[1], 3)
        eng.step_once()
        assert eng.slot_prompts[0] == PROMPTS[1]
        while not fut.done():
            eng.step_once()
        assert eng.slot_prompts[0] is None
    finally:
        eng.shutdown()


def test_bf16_handoff_round_trips_as_torch_tensors(shared):
    """numpy has no bfloat16: a bf16 engine ships torch tensors, and another
    bf16 engine attaches them with the single engine's tokens."""
    _, _, tcfg, tparams, _ = shared
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = tl.from_jax({n: (v.float().numpy() if n != "layers" else
                              {k: t.float().numpy() for k, t in v.items()})
                          for n, v in tparams.items()}, cfg, "cpu")
    single, prefiller, decoder = (_engine(cfg, params) for _ in range(3))
    try:
        want = single.generate_sync(PROMPTS[0], NEW).token_ids
        handoff = prefiller.prefill_extract(PROMPTS[0])
        assert handoff["kv"]["k"].dtype == torch.bfloat16
        got = decoder.attach_sequence(handoff, NEW).result(60).token_ids
    finally:
        for e in (single, prefiller, decoder):
            e.shutdown()
    assert got == want


def test_attach_without_host_pages_raises(shared):
    """A JAX handoff made with the "device" or "plane" transfer carries a
    ticket or a descriptor in place of the pages: the port refuses it."""
    _, _, tcfg, tparams, _ = shared
    eng = _engine(tcfg, tparams)
    try:
        handoff = {**eng.prefill_extract(PROMPTS[0]), "kv": None, "kv_ticket": object()}
        with pytest.raises(NotImplementedError, match="queue 1 items 4 and 7"):
            eng.attach_sequence(handoff, NEW).result(60)
    finally:
        eng.shutdown()
