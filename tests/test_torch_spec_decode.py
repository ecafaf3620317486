"""Port parity of speculative decoding: ray_tpu_torch's SpecDecodeLLMEngine
on the CPU, on the JAX init's weights converted by from_jax. The reference's
own cases (tests/test_spec_decode.py) on the port, then token equality with
the JAX SpecDecodeLLMEngine. The load-bearing property is the greedy
invariant: the committed output equals the target model's greedy decode
exactly, for any draft model.
"""

import dataclasses

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu.serve.spec_decode import SpecDecodeConfig as JaxSpecConfig
from ray_tpu.serve.spec_decode import SpecDecodeLLMEngine as JaxSpecEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine
from ray_tpu_torch.serve.spec_decode import SpecDecodeConfig, SpecDecodeLLMEngine

PROMPT = [5, 17, 3, 42]


def _tiny(vocab=128):
    return dataclasses.replace(tl.LlamaConfig.tiny(), vocab_size=vocab)


def _jtiny(vocab=128):
    return dataclasses.replace(jl.LlamaConfig.tiny(), vocab_size=vocab)


def _params(seed):
    """The JAX init's tiny weights (vocab 128) for ``PRNGKey(seed)``, and the port's copy."""
    jparams = jl.init(_jtiny(), jax.random.PRNGKey(seed))
    return jparams, tl.from_jax(jax.tree.map(np.asarray, jparams), _tiny(), "cpu")


@pytest.fixture(scope="module")
def target():
    return _params(0)


def _baseline_tokens(params, prompt, max_new):
    eng = PagedLLMEngine(PagedLLMConfig(model_config=_tiny(), max_batch_size=2,
                                        max_seq_len=128, temperature=0.0),
                         params=params, device="cpu")
    try:
        return eng.generate_sync(prompt, max_new).token_ids
    finally:
        eng.shutdown()


def _spec(params, draft_params, K, **kw):
    cfg = SpecDecodeConfig(model_config=_tiny(), draft_model_config=_tiny(),
                           max_batch_size=kw.pop("max_batch_size", 2), max_seq_len=128,
                           temperature=0.0, num_speculative_tokens=K, **kw)
    return SpecDecodeLLMEngine(cfg, params=params, draft_params=draft_params, device="cpu")


@pytest.mark.parametrize("draft_seed", [0, 99])
def test_greedy_invariant_any_draft(target, draft_seed):
    """draft == target (seed 0) and a random unrelated draft (seed 99) must
    both reproduce the target's exact greedy output."""
    _, params = target
    expected = _baseline_tokens(params, PROMPT, 12)
    eng = _spec(params, _params(draft_seed)[1], 3)
    try:
        got = eng.generate_sync(PROMPT, 12).token_ids
    finally:
        eng.shutdown()
    assert got == expected, f"spec(draft_seed={draft_seed}) diverged from target greedy"


def test_identical_draft_accepts_everything(target):
    """draft == target: every proposal is accepted, all tokens match the plain
    engine and multi-slot batching holds."""
    _, params = target
    eng = _spec(params, params, 4, max_batch_size=3)
    try:
        prompts = [[5, 17, 3, 42], [9, 9, 2], [77, 1, 30, 8, 4]]
        futs = [eng.generate(p, 10) for p in prompts]
        results = [f.result(timeout=180) for f in futs]
        stats = eng.stats()
    finally:
        eng.shutdown()
    for p, r in zip(prompts, results):
        assert r.num_generated == 10
        assert r.token_ids == _baseline_tokens(params, p, 10), p
    assert stats["proposed_tokens"] > 0
    assert stats["accepted_tokens"] == stats["proposed_tokens"]
    # K + 1 = 5 tokens a verify step: 9 decoded tokens a request take 2 steps
    assert stats["decode_steps"] == 2


def test_eos_respected_mid_window(target):
    """An eos token inside an accepted window truncates the output there."""
    _, params = target
    ref_toks = _baseline_tokens(params, PROMPT, 12)
    eos = ref_toks[5]  # a token we know appears at step 5
    eng = _spec(params, params, 4, eos_token_id=int(eos))
    try:
        res = eng.generate_sync(PROMPT, 12)
    finally:
        eng.shutdown()
    assert res.token_ids == ref_toks[: ref_toks.index(eos) + 1]
    assert res.finish_reason == "stop"


def test_config_validation():
    def make(**kw):
        return SpecDecodeLLMEngine(SpecDecodeConfig(model_config=_tiny(), **kw), device="cpu")

    with pytest.raises(ValueError, match="draft_model_config"):
        make()
    with pytest.raises(ValueError, match="temperature"):
        make(draft_model_config=_tiny(), temperature=0.7)
    with pytest.raises(ValueError, match="vocabulary"):
        make(draft_model_config=_tiny(vocab=64))
    with pytest.raises(ValueError, match="num_speculative_tokens"):
        make(draft_model_config=_tiny(), num_speculative_tokens=0)


def test_streaming_with_spec_decode(target):
    _, params = target
    eng = _spec(params, params, 3)
    try:
        toks = list(eng.generate_stream(PROMPT, 8))
    finally:
        eng.shutdown()
    assert toks == _baseline_tokens(params, PROMPT, 8)


def test_pd_attach_with_spec_decode(target):
    """Prefill on one engine, attach + speculative decode on another: output
    matches the plain engine's greedy decode (draft KV rebuilt from the
    handoff's prompt_ids)."""
    _, params = target
    expected = _baseline_tokens(params, PROMPT, 10)
    prefiller = PagedLLMEngine(PagedLLMConfig(model_config=_tiny(), max_batch_size=2,
                                              max_seq_len=128, temperature=0.0),
                               params=params, device="cpu")
    try:
        handoff = prefiller.prefill_extract(PROMPT)
    finally:
        prefiller.shutdown()
    assert handoff["prompt_ids"] == PROMPT
    eng = _spec(params, params, 3)
    try:
        res = eng.attach_sequence(handoff, 10).result(timeout=180)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert res.token_ids == expected
    assert stats["accepted_tokens"] == stats["proposed_tokens"] > 0  # draft KV rebuilt


def test_default_draft_weights_are_seeded(target):
    _, params = target
    engines = [_spec(params, None, 3) for _ in range(2)]
    try:
        a, b = (e.draft_params["layers"]["wq"] for e in engines)
        assert (a == b).all() and not (a == params["layers"]["wq"]).all()
    finally:
        for e in engines:
            e.shutdown()


@pytest.mark.parametrize("K", [3, 4])
def test_matches_jax_spec_engine_with_random_draft(target, K):
    """The same target and random draft (PRNGKey(99)) on both engines, three
    requests at once: the same tokens, and the target's greedy tokens."""
    jparams, params = target
    jdraft, draft = _params(99)
    prompts = [PROMPT, [9, 9, 2], list(range(1, 30))]
    jeng = JaxSpecEngine(JaxSpecConfig(model_config=_jtiny(), draft_model_config=_jtiny(),
                                       max_batch_size=3, max_seq_len=128, temperature=0.0,
                                       num_speculative_tokens=K),
                         params=jparams, draft_params=jdraft)
    teng = _spec(params, draft, K, max_batch_size=3)
    try:
        jfuts = [jeng.generate(p, 14) for p in prompts]
        tfuts = [teng.generate(p, 14) for p in prompts]
        want = [f.result(180).token_ids for f in jfuts]
        got = [f.result(180).token_ids for f in tfuts]
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert got == want
    assert got == [_baseline_tokens(params, p, 14) for p in prompts]
