"""Port parity: ray_tpu_torch's paged and dense engines on the CPU against
the JAX PagedLLMEngine, on the JAX init's weights converted by from_jax.
Greedy decoding must give the same tokens, token for token."""

import jax
import numpy as np
import pytest

from ray_tpu.models import llama as jl
from ray_tpu.serve.llm_paged import PagedLLMConfig as JaxPagedConfig
from ray_tpu.serve.llm_paged import PagedLLMEngine as JaxPagedEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

PROMPTS = [[5, 9, 13, 2, 7], [3, 3, 8], list(range(1, 40))]


@pytest.fixture(scope="module")
def shared_params():
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(7))
    tcfg = tl.LlamaConfig.tiny()
    return jcfg, jparams, tcfg, tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _paged(cfg, params, **kw):
    pc = PagedLLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=128,
                        block_size=16, **kw)
    return PagedLLMEngine(pc, params=params, device="cpu")


def test_paged_engine_matches_jax_engine_greedy(shared_params):
    jcfg, jparams, tcfg, tparams = shared_params
    jeng = JaxPagedEngine(JaxPagedConfig(model_config=jcfg, max_batch_size=4,
                                         max_seq_len=128, block_size=16), params=jparams)
    teng = _paged(tcfg, tparams)
    try:
        jfuts = [jeng.generate(p, 12) for p in PROMPTS]
        tfuts = [teng.generate(p, 12) for p in PROMPTS]  # concurrent: batched decode
        for p, jf, tf in zip(PROMPTS, jfuts, tfuts):
            assert tf.result(120).token_ids == jf.result(120).token_ids, f"prompt {p[:5]}..."
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_dense_engine_matches_paged_engine(shared_params):
    _, _, tcfg, tparams = shared_params
    dense = LLMEngine(LLMConfig(model_config=tcfg, max_batch_size=4, max_seq_len=128),
                      params=tparams, device="cpu")
    paged = _paged(tcfg, tparams)
    try:
        for p in PROMPTS:
            assert dense.generate_sync(p, 12).token_ids == paged.generate_sync(p, 12).token_ids
    finally:
        dense.shutdown()
        paged.shutdown()


def test_prefix_cache_reuses_blocks(shared_params):
    _, _, tcfg, tparams = shared_params
    eng = _paged(tcfg, tparams)
    try:
        shared_prefix = list(range(1, 33))  # two full 16-token blocks
        r1 = eng.generate_sync(shared_prefix + [40, 41], 8)
        assert eng.allocator.stats()["cached_blocks"] >= 2
        eng.generate_sync(shared_prefix + [50, 51, 52], 8)
        assert eng.allocator.stats()["prefix_hits"] >= 1  # reused the prefix
        # the whole-prompt-cached recompute path, and determinism across reuse
        eng.generate_sync(shared_prefix, 4)
        r3 = eng.generate_sync(shared_prefix + [40, 41], 8)
        assert r3.token_ids == r1.token_ids
        assert eng.stats()["decode_steps"] > 0
    finally:
        eng.shutdown()


def test_blocks_released_and_stream_terminates(shared_params):
    _, _, tcfg, tparams = shared_params
    eng = _paged(tcfg, tparams)
    try:
        before = eng.allocator.stats()["allocated_blocks"]
        streamed = list(eng.generate_stream([4, 5, 6, 7], 5))
        assert streamed == eng.generate_sync([4, 5, 6, 7], 5).token_ids
        assert eng.allocator.stats()["allocated_blocks"] == before
        with pytest.raises(ValueError):
            eng.generate_sync([1] * 120, 20)  # past max_seq_len
    finally:
        eng.shutdown()


def test_dummy_decode_writes_only_garbage_block(shared_params):
    """The lockstep round on an idle engine: zeroed rows write block 0 only."""
    _, _, tcfg, tparams = shared_params
    eng = PagedLLMEngine(PagedLLMConfig(model_config=tcfg, max_batch_size=2, max_seq_len=32,
                                        block_size=16), params=tparams, external_step=True,
                         device="cpu")
    eng.dummy_decode()
    assert eng.pool["k"][:, :, 0].any()
    assert not eng.pool["k"][:, :, 1:].any() and not eng.pool["v"][:, :, 1:].any()
    assert eng.allocator.stats()["allocated_blocks"] == 0


def _bf16_engines():
    """The JAX and the port PagedLLMEngine in bfloat16 on LlamaConfig.tiny()
    widths, from one JAX init (the port's weights through from_jax)."""
    import dataclasses

    import jax.numpy as jnp
    import torch

    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.bfloat16)
    jparams = jl.init(jcfg, jax.random.PRNGKey(3))
    tparams = tl.from_jax(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams),
                          tcfg, "cpu")
    common = dict(max_batch_size=2, max_seq_len=128, block_size=16, num_blocks=32)
    return (JaxPagedEngine(JaxPagedConfig(model_config=jcfg, **common), params=jparams),
            PagedLLMEngine(PagedLLMConfig(model_config=tcfg, **common), params=tparams,
                           device="cpu"))


def _last_logits(eng, tokens, table, start):
    """The engine's own prefill of ``tokens`` over ``table`` from position
    ``start``; the float32 logits at the last token."""
    import jax.numpy as jnp

    padded = np.zeros((1, 32 if len(tokens) <= 32 else 64), np.int32)
    padded[0, :len(tokens)] = tokens
    row = np.zeros((1, eng.max_blocks_per_seq), np.int32)
    row[0, :len(table)] = table
    if isinstance(eng, JaxPagedEngine):
        logits, eng.pool = eng._prefill(eng.params, eng.pool, jnp.asarray(padded),
                                        jnp.asarray(row), jnp.asarray([start], np.int32))
        return np.asarray(logits.astype(jnp.float32))[len(tokens) - 1]
    logits = eng._prefill(eng._tensor(padded), eng._tensor(row),
                          eng._tensor(np.asarray([start], np.int32)))
    return logits.float().numpy()[len(tokens) - 1]


def test_bf16_prefix_hit_keeps_the_bytes_in_both_engines():
    """One body in bfloat16, prefilled whole and over a prefix cached by an
    earlier request (two 16-token blocks): in the JAX engine and in the port
    the last logits are the same bits either way, and so are the greedy
    tokens through the engines' own prefix cache. The port moves no byte
    the reference keeps, and both engines give the same tokens."""
    jeng, teng = _bf16_engines()
    rng = np.random.default_rng(0)
    trials = [(rng.integers(3, 256, 32).tolist(), rng.integers(3, 256, 9 + t).tolist())
              for t in range(3)]
    try:
        logits, tokens = {}, {}
        for name, eng in (("jax", jeng), ("port", teng)):
            for trial, (prefix, suffix) in enumerate(trials):
                full = _last_logits(eng, prefix + suffix, [1, 2, 3], 0)
                _last_logits(eng, prefix, [4, 5], 0)
                hit = _last_logits(eng, suffix, [4, 5, 6], 32)
                assert np.array_equal(full, hit), (name, trial, np.abs(full - hit).max())
                logits.setdefault(name, []).append(full)
            eng.allocator = type(eng.allocator)(32, 16)  # forget the pages used above
            body = list(range(3, 35)) + [40, 41, 42]
            alone = eng.generate_sync(body, 16).token_ids
            eng.generate_sync(list(range(3, 35)) + [90], 2)  # body's blocks cached
            hits = eng.allocator.stats()["prefix_hits"]
            again = eng.generate_sync(body, 16).token_ids
            assert eng.allocator.stats()["prefix_hits"] > hits, name
            assert again == alone, name
            tokens[name] = alone
        assert tokens["port"] == tokens["jax"]
        # XLA's and torch's bf16 arithmetic round differently: on these
        # bodies the logits part by up to 1.1e-2 of the largest one (two bf16
        # ulps), with the same top token
        for a, b in zip(logits["port"], logits["jax"]):
            assert np.abs(a - b).max() <= 2.5e-2 * np.abs(b).max() and a.argmax() == b.argmax()
    finally:
        jeng.shutdown()
        teng.shutdown()


@pytest.mark.parametrize("block_size", [16, 96])
def test_paged_engine_at_wide_shapes_matches_jax_engine(block_size):
    """Shapes the paged kernel now takes: head dim 48, a group of 16 query
    heads on one kv head, and (at 96) pages above 64 tokens. The port's
    engine gives the JAX engine's greedy tokens on the same weights."""
    import dataclasses

    change = dict(num_heads=16, num_kv_heads=1, head_dim=48)
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), **change)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), **change)
    jparams = jl.init(jcfg, jax.random.PRNGKey(3))
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jeng = JaxPagedEngine(JaxPagedConfig(model_config=jcfg, max_batch_size=4, max_seq_len=192,
                                         block_size=block_size), params=jparams)
    teng = PagedLLMEngine(PagedLLMConfig(model_config=tcfg, max_batch_size=4, max_seq_len=192,
                                         block_size=block_size), params=tparams, device="cpu")
    try:
        jfuts = [jeng.generate(p, 8) for p in PROMPTS]
        tfuts = [teng.generate(p, 8) for p in PROMPTS]
        for jf, tf in zip(jfuts, tfuts):
            assert tf.result(120).token_ids == jf.result(120).token_ids
    finally:
        jeng.shutdown()
        teng.shutdown()
