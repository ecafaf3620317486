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
