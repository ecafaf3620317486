"""Port parity: ray_tpu_torch.models.llama against ray_tpu.models.llama on
the tiny config in float32, with the JAX init's weights converted by
``from_jax``. Inputs come from numpy and go to both sides.

Tolerances: 1e-5 for single ops (float32 rounding of the same formula);
2e-4 on logits after a two-layer forward, as the JAX package's own
kernel-vs-gather test uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl

BS = 8


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny()
    tcfg = tl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(0))
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_from_jax_keeps_layout(models):
    _, jparams, tcfg, tparams = models
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(tparams["layers"]) + len(tparams) - 1
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tparams
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape, keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    assert tparams["layers"]["attn_norm"].dtype == torch.float32
    assert tparams["layers"]["wq"].dtype == tcfg.dtype
    assert sum(t.numel() for t in tparams["layers"].values()) + sum(
        v.numel() for k, v in tparams.items() if k != "layers"
    ) == tl.param_count_analytic(tcfg) == jl.param_count_analytic(jl.LlamaConfig.tiny())


def test_init_layout_matches_jax_and_is_seeded():
    cfg = tl.LlamaConfig.tiny()
    a = tl.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tl.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    jparams = jl.init(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    for name, leaf in jparams["layers"].items():
        assert tuple(a["layers"][name].shape) == leaf.shape
        torch.testing.assert_close(a["layers"][name], b["layers"][name])
    assert tuple(a["lm_head"].shape) == jparams["lm_head"].shape


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16), np.float32)
    w = rng.standard_normal((16,), np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), atol=1e-5)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)), atol=1e-5)


def _paged_setup(cfg, B=2, seed=2):
    max_blocks = cfg.max_seq_len // BS
    nb = B * max_blocks + 1
    rng = np.random.default_rng(seed)
    tables = rng.permutation(np.arange(1, nb)).reshape(B, max_blocks).astype(np.int32)
    return nb, tables, rng


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_paged_prefill_then_decode_matches_jax(models, use_kernel):
    """Prefill (gather path on both sides) then one decode step through the
    gather path or the kernel path (port: plain version; JAX: Pallas in
    interpret mode)."""
    jcfg, jparams, tcfg, tparams = models
    nb, tables, rng = _paged_setup(tcfg)
    prompt = rng.integers(0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    lens = np.asarray([11, 7], np.int32)  # row 1's tail is padding, masked later

    jpool = jl.init_kv_pool(jcfg, nb, BS)
    jlog, jpool = jl.forward_paged(jparams, jnp.asarray(prompt), jcfg, jpool,
                                   jnp.asarray(tables), jnp.zeros(2, jnp.int32), BS)
    jdec, jpool = jl.forward_paged(jparams, jnp.asarray(tok), jcfg, jpool,
                                   jnp.asarray(tables), jnp.asarray(lens), BS,
                                   use_kernel=use_kernel)

    tpool = tl.init_kv_pool(tcfg, nb, BS, device="cpu")
    tlog, _ = tl.forward_paged(tparams, torch.from_numpy(prompt), tcfg, tpool,
                               torch.from_numpy(tables), torch.zeros(2, dtype=torch.int32), BS)
    tdec, tpool = tl.forward_paged(tparams, torch.from_numpy(tok), tcfg, tpool,
                                   torch.from_numpy(tables), torch.from_numpy(lens), BS,
                                   use_kernel=use_kernel)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-4)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=2e-4)
    np.testing.assert_allclose(tpool["k"].numpy(), np.asarray(jpool["k"]), atol=2e-4)


def test_forward_with_cache_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    lens = np.asarray([9, 9], np.int32)
    jc = jl.init_kv_cache(jcfg, 2, 32)
    jlog, jc = jl.forward_with_cache(jparams, jnp.asarray(prompt), jcfg, jc,
                                     jnp.zeros(2, jnp.int32))
    jdec, jc = jl.forward_with_cache(jparams, jnp.asarray(tok), jcfg, jc, jnp.asarray(lens))
    tc = tl.init_kv_cache(tcfg, 2, 32, device="cpu")
    tlog, _ = tl.forward_with_cache(tparams, torch.from_numpy(prompt), tcfg, tc,
                                    torch.zeros(2, dtype=torch.int32))
    tdec, tc = tl.forward_with_cache(tparams, torch.from_numpy(tok), tcfg, tc,
                                     torch.from_numpy(lens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=2e-4)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=2e-4)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=2e-4)


def test_out_of_table_padding_writes_only_block_zero(models):
    """A bucketed prefill of a near-full sequence pads past the table: those
    positions must land in garbage block 0, never alias the real last block
    (torch would raise on the index, jax would clamp onto the last block)."""
    jcfg, jparams, tcfg, tparams = models
    max_blocks = tcfg.max_seq_len // BS
    nb = max_blocks + 3
    tables = np.arange(1, max_blocks + 1, dtype=np.int32)[None, :]
    start = tcfg.max_seq_len - 5  # 5 real slots left, 16 tokens written
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (1, 16)).astype(np.int32)

    tpool = tl.init_kv_pool(tcfg, nb, BS, device="cpu")
    tl.forward_paged(tparams, torch.from_numpy(tok), tcfg, tpool, torch.from_numpy(tables),
                     torch.tensor([start], dtype=torch.int32), BS)
    jpool = jl.init_kv_pool(jcfg, nb, BS)
    _, jpool = jl.forward_paged(jparams, jnp.asarray(tok), jcfg, jpool, jnp.asarray(tables),
                                jnp.asarray([start], jnp.int32), BS)
    tk = tpool["k"].numpy()
    # blocks outside the table stay untouched; the table's blocks match jax
    assert not tk[:, :, max_blocks + 1:].any()
    np.testing.assert_allclose(tk[:, :, 1:], np.asarray(jpool["k"])[:, :, 1:], atol=2e-4)
    # the last real block holds exactly the 5 in-table positions
    last = tk[:, :, max_blocks]
    assert last[:, :, BS - 5:].any(axis=-1).all()
    assert tk[:, :, 0].any()  # the overflow went to block 0
