"""Port parity: ray_tpu_torch.ops.flash_attention on the CPU (the plain
versions, reached through the same wrappers and autograd Function the card
runs) against ray_tpu.ops.flash_attention, whose Pallas kernels run here in
interpret mode. Inputs are made with numpy from a seed and go to both sides.

Tolerances (float32 on both sides, sums taken in another order): outputs
and the plain backward functions atol 2e-5; gradients through the Function
atol 1e-4, and 2e-4 for GQA, the values tests/test_ops.py holds the JAX
flash kernels to against dense attention.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

BLOCK = 32  # JAX tile; S = 100 pads to 128 there, the port masks the edge itself


def _inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D), np.float32),
            rng.standard_normal((B, S, Hkv, D), np.float32),
            rng.standard_normal((B, S, Hkv, D), np.float32),
            rng.standard_normal((B, S, Hq, D), np.float32))


def _jax_flash(causal):
    return lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal, block_q=BLOCK,
                                               block_k=BLOCK)


# S 127 and 129 sit one under and one over the CUDA forward's 128-row q tile;
# 63 and 65 around the bf16 dK/dV kernel's 64-key tile, 33 and 95 around its
# 32-query tile at D 128
SHAPES = [(1, 96, 2, 2, 16), (1, 100, 2, 2, 16), (2, 64, 8, 2, 16), (1, 127, 2, 2, 16),
          (1, 129, 4, 2, 16), (1, 33, 2, 2, 16), (1, 63, 4, 1, 16), (1, 65, 2, 2, 16),
          (1, 95, 2, 1, 16)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(causal, shape):
    q, k, v, _ = _inputs(*shape, seed=0)
    want = _jax_flash(causal)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = (tfa.fwd_launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (tfa.fwd_launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_grads_through_function_match_jax(causal, shape):
    q, k, v, cot = _inputs(*shape, seed=1)
    fn = _jax_flash(causal)
    want = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * cot), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (tq, tk, tv))
    atol = 2e-4 if shape[2] != shape[3] else 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def _jax_kernels(q, k, v, do, causal):
    """The JAX flash kernels on numpy inputs (S a multiple of BLOCK), in the
    port's layouts: o [B, S, Hq, D]; lse and delta [B, Hq, S]; dq [B, S, Hq,
    D]; dk and dv [B, S, Hkv, D], summed over each group as the adjoint of
    the JAX wrapper's KV repeat."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]

    def bh(x):  # [B, S, H, D] -> [B * Hq, S, D], kv heads repeated as the JAX wrapper does
        x = jnp.repeat(jnp.asarray(x), Hq // x.shape[2], axis=2)
        return x.transpose(0, 2, 1, 3).reshape(B * Hq, S, D)

    def from_bh(x, heads):  # JAX [B * Hq, S, D] -> [B, S, heads, D], summed over the group
        x = np.asarray(x).reshape(B, heads, Hq // heads, S, D).sum(axis=2)
        return x.transpose(0, 2, 1, 3)

    qbh, kbh, vbh, dobh = bh(q), bh(k), bh(v), bh(do)
    o, lse = jfa._fwd_call(qbh, kbh, vbh, causal, BLOCK, BLOCK, True, S)
    delta = jnp.sum(dobh * o, axis=-1)
    dq, dk, dv = jfa._flash_bh_bwd(causal, BLOCK, BLOCK, True, S, (qbh, kbh, vbh, o, lse), dobh)
    rows = [torch.from_numpy(np.array(x)).reshape(B, Hq, S) for x in (lse, delta)]
    return (from_bh(o, Hq), *rows, from_bh(dq, Hq), from_bh(dk, Hkv), from_bh(dv, Hkv))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernels_match_jax_kernels(causal):
    """Each plain version against its JAX kernel on the same inputs: the
    forward's lse, and dq/dk/dv fed JAX's own lse and delta."""
    B, S, Hq, Hkv, D = 2, 64, 8, 2, 16  # GQA 4
    q, k, v, do = _inputs(B, S, Hq, Hkv, D, seed=2)
    o, t_lse, t_delta, dq, dk, dv = _jax_kernels(q, k, v, do, causal)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o_ref, lse_ref = tfa.flash_fwd_ref(tq, tk, tv, causal)
    np.testing.assert_allclose(lse_ref.numpy(), t_lse.numpy(), atol=2e-5)
    np.testing.assert_allclose(o_ref.numpy(), o, atol=2e-5)

    got_dq = tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, t_lse, t_delta, causal)
    got_dk, got_dv = tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, t_lse, t_delta, causal)
    np.testing.assert_allclose(got_dq.numpy(), dq, atol=2e-5)
    np.testing.assert_allclose(got_dk.numpy(), dk, atol=2e-5)
    np.testing.assert_allclose(got_dv.numpy(), dv, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 40])
def test_padded_head_dim_matches_unpadded_and_jax(causal, D):
    """What the wrappers do on the card for a head dim the kernels are not
    built for: q, k, v and dO zero-padded to 64 by ``pad_head_dim``, the
    plain versions run with the caller's scale, the outputs sliced back.
    The padded columns of every output are exact zeros, and the rest agrees
    with the unpadded plain versions and with the JAX kernels (the backward
    fed JAX's lse and delta, as above)."""
    assert tfa.kernel_head_dim(D) == 64
    _check_padded(causal, D)


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_off_the_multiples_of_8_is_padded_to_128(causal):
    """D 100, not a multiple of 8, is zero-padded to 128 as the others are
    to 64, and agrees with the unpadded plain versions and the JAX kernels."""
    assert tfa.kernel_head_dim(100) == 128
    _check_padded(causal, 100)


def test_llama_config_past_head_dim_128_is_refused_at_build():
    """Since the kernels take head dims up to 256, a config with a head dim
    above 128 builds at any max_seq_len, as the JAX LlamaConfig does; what
    the wrappers still refuse is a head dim past 256, or 0."""
    from ray_tpu_torch.models import llama

    assert llama.LlamaConfig(hidden_size=2048, num_heads=8, num_kv_heads=4, head_dim=256).hd == 256
    assert llama.LlamaConfig(hidden_size=256, num_heads=1, num_kv_heads=1,
                             max_seq_len=llama.FLASH_MIN_SEQ).hd == 256
    assert llama.LlamaConfig(hidden_size=2048, num_heads=16, head_dim=128).hd == 128
    for D in (264, 0):
        q, k, v, _ = map(torch.from_numpy, _inputs(1, 8, 2, 2, D, seed=0))
        with pytest.raises(ValueError, match="head dim"):
            tfa._check("flash_fwd", q, k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [160, 256])
def test_plain_kernels_match_jax_kernels_above_head_dim_128(causal, D):
    """Head dims the D 256 kernels serve (160 zero-padded to 256, 256 as it
    is): the plain forward and both plain backward functions, at the
    padded width with the caller's scale and sliced back, against the JAX
    kernels in interpret mode on the same inputs (S 64, two query heads on
    one kv head), the backward fed JAX's lse and delta."""
    assert tfa.kernel_head_dim(D) == 256
    B, S, Hq, Hkv = 1, 64, 2, 1
    q, k, v, do = _inputs(B, S, Hq, Hkv, D, seed=5)
    j_o, j_lse, j_delta, j_dq, j_dk, j_dv = _jax_kernels(q, k, v, do, causal)
    pq, pk, pv, pdo = (tfa.pad_head_dim(torch.from_numpy(x), 256) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    o, lse = tfa.flash_fwd_ref(pq, pk, pv, causal, scale=scale)
    np.testing.assert_allclose(o[..., :D].numpy(), j_o, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), j_lse.numpy(), atol=2e-5)
    dq = tfa.flash_bwd_dq_ref(pq, pk, pv, pdo, j_lse, j_delta, causal, scale=scale)
    dk, dv = tfa.flash_bwd_dkv_ref(pq, pk, pv, pdo, j_lse, j_delta, causal, scale=scale)
    for got, want in zip((o, dq, dk, dv), (j_o, j_dq, j_dk, j_dv)):
        assert not got[..., D:].any()
        np.testing.assert_allclose(got[..., :D].numpy(), want, atol=2e-5)


def _check_padded(causal, D):
    B, S, Hq, Hkv = 1, 96, 4, 2  # S a multiple of the JAX kernels' block
    q, k, v, do = _inputs(B, S, Hq, Hkv, D, seed=4)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    Dk = tfa.kernel_head_dim(D)
    assert tfa.pad_head_dim(tq, D) is tq
    pq, pk, pv, pdo = (tfa.pad_head_dim(x, Dk) for x in (tq, tk, tv, tdo))
    assert pq.shape == (B, S, Hq, Dk) and not pq[..., D:].any()
    scale = 1.0 / math.sqrt(D)

    def sliced(x):
        assert not x[..., D:].any()
        return x[..., :D].numpy()

    o, lse = tfa.flash_fwd_ref(pq, pk, pv, causal, scale=scale)
    o_plain, lse_plain = tfa.flash_fwd_ref(tq, tk, tv, causal)
    j_o, j_lse, j_delta, j_dq, j_dk, j_dv = _jax_kernels(q, k, v, do, causal)
    for want in (o_plain.numpy(), j_o):
        np.testing.assert_allclose(sliced(o), want, atol=2e-5)
    for want in (lse_plain, j_lse):
        np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=2e-5)

    dq = tfa.flash_bwd_dq_ref(pq, pk, pv, pdo, j_lse, j_delta, causal, scale=scale)
    dk, dv = tfa.flash_bwd_dkv_ref(pq, pk, pv, pdo, j_lse, j_delta, causal, scale=scale)
    plain = (tfa.flash_bwd_dq_ref(tq, tk, tv, tdo, j_lse, j_delta, causal),
             *tfa.flash_bwd_dkv_ref(tq, tk, tv, tdo, j_lse, j_delta, causal))
    for got, want_plain, want_jax in zip((dq, dk, dv), plain, (j_dq, j_dk, j_dv)):
        np.testing.assert_allclose(sliced(got), want_plain.numpy(), atol=2e-5)
        np.testing.assert_allclose(sliced(got), want_jax, atol=2e-5)


def test_dead_rows_contribute_nothing_to_the_backward():
    """A row whose lse is NEG_INF (no live key) gives P = 0, so its dQ is
    zero and it adds nothing to dK or dV, as in the reference's
    ``_recompute_p``."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 8, 2, 1, 16, seed=3))
    lse = torch.full((1, 2, 8), tfa.NEG_INF)
    delta = torch.ones(1, 2, 8)
    assert not tfa._recompute_p(q, k, lse, causal=True).any()
    assert not tfa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True).any()
    dk, dv = tfa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, True)
    assert not dk.any() and not dv.any()
