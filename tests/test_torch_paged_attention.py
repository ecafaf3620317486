"""Port parity: ray_tpu_torch's paged_decode_attention (its plain PyTorch
version, which CPU tensors take) against the JAX Pallas kernel in interpret
mode, on the same numpy inputs.

Tolerance: atol 2e-5 in float32, the JAX kernel test's own bound; both sides
sum the same float32 terms in a different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from ray_tpu_torch.ops import paged_attention as port


def _inputs(g, lengths, seed=0, B=3, Hkv=2, D=16, BS=8, max_blocks=4):
    rng = np.random.default_rng(seed)
    NB = B * max_blocks + 1
    # non-trivial table: pages deliberately out of order across the pool
    perm = rng.permutation(np.arange(1, NB))
    tables = perm[: B * max_blocks].reshape(B, max_blocks).astype(np.int32)
    q = rng.standard_normal((B, Hkv * g, D), np.float32)
    k_pages = rng.standard_normal((Hkv, NB, BS, D), np.float32)
    v_pages = rng.standard_normal((Hkv, NB, BS, D), np.float32)
    return q, k_pages, v_pages, tables, np.asarray(lengths, np.int32)


def _both(arrays):
    ref = jax_paged(*(jnp.asarray(a) for a in arrays), interpret=True)
    got = port.paged_decode_attention(*(torch.from_numpy(a) for a in arrays))
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_decode_matches_jax_kernel(g):
    ref, got = _both(_inputs(g, [5, 17, 32]))  # ragged, incl. a full table
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_paged_decode_matches_jax_kernel_at_block_size_4(g):
    """Pages of 4 tokens at head dim 16, the shapes LlamaConfig.tiny() and
    the reference's engine tests serve, which the kernel now takes too."""
    ref, got = _both(_inputs(g, [3, 4, 13, 32], B=4, D=16, BS=4, max_blocks=8))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_dead_row_gives_zeros():
    q, k, v, tables, _ = _inputs(2, [0, 9, 0])
    lengths = np.asarray([0, 9, 0], np.int32)
    ref, got = _both((q, k, v, tables, lengths))
    assert not got[0].any() and not got[2].any()
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = port.launches
    _both(_inputs(1, [3, 8, 31]))
    assert port.launches == before  # only kernel launches count


def _split_inputs(g, BS, pages_per_split, seed=0, max_blocks=6):
    """Rows at the split edges: length 0 and 1, exactly one split, one past a
    split edge, one under two splits, and all splits live (a full table)."""
    T = pages_per_split * BS
    full = max_blocks * BS
    lengths = [min(n, full) for n in (0, 1, T, T + 1, 2 * T - 1, full)]
    return _inputs(g, lengths, seed=seed, B=len(lengths), D=16, BS=BS, max_blocks=max_blocks)


@pytest.mark.parametrize("BS", [4, 8])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3])
def test_split_ref_matches_jax_kernel(pages_per_split, g, BS):
    """The kernel's split-K arithmetic (partials per run of pages, merged by
    the combine rule) against the Pallas kernel in interpret mode."""
    arrays = _split_inputs(g, BS, pages_per_split)
    ref = np.asarray(jax_paged(*(jnp.asarray(a) for a in arrays), interpret=True))
    got = port.paged_decode_attention_split_ref(*(torch.from_numpy(a) for a in arrays),
                                                pages_per_split).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert not got[0].any()  # length 0 gives zeros
