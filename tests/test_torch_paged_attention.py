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
