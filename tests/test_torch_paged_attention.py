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


# ---------------------------------------------------------------- wider shapes
@pytest.mark.parametrize("D", [48, 80, 96, 256])
@pytest.mark.parametrize("g", [1, 4])
def test_new_head_dims_match_jax_kernel(D, g):
    """Head dims the kernel is now built for: the plain version and the
    kernel's split arithmetic (runs of 2 pages) against the Pallas kernel."""
    arrays = _inputs(g, [5, 17, 0, 32], B=4, D=D, BS=8, max_blocks=4)
    ref, got = _both(arrays)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    split = port.paged_decode_attention_split_ref(*(torch.from_numpy(a) for a in arrays), 2)
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("g", [12, 16])
def test_groups_above_eight_match_jax_kernel(g):
    """A group above 8 (the kernel serves it in chunks of at most 8 query
    heads a CTA, the last one zero-padded at 12): the plain version, and the
    split arithmetic chunk by chunk, against the Pallas kernel."""
    arrays = _inputs(g, [5, 17, 32], D=16, BS=8, max_blocks=4)
    ref, got = _both(arrays)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    split = port.paged_decode_attention_split_ref(*(torch.from_numpy(a) for a in arrays), 1)
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("D", [36, 40, 200])
@pytest.mark.parametrize("g", [1, 4])
def test_head_dims_between_the_built_ones_match_jax_kernel(D, g):
    """Head dims no kernel is built for (the card runs them on the next one
    up, 48 or 256, with the caller's head dim at run time): the plain
    version and the split arithmetic against the Pallas kernel, and the
    head dim the kernel that serves them is built for."""
    assert port.kernel_head_dim(D) == {36: 48, 40: 48, 200: 256}[D]
    arrays = _inputs(g, [5, 17, 0, 32], B=4, D=D, BS=8, max_blocks=4)
    ref, got = _both(arrays)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    split = port.paged_decode_attention_split_ref(*(torch.from_numpy(a) for a in arrays), 2)
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("BS, sub", [(128, 64), (96, 48), (200, 50), (67, 1), (64, 64)])
def test_sub_page_size(BS, sub):
    assert port.sub_page_size(BS) == sub


@pytest.mark.parametrize("BS", [96, 128])
@pytest.mark.parametrize("g", [2, 16])
def test_large_pages_through_sub_pages_match_jax_kernel(BS, g):
    """Pages above 64 tokens: the JAX kernel on the pages as they are, the
    port's plain version on them too, and on the sub-page view and table
    that the wrapper hands the kernel (``as_sub_pages``), plain and split."""
    arrays = _inputs(g, [1, BS, BS + 7, 3 * BS], B=4, D=16, BS=BS, max_blocks=3)
    ref, got = _both(arrays)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    q, k, v, tables, lengths = (torch.from_numpy(a) for a in arrays)
    sk, sv, st = port.as_sub_pages(k, v, tables)
    r = BS // port.sub_page_size(BS)
    assert sk.shape == (k.shape[0], k.shape[1] * r, BS // r, 16)
    assert sk.data_ptr() == k.data_ptr() and st.shape == (4, 3 * r) and st.dtype == torch.int32
    sub = port.paged_decode_attention_ref(q, sk, sv, st, lengths)
    np.testing.assert_allclose(sub.numpy(), ref, atol=2e-5)
    split = port.paged_decode_attention_split_ref(q, sk, sv, st, lengths, 2)
    np.testing.assert_allclose(split.numpy(), ref, atol=2e-5)


def test_check_shape_takes_the_new_shapes():
    for D in (16, 32, 48, 64, 80, 96, 128, 256, 1, 36, 40, 112, 200, 255):
        port.check_shape(32, 8, D, 16)
    port.check_shape(32, 2, 128, 16)   # group 16
    port.check_shape(32, 1, 64, 128)   # group 32, pages of 128
    port.check_shape(8, 8, 64, 96)
    for D in (0, 264):  # what is still refused: a head dim outside 1..256
        with pytest.raises(ValueError, match="head dim"):
            port.check_shape(8, 2, D, 16)
    with pytest.raises(ValueError, match="times Hkv"):
        port.check_shape(6, 4, 64, 16)
    with pytest.raises(ValueError, match="block size"):
        port.check_shape(8, 2, 64, 0)
