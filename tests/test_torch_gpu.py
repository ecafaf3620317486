"""Card tests of ray_tpu_torch: the Hopper kernels against their plain
versions, and an engine run that goes through them. Each test needs a CUDA
device and skips without one (decided in a fixture, never at import).

Run on the card with:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: float32 atol 2e-5 (the same float32 terms summed in another
order); bfloat16 atol = rtol = 1e-2, about two bf16 ulps of the output,
since both sides compute in float32 and round once at the end.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _paged_inputs(device, dtype, B, Hkv, g, D, BS, max_blocks, lengths, seed=0):
    rng = np.random.default_rng(seed)
    NB = B * max_blocks + 1
    tables = rng.permutation(np.arange(1, NB))[: B * max_blocks].reshape(B, max_blocks)

    def t(a):
        return torch.from_numpy(a).to(device)

    return (t(rng.standard_normal((B, Hkv * g, D), np.float32)).to(dtype),
            t(rng.standard_normal((Hkv, NB, BS, D), np.float32)).to(dtype),
            t(rng.standard_normal((Hkv, NB, BS, D), np.float32)).to(dtype),
            t(tables.astype(np.int32)), t(np.asarray(lengths, np.int32)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,D,BS", [(4, 128, 16), (1, 64, 8), (8, 64, 64), (3, 128, 32)])
def test_paged_kernel_matches_plain(cuda, dtype, g, D, BS):
    max_blocks = 6
    lengths = [1, BS * max_blocks, 0, BS + 3, 2 * BS - 1]  # ragged, full, dead
    args = _paged_inputs(cuda, dtype, len(lengths), 2, g, D, BS, max_blocks, lengths)
    before = pa.launches
    got = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = pa.paged_decode_attention_ref(*args)
    torch.testing.assert_close(got, ref, **TOL[dtype])
    assert not got[2].any()  # length 0 gives zeros


@pytest.mark.gpu
def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, tables, lengths = _paged_inputs(cuda, torch.float32, 2, 2, 2, 32, 8, 3, [3, 5])
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q, k, v, tables, lengths)
    q, k, v, tables, lengths = _paged_inputs(cuda, torch.float32, 2, 2, 2, 64, 8, 3, [3, 5])
    with pytest.raises(TypeError, match="int32"):
        pa.paged_decode_attention(q, k, v, tables.long(), lengths)


@pytest.mark.gpu
def test_paged_engine_decodes_through_the_kernel(cuda):
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=256,
                            dtype=torch.bfloat16, remat=False)
    eng = PagedLLMEngine(PagedLLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=256,
                                        block_size=16), seed=0, device=cuda)
    try:
        before = pa.launches
        futs = [eng.generate(list(range(1, n)), 6) for n in (5, 40, 100)]
        outs = [f.result(timeout=300) for f in futs]
        assert all(o.num_generated == 6 for o in outs)
        steps = eng.stats()["decode_steps"]
        assert steps > 0 and pa.launches - before == cfg.num_layers * steps
    finally:
        eng.shutdown()
