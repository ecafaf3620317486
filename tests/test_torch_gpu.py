"""Card tests of ray_tpu_torch: the Hopper kernels against their plain
versions, and engine and trainer runs that go through them. Each test needs
a CUDA device and skips without one (decided in a fixture, never at import).

Run on the card with:
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances, paged decode: float32 atol 2e-5 (the same float32 terms summed
in another order); bfloat16 atol = rtol = 1e-2, about two bf16 ulps of the
output, since both sides compute in float32 and round once at the end.

Flash kernels: float32 atol 2e-5 * max(1, max |plain|) elementwise (float32
throughout, sums reordered). bfloat16 per row, the 2-norm over the last dim
at each batch, position and head: |got - plain| <= 1e-2 |plain| + 1e-4. The
kernel rounds P and dS to bf16 before its tensor-core products, the plain
version keeps them float32, and both round the output to bf16; the outputs
are averages whose size falls along the sequence, so one tensor-wide atol
would be the size of most rows. The 1e-4 floor is for rows that are zero in
exact arithmetic (dQ of the first row when causal). lse, float32 on both
sides, atol 1e-4 (values up to ~log S + max score).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama, moe, vit
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine
from ray_tpu_torch.serve.spec_decode import SpecDecodeConfig, SpecDecodeLLMEngine
from ray_tpu_torch.train import spmd

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
@pytest.mark.parametrize("g,D,BS", [(4, 128, 16), (1, 64, 8), (8, 64, 64), (3, 128, 32),
                                    (2, 16, 4), (8, 16, 16), (4, 32, 5), (1, 32, 64),
                                    (4, 128, 1), (2, 64, 12)])
def test_paged_kernel_matches_plain(cuda, dtype, g, D, BS):
    """Ragged rows, a dead row, a full table of at least 128 pages, and rows
    one under, at and one over the edges of the first two splits."""
    T = pa.pages_per_split(BS, D, dtype) * BS  # tokens a split takes
    max_blocks = max(128, -(-(2 * T + 1) // BS))
    full = BS * max_blocks
    lengths = [1, full, 0, BS + 3, 2 * BS - 1]  # ragged, full, dead
    lengths += [k * T + d for k in (1, 2) for d in (-1, 0, 1)]
    args = _paged_inputs(cuda, dtype, len(lengths), 2, g, D, BS, max_blocks, lengths)
    before = pa.launches
    got = pa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = pa.paged_decode_attention_ref(*args)
    torch.testing.assert_close(got, ref, **TOL[dtype])
    assert not got[2].any()  # length 0 gives zeros


@pytest.mark.gpu
def test_paged_kernel_needs_no_host_sync(cuda):
    """The wrapper reads nothing back from the card (the decode step calls it
    once a layer): under sync debug mode "error" a call must not raise."""
    lengths = [37, 0, 300, 2048]
    args = _paged_inputs(cuda, torch.bfloat16, len(lengths), 8, 4, 128, 16, 128, lengths)
    pa.paged_decode_attention(*args)  # build and load outside the checked call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pa.paged_decode_attention(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, pa.paged_decode_attention_ref(*args), **TOL[torch.bfloat16])


@pytest.mark.gpu
def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, tables, lengths = _paged_inputs(cuda, torch.float32, 2, 2, 2, 48, 8, 3, [3, 5])
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q, k, v, tables, lengths)
    q, k, v, tables, lengths = _paged_inputs(cuda, torch.float32, 2, 1, 16, 64, 8, 3, [3, 5])
    with pytest.raises(ValueError, match="times Hkv"):
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


def _to(params, device):
    return {n: _to(p, device) if isinstance(p, dict) else p.to(device)
            for n, p in params.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("block_size", [4, 16])
def test_tiny_paged_engine_on_the_card_matches_the_cpu(cuda, block_size):
    """LlamaConfig.tiny() (head dim 16, group 2, float32) decodes through the
    paged kernel on the card at every step and gives the CPU engine's greedy
    tokens from the same weights."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [[5, 9, 13, 2, 7], [3, 3, 8], list(range(1, 40))]
    tokens = {}
    for device in ("cpu", cuda):
        eng = PagedLLMEngine(PagedLLMConfig(model_config=cfg, max_batch_size=4,
                                            max_seq_len=128, block_size=block_size),
                             params=_to(params, device), device=device)
        try:
            before = pa.launches
            futs = [eng.generate(p, 12) for p in prompts]
            tokens[str(device)] = [f.result(timeout=300).token_ids for f in futs]
            steps = eng.stats()["decode_steps"]
            launches = pa.launches - before
        finally:
            eng.shutdown()
        assert steps > 0
        assert launches == (cfg.num_layers * steps if device == cuda else 0)
    assert tokens[str(cuda)] == tokens["cpu"]


@pytest.mark.gpu
def test_tiny_openai_app_over_http_on_the_card_matches_the_cpu(cuda):
    """LlamaConfig.tiny() served by build_openai_app through serve.run and the
    HTTP proxy, once on the CPU and once on the card from the same weights:
    the same text for the same bodies, every decode step on the card through
    the paged kernel."""
    import json
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    bodies = [("completions", {"prompt": "paged attention", "max_tokens": 12}),
              ("chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                    "max_tokens": 12}),
              ("completions", {"prompt": "y" * 39, "max_tokens": 12})]
    texts = {}
    rt.init(num_cpus=4)
    try:
        for device in ("cpu", cuda):
            serve.run(serve.build_openai_app(
                PagedLLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=128,
                               block_size=4),
                params=_to(params, device), device=device), route_prefix="/v1")
            port = serve.start_http_proxy(port=0).port
            before = pa.launches
            outs = []
            for sub, body in bodies:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/{sub}",
                                             data=json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                choice = json.loads(urllib.request.urlopen(req, timeout=120).read())["choices"][0]
                outs.append(choice["text"] if "text" in choice else choice["message"]["content"])
            texts[str(device)] = outs
            stats = rt.get(serve.get_deployment_handle("OpenAIServer").stats.remote(), timeout=30)
            launches = pa.launches - before
            serve.shutdown()
            assert stats["decode_steps"] > 0
            assert launches == (cfg.num_layers * stats["decode_steps"] if device == cuda else 0)
    finally:
        serve.shutdown()
        rt.shutdown()
    assert texts[str(cuda)] == texts["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("change,match", [
    (dict(hidden_size=192), "head dim"),                  # head dim 48
    (dict(num_heads=32, num_kv_heads=2, head_dim=16), "times Hkv"),  # group 16
    (dict(), "block size")])                              # pages of 128 tokens
def test_paged_engine_refuses_what_the_kernel_cannot_take(cuda, change, match):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), **change)
    block_size = 16 if change else 128
    with pytest.raises(ValueError, match=match):
        PagedLLMEngine(PagedLLMConfig(model_config=cfg, max_batch_size=2, max_seq_len=128,
                                      block_size=block_size), device=cuda)


# ---------------------------------------------------------------- PD, speculative decoding
PROMPTS = [[5, 9, 13, 2, 7], [3, 3, 8], list(range(1, 40))]


def _pd_tokens(cfg, params, device, block_size):
    """Prefill on one engine, attach and decode on another; (tokens, paged
    launches, decode steps)."""
    conf = PagedLLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=128,
                          block_size=block_size)
    prefiller = PagedLLMEngine(conf, params=_to(params, device), device=device)
    decoder = PagedLLMEngine(conf, params=_to(params, device), device=device)
    try:
        before = pa.launches
        handoffs = [prefiller.prefill_extract(p) for p in PROMPTS]
        futs = [decoder.attach_sequence(h, 12) for h in handoffs]
        tokens = [f.result(timeout=300).token_ids for f in futs]
        return tokens, pa.launches - before, decoder.stats()["decode_steps"]
    finally:
        prefiller.shutdown()
        decoder.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("block_size", [4, 16])
def test_tiny_pd_on_the_card_matches_the_cpu(cuda, block_size):
    """LlamaConfig.tiny() (float32): the handoff's decode half runs the paged
    kernel on the card at every step and gives the CPU pair's tokens."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    cpu_tokens, cpu_launches, _ = _pd_tokens(cfg, params, "cpu", block_size)
    tokens, launches, steps = _pd_tokens(cfg, params, cuda, block_size)
    assert cpu_launches == 0 and steps > 0 and launches == cfg.num_layers * steps
    assert tokens == cpu_tokens


def _spec_tokens(cfg, dcfg, params, draft, device, K, block_size=16):
    eng = SpecDecodeLLMEngine(
        SpecDecodeConfig(model_config=cfg, draft_model_config=dcfg, num_speculative_tokens=K,
                         max_batch_size=4, max_seq_len=128, block_size=block_size),
        params=_to(params, device), draft_params=_to(draft, device), device=device)
    try:
        before = pa.launches
        futs = [eng.generate(p, 12) for p in PROMPTS]
        tokens = [f.result(timeout=300).token_ids for f in futs]
        return tokens, pa.launches - before, eng.stats()
    finally:
        eng.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("same_draft", [False, True])
def test_tiny_spec_decode_on_the_card_matches_the_cpu(cuda, same_draft):
    """The draft's single-token decodes run the paged kernel on the card
    ((K - 1) x layers a verify step) and the tokens are the CPU's; with
    draft = target every proposal inside a request's budget is accepted."""
    cfg, K = llama.LlamaConfig.tiny(), 4
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    draft = params if same_draft else llama.init(cfg, torch.Generator().manual_seed(7), "cpu")
    cpu_tokens, cpu_launches, cpu_stats = _spec_tokens(cfg, cfg, params, draft, "cpu", K, 4)
    tokens, launches, stats = _spec_tokens(cfg, cfg, params, draft, cuda, K, 4)
    steps = stats["decode_steps"]
    assert cpu_launches == 0 and steps > 0 and launches == (K - 1) * cfg.num_layers * steps
    assert tokens == cpu_tokens
    if same_draft:
        assert stats["accepted_tokens"] == stats["proposed_tokens"] > 0
        assert cpu_stats["accepted_tokens"] == cpu_stats["proposed_tokens"]


@pytest.mark.gpu
def test_spec_decode_draft_runs_the_kernel_at_d64_group4(cuda):
    """A draft at Llama-3.2-1B's attention shape (head dim 64, 8 query heads
    a kv head pair, group 4), float32: the kernel at that shape on every
    draft decode, and the CPU engine's tokens."""
    dcfg = llama.LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                             num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                             max_seq_len=128, dtype=torch.float32, remat=False)
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    draft = llama.init(dcfg, torch.Generator().manual_seed(1), "cpu")
    cpu_tokens, _, _ = _spec_tokens(cfg, dcfg, params, draft, "cpu", 3)
    tokens, launches, stats = _spec_tokens(cfg, dcfg, params, draft, cuda, 3)
    assert launches == 2 * dcfg.num_layers * stats["decode_steps"] > 0
    assert tokens == cpu_tokens


@pytest.mark.gpu
def test_spec_engine_refuses_a_draft_the_kernel_cannot_take(cuda):
    dcfg = dataclasses.replace(llama.LlamaConfig.tiny(), hidden_size=192)  # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        SpecDecodeLLMEngine(SpecDecodeConfig(model_config=llama.LlamaConfig.tiny(),
                                             draft_model_config=dcfg, max_batch_size=2,
                                             max_seq_len=128), device=cuda)


@pytest.mark.gpu
def test_tiny_moe_and_vit_on_the_card_match_the_cpu(cuda):
    """MoEConfig.tiny() and ViTConfig.tiny() (float32): the card's logits are
    the CPU's to atol 2e-4, the MoE aux loss to rtol 1e-5."""
    mcfg, vcfg = moe.MoEConfig.tiny(), vit.ViTConfig.tiny()
    mparams = moe.init(mcfg, torch.Generator().manual_seed(0), "cpu")
    vparams = vit.init(vcfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, mcfg.base.vocab_size, (2, 64)))
    images = torch.from_numpy(rng.random((4, 32, 32, 3), np.float32))
    with torch.no_grad():
        logits, aux = moe.forward(mparams, tokens, mcfg)
        got, got_aux = moe.forward(_to(mparams, cuda), tokens.to(cuda), mcfg)
        torch.testing.assert_close(got.cpu(), logits, atol=2e-4, rtol=0.0)
        torch.testing.assert_close(got_aux.cpu(), aux, rtol=1e-5, atol=0.0)
        want = vit.forward(vparams, images, vcfg)
        got = vit.forward(_to(vparams, cuda), images.to(cuda), vcfg)
        torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=0.0)


# ---------------------------------------------------------------- flash attention
FLASH_F32_ATOL = 2e-5
FLASH_BF16_ROW_RTOL, FLASH_BF16_ROW_ATOL = 1e-2, 1e-4


def assert_flash_close(got, ref):
    got, want = got.float(), ref.float()
    if ref.dtype == torch.float32:
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=FLASH_F32_ATOL * scale, rtol=0.0)
        return
    err = torch.linalg.vector_norm(got - want, dim=-1)
    lim = FLASH_BF16_ROW_RTOL * torch.linalg.vector_norm(want, dim=-1) + FLASH_BF16_ROW_ATOL
    worst = (err / lim).max().item()
    print(f"bf16 flash rows: worst err / limit {worst:.4f}")  # shown with pytest -s
    assert worst <= 1.0, f"{int((err > lim).sum())} rows over the limit; worst err / limit {worst}"


def _flash_inputs(device, dtype, B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device).to(dtype)

    return t(B, S, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D), t(B, S, Hq, D)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 100, 8, 2, 64), (1, 1, 4, 4, 128),
                                          (2, 257, 4, 1, 128), (1, 1000, 8, 2, 64)] + [
    # the bf16 forward's 128-row q tile and 64-key k tile: S one under, at and
    # one over a q tile, and one under a long multiple; g 1 and 4, D 64 and 128
    (1, S, Hq, Hkv, D) for S in (127, 128, 129, 2047) for D in (64, 128)
    for Hq, Hkv in ((4, 4), (8, 2))])
def test_flash_kernels_match_plain(cuda, dtype, causal, B, S, Hq, Hkv, D):
    q, k, v, do = _flash_inputs(cuda, dtype, B, S, Hq, Hkv, D)
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0.0)
    # the backward kernels against their plain versions on the same inputs
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert_flash_close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, causal))
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta, causal)
    assert_flash_close(dk, dk_ref)
    assert_flash_close(dv, dv_ref)
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == tuple(
        n + 1 for n in before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 32])
def test_flash_kernels_read_strided_views(cuda, dtype, causal, D):
    """q, k and v as slices of one fused [B, S, Hq + 2 Hkv, D] projection,
    as a fused QKV matmul gives them: the kernels read them in place through
    their strides, and agree with the plain versions on contiguous copies."""
    B, S, Hq, Hkv = 2, 129, 8, 2
    qkv, do = _flash_inputs(cuda, dtype, B, S, Hq + 2 * Hkv, 1, D)[::3]
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    do = do[:, :, :Hq]
    for x in (q, k, v, do):
        assert not x.is_contiguous() and fa._strided(x) is x
    o, lse = fa.flash_fwd(q, k, v, causal)
    qc, kc, vc, doc = (x.contiguous() for x in (q, k, v, do))
    o_ref, lse_ref = fa.flash_fwd_ref(qc, kc, vc, causal)
    torch.cuda.synchronize()
    assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0.0)
    delta = (doc.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert_flash_close(dq, fa.flash_bwd_dq_ref(qc, kc, vc, doc, lse_ref, delta, causal))
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(qc, kc, vc, doc, lse_ref, delta, causal)
    assert_flash_close(dk, dk_ref)
    assert_flash_close(dv, dv_ref)


def _dkv_inputs(device, dtype, B, S, Hq, Hkv, D, causal):
    """q, k, v, dO and the plain forward's lse, with delta = rowsum(dO * O)."""
    q, k, v, do = _flash_inputs(device, dtype, B, S, Hq, Hkv, D)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse_ref, delta


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("S,D", [(63, 64), (65, 64), (191, 64), (31, 128), (33, 128),
                                 (95, 128)])
def test_flash_dkv_matches_plain_at_tile_edges(cuda, dtype, causal, Hq, Hkv, S, D):
    """dK/dV with g 1, 4 and 8 against its plain version, at S one under and
    one over the bf16 kernel's 64-key tile (D 64) and its 32-query tile
    (D 128)."""
    q, k, v, do, lse, delta = _dkv_inputs(cuda, dtype, 2, S, Hq, Hkv, D, causal)
    before = fa.bwd_dkv_launches
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert fa.bwd_dkv_launches == before + 1
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
    assert_flash_close(dk, dk_ref)
    assert_flash_close(dv, dv_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("S", [63, 65, 127, 129, 2047])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_dq_matches_plain_at_tile_edges(cuda, dtype, causal, Hq, Hkv, S, D):
    """dQ with g 1, 4 and 8 against its plain version, at S one under and
    one over the bf16 kernel's 64-row q tile and 64-key k tile, and one under
    a long multiple."""
    q, k, v, do, lse, delta = _dkv_inputs(cuda, dtype, 2, S, Hq, Hkv, D, causal)
    before = fa.bwd_dq_launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert fa.bwd_dq_launches == before + 1
    assert_flash_close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_dq_dead_query_rows(cuda, dtype, causal, D):
    """A query whose lse is NEG_INF (no live key) has P = 0 and a zero dQ
    row. The kernel agrees with the plain version; it gives exactly what it
    gives when those rows stay alive with dO and delta zeroed, whose dS is
    then exactly zero too; and with every query dead, dQ is exactly zero."""
    B, S, Hq, Hkv = 2, 150, 8, 2
    q, k, v, do, lse, delta = _dkv_inputs(cuda, dtype, B, S, Hq, Hkv, D, causal)
    dead = torch.zeros(B, Hq, S, dtype=torch.bool, device=cuda)
    dead[:, :, ::7] = True
    dead[0, 3] = True  # a whole query head
    dead_lse = lse.masked_fill(dead, fa.NEG_INF)
    dq = fa.flash_bwd_dq(q, k, v, do, dead_lse, delta, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(dq).all()
    assert_flash_close(dq, fa.flash_bwd_dq_ref(q, k, v, do, dead_lse, delta, causal))
    rows = dead.transpose(1, 2)[..., None]  # [B, S, Hq, 1]
    dq0 = fa.flash_bwd_dq(q, k, v, do.masked_fill(rows, 0), lse,
                          delta.masked_fill(dead, 0.0), causal)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq0)
    dq = fa.flash_bwd_dq(q, k, v, do, torch.full_like(lse, fa.NEG_INF), delta, causal)
    torch.cuda.synchronize()
    assert not dq.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 96])
def test_flash_kernels_take_padded_head_dims(cuda, dtype, causal, D):
    """Head dims the kernels are not built for run zero-padded to 64 or 128
    and sliced back, with the caller's scale: each of the three kernels
    against its plain version at the caller's D, and the forward's output
    keeps that D."""
    q, k, v, do = _flash_inputs(cuda, dtype, 2, 129, 8, 2, D)
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert o.shape == q.shape
    assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0.0)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert_flash_close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, causal))
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta, causal)
    assert_flash_close(dk, dk_ref)
    assert_flash_close(dv, dv_ref)
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == tuple(
        n + 1 for n in before)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_dkv_dead_query_rows(cuda, dtype, causal, D):
    """A query whose lse is NEG_INF (no live key) has P = 0 and adds nothing
    to dK or dV, as in the reference's ``_recompute_p``. The kernel agrees
    with the plain version; it gives exactly what it gives when those rows
    stay alive with dO and delta zeroed, which also add exact zeros; and with
    every query dead, dK and dV are exactly zero."""
    B, S, Hq, Hkv = 2, 150, 8, 2
    q, k, v, do, lse, delta = _dkv_inputs(cuda, dtype, B, S, Hq, Hkv, D, causal)
    dead = torch.zeros(B, Hq, S, dtype=torch.bool, device=cuda)
    dead[:, :, ::7] = True
    dead[0, 3] = True  # a whole query head
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse.masked_fill(dead, fa.NEG_INF), delta, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse.masked_fill(dead, fa.NEG_INF),
                                          delta, causal)
    assert_flash_close(dk, dk_ref)
    assert_flash_close(dv, dv_ref)
    rows = dead.transpose(1, 2)[..., None]  # [B, S, Hq, 1]
    dk0, dv0 = fa.flash_bwd_dkv(q, k, v, do.masked_fill(rows, 0), lse,
                                delta.masked_fill(dead, 0.0), causal)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, torch.full_like(lse, fa.NEG_INF), delta, causal)
    torch.cuda.synchronize()
    assert not dk.any() and not dv.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_through_function(cuda, dtype):
    """Autograd through _FlashAttention on the card against the plain forward
    and backward on the same inputs. The plain backward gets delta from the
    Function's own output, as the Function forms it: with delta from an O
    of another rounding, rows whose softmax is peaked (dQ, dK near zero by
    cancellation) differ by far more than the kernels do."""
    q, k, v, cot = _flash_inputs(cuda, dtype, 2, 300, 8, 2, 64, seed=1)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v)
    grads = torch.autograd.grad((out.float() * cot.float()).sum(), (q, k, v))
    q, k, v, out = (x.detach() for x in (q, k, v, out))
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, True)
    assert_flash_close(out, o_ref)
    delta = (cot.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    ref = (fa.flash_bwd_dq_ref(q, k, v, cot, lse_ref, delta, True),
           *fa.flash_bwd_dkv_ref(q, k, v, cot, lse_ref, delta, True))
    for got, want in zip(grads, ref):
        assert got.dtype == dtype
        assert_flash_close(got, want)


@pytest.mark.gpu
def test_flash_rejects_what_it_cannot_take(cuda):
    for D in (136, 20):  # past 128, not a multiple of 8
        q, k, v, _ = _flash_inputs(cuda, torch.float32, 1, 16, 2, 2, D)
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_fwd(q, k, v, True)
    q, k, v, _ = _flash_inputs(cuda, torch.float32, 1, 16, 2, 2, 64)
    with pytest.raises(TypeError, match="must be"):
        fa.flash_fwd(q, k.bfloat16(), v, True)


@pytest.mark.gpu
def test_train_step_goes_through_flash_kernels(cuda):
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=1024,
                            dtype=torch.bfloat16, remat=True)
    opt = spmd.make_optimizer(1e-3, warmup=1)
    state = spmd.init_state(cfg, torch.Generator(cuda).manual_seed(0), opt, device=cuda)
    step = spmd.make_train_step(cfg, opt, device=cuda)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1024))
    targets = np.concatenate([tokens[:, 1:], np.full((1, 1), -100)], axis=1)
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    losses = []
    for _ in range(3):
        state, m = step(state, tokens, targets)
        losses.append(m["loss"].item())
        assert np.isfinite(m["grad_norm"].item())
    L = cfg.num_layers
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (
        before[0] + 3 * 2 * L, before[1] + 3 * L, before[2] + 3 * L)
    assert state.step == 3 and losses[-1] < losses[0]
