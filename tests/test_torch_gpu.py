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
                                    (4, 128, 1), (2, 64, 12),
                                    # head dims 48/80/96/256, groups above 8, pages above 64
                                    (4, 48, 16), (2, 80, 16), (4, 96, 16), (4, 256, 16),
                                    (8, 256, 64), (16, 128, 16), (12, 64, 16), (32, 48, 8),
                                    (4, 128, 128), (2, 64, 96), (1, 256, 128),
                                    # head dims between the built ones: rows of 16-byte
                                    # chunks (40, 112, 200), of 8 or 4 bytes (36, 98),
                                    # odd bf16 rows of 2-byte pieces (37, 255, 1)
                                    (4, 40, 16), (4, 112, 16), (4, 200, 16), (4, 36, 16),
                                    (2, 98, 8), (4, 37, 16), (1, 255, 16), (8, 1, 4),
                                    (16, 40, 128)])
def test_paged_kernel_matches_plain(cuda, dtype, g, D, BS):
    """Ragged rows, a dead row, a full table of at least 128 pages, and rows
    one under, at and one over the edges of the first two splits."""
    sub = pa.sub_page_size(BS)  # a page above 64 tokens is read as sub-pages
    T = pa.pages_per_split(sub, D, dtype) * sub  # tokens a split takes
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
    q, k, v, tables, lengths = _paged_inputs(cuda, torch.float32, 2, 2, 2, 264, 8, 3, [3, 5])
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q, k, v, tables, lengths)
    q, k, v, tables, lengths = _paged_inputs(cuda, torch.float32, 2, 2, 2, 64, 8, 3, [3, 5])
    with pytest.raises(ValueError, match="times Hkv"):
        pa.paged_decode_attention(q[:, :3].contiguous(), k, v, tables, lengths)
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
    (dict(head_dim=264), "head dim"),                     # past 256
    (dict(num_heads=6, num_kv_heads=4), "times Hkv")])    # no whole group
def test_paged_engine_refuses_what_the_kernel_cannot_take(cuda, change, match):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), **change)
    with pytest.raises(ValueError, match=match):
        PagedLLMEngine(PagedLLMConfig(model_config=cfg, max_batch_size=2, max_seq_len=128,
                                      block_size=16), device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("change,block_size", [
    (dict(num_heads=16, num_kv_heads=1, head_dim=48), 96),   # group 16, pages of 96
    (dict(head_dim=256), 128),                               # head dim 256, pages of 128
    (dict(num_heads=8, num_kv_heads=2, head_dim=80), 16),
    (dict(hidden_size=160), 16),                              # head dim 40
    (dict(head_dim=36), 16), (dict(head_dim=200), 32), (dict(head_dim=42), 8)])
def test_wide_shape_paged_engine_on_the_card_matches_the_cpu(cuda, change, block_size):
    """Shapes the paged kernel now takes, on LlamaConfig.tiny() widths in
    float32: every decode step through the kernel on the card, the CPU
    engine's greedy tokens from the same weights."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), **change)
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [[5, 9, 13, 2, 7], [3, 3, 8], list(range(1, 40))]
    tokens = {}
    for device in ("cpu", cuda):
        eng = PagedLLMEngine(PagedLLMConfig(model_config=cfg, max_batch_size=4,
                                            max_seq_len=block_size * -(-128 // block_size),
                                            block_size=block_size),
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
    dcfg = dataclasses.replace(llama.LlamaConfig.tiny(), head_dim=264)  # past 256
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
@pytest.mark.parametrize("D", [16, 32, 96, 20, 100])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (2, 129, 8, 2, 256), (1, 1, 4, 4, 256), (1, 127, 4, 1, 256), (2, 33, 8, 8, 256),
    (1, 1000, 8, 2, 256), (1, 2047, 4, 2, 256),
    # zero-padded to 256: D 192 (the padded check the smoke runs), 136, 200
    (2, 129, 8, 2, 192), (1, 300, 4, 2, 136), (1, 65, 4, 4, 200)])
def test_flash_kernels_above_head_dim_128(cuda, dtype, causal, B, S, Hq, Hkv, D):
    """The D 256 kernels (bf16: two CTAs a head, each accumulating half of
    the output columns; float32: q tiles of 32) against their plain versions
    at S around the tiles' edges, g 1, 2, 4, and head dims padded to 256."""
    q, k, v, do = _flash_inputs(cuda, dtype, B, S, Hq, Hkv, D)
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
    assert_flash_close(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, causal))
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta, causal)
    assert_flash_close(dk, dk_ref)
    assert_flash_close(dv, dv_ref)
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == tuple(
        n + 1 for n in before)


@pytest.mark.gpu
def test_flash_rejects_what_it_cannot_take(cuda):
    for D in (264, 320):  # past 256
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


@pytest.mark.gpu
def test_head_dim_256_trains_through_flash_kernels(cuda):
    """A Gemma-style head dim (256) at S 1024: the config builds, three
    train steps go through the three kernels at their D 256 instantiations,
    and the loss and grad norm through them match dense attention's from
    the same parameters."""
    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=512, intermediate_size=1024,
                            num_layers=2, num_heads=2, num_kv_heads=1, head_dim=256,
                            max_seq_len=8192, dtype=torch.bfloat16, remat=True)
    opt = spmd.make_optimizer(1e-3, warmup=1)
    state = spmd.init_state(cfg, torch.Generator(cuda).manual_seed(0), opt, device=cuda)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1024))
    targets = np.concatenate([tokens[:, 1:], np.full((1, 1), -100)], axis=1)
    batch = (torch.from_numpy(tokens).to(cuda), torch.from_numpy(targets).to(cuda))
    losses = {}
    for label, attn_fn in (("flash", None), ("dense", llama.attention)):
        losses[label] = llama.loss_fn(state.params, *batch, cfg, attn_fn).item()
    assert abs(losses["flash"] - losses["dense"]) <= 1e-4 * abs(losses["dense"]), losses
    step = spmd.make_train_step(cfg, opt, device=cuda)
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    seen = []
    for _ in range(3):
        state, m = step(state, *batch)
        seen.append(m["loss"].item())
        assert np.isfinite(m["grad_norm"].item())
    L = cfg.num_layers
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (
        before[0] + 3 * 2 * L, before[1] + 3 * L, before[2] + 3 * L)
    assert seen[-1] < seen[0]


# RLlib learners (ray_tpu_torch.rllib) at the reference's default widths
# and batch sizes, CartPole's or Pendulum's shapes: (learner, config, batch
# size, (obs dim, actions or action dim))
def _rl_cases():
    from ray_tpu_torch import rllib

    return {"ppo": (rllib.PPOLearner, rllib.PPOConfig, 128, (4, 2)),
            "impala": (rllib.IMPALALearner, rllib.IMPALAConfig, 512, (4, 2)),
            "appo": (rllib.APPOLearner, rllib.APPOConfig, 256, (4, 2)),
            "dqn": (rllib.DQNLearner, rllib.DQNConfig, 64, (4, 2)),
            "sac": (rllib.SACLearner, rllib.SACConfig, 128, (4, 2)),
            "sac_continuous": (rllib.ContinuousSACLearner, rllib.ContinuousSACConfig, 256,
                               (3, 1)),
            "tqc": (rllib.TQCLearner, rllib.TQCConfig, 256, (3, 1))}


def _rl_batch(name, n, dims, seed):
    obs_dim, a = dims
    r = np.random.default_rng(seed)

    def normal(*shape):
        return r.normal(size=shape).astype(np.float32)

    obs = normal(n, obs_dim)
    if name in ("sac_continuous", "tqc"):
        return {"obs": obs, "actions": r.uniform(-1, 1, (n, a)).astype(np.float32),
                "rewards": normal(n), "next_obs": normal(n, obs_dim),
                "dones": (r.random(n) < 0.1).astype(np.float32)}
    actions = r.integers(0, a, n).astype(np.int32)
    if name == "ppo":
        return {"obs": obs, "actions": actions,
                "logprobs": np.log(r.uniform(0.2, 0.8, n)).astype(np.float32),
                "advantages": normal(n), "returns": normal(n)}
    if name in ("impala", "appo"):
        out = {"obs": obs, "actions": actions, "vs_targets": normal(n), "advantages": normal(n)}
        if name == "appo":
            out["behavior_logp"] = np.log(r.uniform(0.2, 0.8, n)).astype(np.float32)
        return out
    return {"obs": obs, "actions": actions, "rewards": normal(n), "next_obs": normal(n, obs_dim),
            "dones": (r.random(n) < 0.1).astype(np.float32)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ppo", "impala", "appo", "dqn", "sac", "sac_continuous",
                                  "tqc"])
def test_rllib_learner_on_card_matches_cpu(cuda, name):
    """Three updates of a learner made without a device (cuda:0) against
    one on the CPU from the same seed, on three batches: every update's
    loss and metrics within rtol 1e-5 / atol 1e-6, the parameters and
    targets within 5e-6 after them (both float32, matmuls without TF32; the
    limits tests/test_torch_rllib.py holds the port to against JAX)."""
    from ray_tpu_torch.rllib import optim
    from ray_tpu_torch.rllib.np_policy import to_numpy_params

    cls, cfg_cls, n, dims = _rl_cases()[name]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card, on_cpu = cls(cfg_cls(), *dims), cls(cfg_cls(), *dims, device="cpu")
        assert on_card.device == cuda
        for step in range(3):
            batch = _rl_batch(name, n, dims, step)
            got, want = on_card.update(batch), on_cpu.update(batch)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f"update {step} {k}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for attr in ("params", "target_params", "target"):
        if hasattr(on_cpu, attr):
            for a, b in zip(*(optim.tree_leaves(to_numpy_params(getattr(x, attr)))
                              for x in (on_card, on_cpu))):
                np.testing.assert_allclose(a, b, rtol=0, atol=5e-6, err_msg=attr)


@pytest.fixture
def world_one_nccl(cuda, tmp_path):
    """A world of one rank over NCCL (FileStore rendezvous), destroyed after."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import mesh as pmesh

    pmesh.initialize_distributed(store_path=str(tmp_path / "store"), rank=0, world_size=1)
    try:
        yield pmesh.make_mesh(1, data=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_world_one_mesh_step_matches_the_one_device_step(world_one_nccl, cuda, attn):
    """The mesh step on a one-rank NCCL mesh (every dim 1) against the
    one-device step from the same weights and batch, tiny config in
    float32: the same arithmetic (collectives on a dim of 1 are skipped),
    so loss and grad norm within rtol 1e-5 and parameters atol 1e-5 after
    three steps; with attn_fn = flash each of the three kernels runs L
    times a step (no remat in the tiny config), in both steps."""
    from ray_tpu_torch.parallel.mesh import mesh_shape

    cfg = llama.LlamaConfig.tiny()
    attn_fn = fa.flash_attention if attn == "flash" else None
    opt = spmd.make_optimizer(1e-3, warmup=1)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64))
    targets = np.concatenate([tokens[:, 1:], np.full((2, 1), -100)], axis=1)
    runs = {}
    for label in ("device", "mesh"):
        state = spmd.init_state(cfg, torch.Generator(cuda).manual_seed(0), opt, device=cuda)
        if label == "mesh":
            step = spmd.make_train_step(cfg, world_one_nccl, opt, attn_fn)(state)
        else:
            step = spmd.make_train_step(cfg, opt, attn_fn, device=cuda)
        before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        seen = []
        for _ in range(3):
            state, m = step(state, tokens, targets)
            seen.append((m["loss"].item(), m["grad_norm"].item()))
        launches = tuple(a - b for a, b in zip(
            (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches), before))
        params = spmd.leaves(state.params)
        runs[label] = (seen, [p.to_local() if hasattr(p, "to_local") else p for p in params],
                       launches)
    assert set(mesh_shape(world_one_nccl).values()) == {1}
    np.testing.assert_allclose(runs["mesh"][0], runs["device"][0], rtol=1e-5)
    for got, want in zip(runs["mesh"][1], runs["device"][1]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    L = cfg.num_layers
    assert not cfg.remat
    want = (3 * L, 3 * L, 3 * L) if attn == "flash" else (0, 0, 0)
    assert runs["mesh"][2] == runs["device"][2] == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_tile_math_matches_the_flash_forward(world_one_nccl, cuda, dtype):
    """Ring attention at a seq group of 1 (one float32 tile, no hop) against
    the flash forward on the same causal inputs, within the flash kernels'
    tolerance of their plain version (module doc)."""
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v, _ = _flash_inputs(cuda, dtype, 2, 300, 8, 2, 64)
    got = ring_attention(q, k, v, world_one_nccl, seq_axis="seq")
    want = fa.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_world_one_pp_step_matches_the_one_device_step(world_one_nccl, cuda, attn):
    """The GPipe step (parallel.pipeline) on a one-rank NCCL mesh (pipe 1)
    in 2 microbatches against the one-device step from the same weights
    and batch, tiny config in float32: the same arithmetic but for the
    microbatch split, so loss and grad norm within rtol 1e-5 and
    parameters atol 5e-5 after three steps at lr 1e-3 (the split sums each
    gradient in another order, and Adam turns that into parameter gaps
    where a gradient is near zero: one element of the embedding read
    1.17e-5 and one of a layer 1.22e-5 on the H100; the mesh step, the
    same sums, holds 1e-5); with attn_fn = flash each of the three kernels
    runs L times a microbatch (no remat), 2 L a step."""
    from ray_tpu_torch.parallel import pipeline

    cfg = llama.LlamaConfig.tiny()
    attn_fn = fa.flash_attention if attn == "flash" else None
    opt = spmd.make_optimizer(1e-3, warmup=1)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64))
    targets = np.concatenate([tokens[:, 1:], np.full((4, 1), -100)], axis=1)
    runs = {}
    for label in ("device", "pipeline"):
        state = spmd.init_state(cfg, torch.Generator(cuda).manual_seed(0), opt, device=cuda)
        if label == "pipeline":
            step = pipeline.make_pp_train_step(cfg, world_one_nccl, 2, opt, attn_fn)(state)
        else:
            step = spmd.make_train_step(cfg, opt, attn_fn, device=cuda)
        before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        seen = []
        for _ in range(3):
            state, m = step(state, tokens, targets)
            seen.append((m["loss"].item(), m["grad_norm"].item()))
        launches = tuple(a - b for a, b in zip(
            (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches), before))
        params = spmd.leaves(state.params)  # the order of llama.init's tree in both
        runs[label] = (seen, [p.to_local() if hasattr(p, "to_local") else p for p in params],
                       launches)
    np.testing.assert_allclose(runs["pipeline"][0], runs["device"][0], rtol=1e-5)
    for got, want in zip(runs["pipeline"][1], runs["device"][1]):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=0)
    L = cfg.num_layers
    want = {"device": (3 * L,) * 3, "pipeline": (6 * L,) * 3} if attn == "flash" else {
        "device": (0, 0, 0), "pipeline": (0, 0, 0)}
    assert {k: r[2] for k, r in runs.items()} == want


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bc", "marwil", "cql", "iql"])
def test_offline_algorithm_on_card_matches_cpu(cuda, name):
    """An offline algorithm built without a device (cuda:0) against one on
    the CPU from the same seed and dataset (CartPole's shapes, or
    Pendulum's for IQL): ``train(3)`` draws the same minibatches on both,
    the last update's metrics within rtol 1e-5 / atol 1e-6 and the
    parameters and targets within 5e-6 (float32, matmuls without TF32; the
    limits of the online learners' card test)."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import optim
    from ray_tpu_torch.rllib.np_policy import to_numpy_params

    r = np.random.default_rng(0)
    obs_dim = 3 if name == "iql" else 4
    data = {"obs": r.normal(size=(500, obs_dim)).astype(np.float32),
            "actions": (r.uniform(-1, 1, (500, 1)).astype(np.float32) if name == "iql"
                        else r.integers(0, 2, 500)),
            "rewards": r.normal(size=500).astype(np.float32),
            "next_obs": r.normal(size=(500, obs_dim)).astype(np.float32),
            "dones": (r.random(500) < 0.1).astype(np.float32)}
    cfg_cls = {"bc": rllib.BCConfig, "marwil": rllib.MARWILConfig,
               "cql": rllib.CQLConfig, "iql": rllib.IQLConfig}[name]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        on_card = cfg_cls(target_update_freq=2) if name == "cql" else cfg_cls()
        on_card = on_card.offline_data(data).build()
        on_cpu = cfg_cls(target_update_freq=2) if name == "cql" else cfg_cls()
        on_cpu = on_cpu.offline_data(data).build(device="cpu")
        assert on_card.device == cuda
        got, want = on_card.train(3), on_cpu.train(3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for attr in ("params", "target_params", "target"):
        if hasattr(on_cpu, attr):
            for a, b in zip(*(optim.tree_leaves(to_numpy_params(getattr(x, attr)))
                              for x in (on_card, on_cpu))):
                np.testing.assert_allclose(a, b, rtol=0, atol=5e-6, err_msg=attr)


@pytest.fixture
def no_tf32(cuda):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield cuda
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


class _CueGame:
    """Two agents, each shown a +/-1 cue and rewarded 1 for the matching
    action; shared episodes of 16 steps (tests/test_rllib_offline.py's
    _TargetGame)."""

    possible_agents = ["a0", "a1"]

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.t, self.cues = 0, {}

    def _obs(self):
        self.cues = {a: int(self.rng.integers(2)) for a in self.possible_agents}
        return {a: np.asarray([1.0 if c else -1.0, 1.0], np.float32)
                for a, c in self.cues.items()}

    def reset(self, seed=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action_dict):
        rews = {a: float(action_dict[a] == self.cues[a]) for a in self.possible_agents}
        self.t += 1
        return self._obs(), rews, {"__all__": self.t >= 16}, {"__all__": False}, {}


@pytest.mark.gpu
def test_multi_agent_ppo_on_card_matches_cpu(no_tf32, monkeypatch):
    """MultiAgentPPO made without a device (cuda:0) and on the CPU, one env
    runner each, two policies: two train() calls give the same episodes to
    both (numpy runners, the same initial weights), and the learners' metrics
    within rtol 1e-5 / atol 1e-6 and parameters within 5e-6.
    ``minibatch_sgd``'s unseeded ``default_rng()`` is seeded alike."""
    import ray_tpu_torch
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import optim
    from ray_tpu_torch.rllib.np_policy import to_numpy_params

    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(7 if seed is None else seed))

    def build(device):
        return rllib.MultiAgentPPOConfig(num_env_runners=1, rollout_fragment_length=128) \
            .environment(_CueGame).multi_agent(policies={"p0": (2, 2), "p1": (2, 2)},
                                               policy_mapping={"a0": "p0", "a1": "p1"}) \
            .build(device=device)

    ray_tpu_torch.init()
    try:
        algos = {"card": build(None), "cpu": build("cpu")}
        try:
            assert all(ln.device == no_tf32 for ln in algos["card"].learners.values())
            outs = {k: [a.train() for _ in range(2)] for k, a in algos.items()}
        finally:
            for a in algos.values():
                a.stop()
    finally:
        ray_tpu_torch.shutdown()
    for got, want in zip(outs["card"], outs["cpu"]):
        assert got["episode_reward_mean"] == want["episode_reward_mean"]
        for pid, metrics in want["policies"].items():
            for k, v in metrics.items():
                np.testing.assert_allclose(got["policies"][pid][k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{pid} {k}")
    for pid in ("p0", "p1"):
        for a, b in zip(*(optim.tree_leaves(to_numpy_params(algos[k].learners[pid].params))
                          for k in ("card", "cpu"))):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-6, err_msg=pid)


class _NumpyCartPole:
    """CartPole-v1 in numpy (gymnasium's dynamics; the card machine has no
    gymnasium)."""

    observation_space = type("Space", (), {"shape": (4,)})
    action_space = type("Space", (), {"n": 2})

    def reset(self, seed=None):
        self.rng = np.random.default_rng(seed)
        self.state, self.t = self.rng.uniform(-0.05, 0.05, 4), 0
        return self.state.astype(np.float32), {}

    def step(self, action):
        import math

        x, x_dot, th, th_dot = self.state
        force = 10.0 if action == 1 else -10.0
        cos, sin = math.cos(th), math.sin(th)
        temp = (force + 0.05 * th_dot ** 2 * sin) / 1.1
        th_acc = (9.8 * sin - cos * temp) / (0.5 * (4.0 / 3.0 - 0.1 * cos ** 2 / 1.1))
        x_acc = temp - 0.05 * th_acc * cos / 1.1
        self.state = np.array([x + 0.02 * x_dot, x_dot + 0.02 * x_acc,
                               th + 0.02 * th_dot, th_dot + 0.02 * th_acc])
        self.t += 1
        terminated = bool(abs(self.state[0]) > 2.4 or abs(self.state[2]) > 0.2095)
        return self.state.astype(np.float32), 1.0, terminated, self.t >= 500, {}

    def close(self):
        pass


@pytest.mark.gpu
def test_dreamerv3_updates_on_card_match_cpu(no_tf32):
    """DreamerV3 at the reference test's cut config, made without a device
    (cuda:0) and on the CPU from the same weights: one world-model and one
    actor-critic update on the same batch and Gumbel noise draw the same
    one-hots, the world-model metrics and imagined return within rtol 1e-4
    (the recurrence's limit against JAX), the rest within rtol 1e-5, and the
    three trees within 5e-6. The noise seed moves on until every CPU draw's
    top-2 margin exceeds 1e-5 (a closer draw may part on rounding alone)."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import dreamerv3 as d3
    from ray_tpu_torch.rllib import optim
    from ray_tpu_torch.rllib.np_policy import to_numpy_params

    cut = dict(batch_size=4, batch_length=12, horizon=5, deter_dim=32, hidden=32,
               stoch_groups=4, stoch_classes=4, collect_episodes=2, max_episode_len=60)
    on_cpu = rllib.DreamerV3Config(env=_NumpyCartPole).training(**cut).build(device="cpu")
    on_card = rllib.DreamerV3Config(env=_NumpyCartPole).training(**cut).build()
    assert on_card.device == no_tf32
    start = [to_numpy_params(t) for t in (on_cpu.wm, on_cpu.actor, on_cpu.critic)]
    on_cpu._collect()
    batch = on_cpu._sample_batch()
    n, categorical = 4 * 12, d3.categorical

    def run(algo, seed):
        gen = torch.Generator().manual_seed(seed)
        noise = (d3.gumbel((12, 4, 4, 4), gen, "cpu"), d3.gumbel((5, n, 2), gen, "cpu"),
                 d3.gumbel((5, n, 4, 4), gen, "cpu"))
        algo.from_jax(*start)
        draws, margins = [], []

        def draw(logits, g):
            top2 = torch.topk((g + logits).detach(), 2, dim=-1).values
            margins.append(float((top2[..., 0] - top2[..., 1]).min()))
            draws.append(categorical(logits, g).cpu())
            return draws[-1].to(logits.device)

        d3.categorical = draw
        try:
            aux = algo.wm_update(batch, noise[0])
            hs, zs = aux.pop("hs"), aux.pop("zs")
            aux.update(algo.ac_update(hs.reshape(n, -1), zs.reshape(n, -1), *noise[1:]))
        finally:
            d3.categorical = categorical
        return {k: float(v) for k, v in aux.items()}, draws, min(margins)

    seed = next(s for s in range(10) if run(on_cpu, s)[2] > 1e-5)
    want, cpu_draws, _ = run(on_cpu, seed)
    got, card_draws, _ = run(on_card, seed)
    assert len(card_draws) == 22 and all(torch.equal(a, b) for a, b in zip(card_draws, cpu_draws))
    assert set(got) == set(want)
    for k in want:
        tol = dict(rtol=1e-5, atol=1e-6) if k == "critic_loss" else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)
    for what in ("wm", "actor", "critic"):
        for a, b in zip(*(optim.tree_leaves(to_numpy_params(getattr(x, what)))
                          for x in (on_card, on_cpu))):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-6, err_msg=what)
    out = on_card.train()  # collect on the card, then both updates
    assert all(np.isfinite(v) for v in out.values()) and out["buffer_episodes"] == 2


@pytest.mark.gpu
def test_tune_trials_on_card_match_cpu(cuda):
    """A Tuner with ASHA over 3 PPO learners made without a device (cuda:0),
    one trial at a time, each waiting for the scheduler's decision on every
    report: the trials' states and metric histories equal those of the same
    run with CPU learners (metrics within rtol 1e-5 / atol 1e-6), and ASHA
    stops at least one."""
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import rllib, tune
    from ray_tpu_torch.train import report

    batch = _rl_batch("ppo", 128, (4, 2), 0)

    class StepASHA(tune.ASHAScheduler):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.cv, self.lr_of, self.decisions = threading.Condition(), {}, {}

        def record_config(self, trial_id, config):
            self.lr_of[trial_id] = config["lr"]

        def on_result(self, trial_id, result):
            decision = super().on_result(trial_id, result)
            with self.cv:
                self.decisions.setdefault(self.lr_of[trial_id], []).append(decision)
                self.cv.notify_all()
            return decision

    def trainable(config):
        sched = config["scheduler"]
        learner = rllib.PPOLearner(rllib.PPOConfig(lr=config["lr"]), 4, 2,
                                   device=config["device"])
        for i in range(1, 5):
            report({"loss": learner.update(batch)["total_loss"]})
            with sched.cv:
                assert sched.cv.wait_for(lambda: len(sched.decisions.get(config["lr"], ())) >= i,
                                         timeout=60)
                if sched.decisions[config["lr"]][-1] == "STOP":
                    return

    def fit(device):
        sched = StepASHA(metric="loss", mode="min", grace_period=1, reduction_factor=2, max_t=4)
        return tune.Tuner(trainable, param_space={"lr": tune.grid_search([3e-3, 1e-3, 3e-4]),
                                                  "device": device, "scheduler": sched},
                          tune_config=tune.TuneConfig(scheduler=sched,
                                                      max_concurrent_trials=1)).fit()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ray_tpu_torch.init()
    try:
        on_card, on_cpu = fit(None), fit("cpu")
    finally:
        ray_tpu_torch.shutdown()
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert [r.state for r in on_card] == [r.state for r in on_cpu]
    assert all(r.error is None for r in on_card)
    for got, want in zip(on_card, on_cpu):
        assert len(got.metrics_history) == len(want.metrics_history)
        for g, w in zip(got.metrics_history, want.metrics_history):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, atol=1e-6)
    assert any(len(r.metrics_history) < 4 for r in on_card)
