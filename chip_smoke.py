"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: the card's name, count, and nvidia-smi's name and power limit.
2. Build: every kernel source under ray_tpu_torch/csrc, one nvcc each, in
   parallel; build seconds and ptxas's registers / shared memory.
3. Kernels: each kernel against its plain PyTorch version at the main
   path's shapes (bf16 and float32), then timed with CUDA events (L2 flushed
   before every launch) beside the plain version, one library call computing
   the same function, and the least time the card could take (bound).
4. Main path: a PagedLLMEngine serving Llama-3-8B at full width and depth
   (random weights from a seed) answers 8 concurrent requests; the kernel
   launch counters are zeroed just before and read just after, and every
   decode step of every layer must have gone through the kernel. Then one
   decode step through forward_paged on the gather path and on the kernel
   path, from copies of the same pool, must agree.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {...}}. Exits non-zero, before any result, without a
CUDA device; any failed check raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine

SEED = 0
DEVICE = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per data sheet
# kernel vs plain version: both compute in float32; bf16 rounds the output once
TOL = {torch.float32: dict(atol=2e-5, rtol=0.0), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}

# main path: Llama-3-8B serving shapes
BATCH, MAX_SEQ, BLOCK = 8, 2048, 16
NEW_TOKENS = 32
KERNEL_LENGTHS = [1, 37, 300, 555, 1024, 1031, 1999, 2048]  # ragged, 1, full table
LOGIT_REL_TOL = 5e-2  # gather path casts probs to bf16 before PV, the kernel keeps f32


def log(card: str, what: str, **numbers) -> None:
    print(json.dumps({"what": what, **numbers, "card": card}), flush=True)


def time_ms(fn, flush: torch.Tensor, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of one call, with the L2 cache flushed before each."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_phase() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return name, smi


def build_phase(card: str) -> None:
    t0 = time.monotonic()
    report = _build.build_all()
    log(card, "build", seconds=time.monotonic() - t0,
        nvcc_seconds={n: r["seconds"] for n, r in report.items()},
        cached=[n for n, r in report.items() if r["cached"]])
    for name, info in report.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)


def paged_inputs(dtype, cfg: llama.LlamaConfig, lengths, seed: int):
    rng = np.random.default_rng(seed)
    B, max_blocks = len(lengths), MAX_SEQ // BLOCK
    NB = B * max_blocks + 1
    tables = rng.permutation(np.arange(1, NB)).reshape(B, max_blocks).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(DEVICE)

    hkv, hd = cfg.num_kv_heads, cfg.hd
    return (t(rng.standard_normal((B, cfg.num_heads, hd), np.float32)).to(dtype),
            t(rng.standard_normal((hkv, NB, BLOCK, hd), np.float32)).to(dtype),
            t(rng.standard_normal((hkv, NB, BLOCK, hd), np.float32)).to(dtype),
            t(tables), t(np.asarray(lengths, np.int32)))


def paged_bound(args) -> tuple[float, str]:
    """Least time for this call: each needed input byte read once, each output
    byte written once, against the operations at the peak rate for the type."""
    q, k, _, tables, lengths = args
    B, Hq, D = q.shape
    Hkv, _, BS, _ = k.shape
    lens = lengths.cpu().numpy().astype(np.int64)
    item = q.element_size()
    pages = int(np.minimum(-(-lens // BS), tables.shape[1]).sum())
    nbytes = (int(lens.sum()) * Hkv * D * 2 * item   # K and V of the live tokens
              + 2 * B * Hq * D * item                 # q in, out
              + pages * 4 + B * 4)                    # table entries used, lengths
    ops = 4 * Hq * D * int(lens.sum())                # QK and PV products
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_call(args):
    """The library yardstick: SDPA over a pre-gathered contiguous KV with the
    length mask (the gather is done here, outside the timed call)."""
    q, k, v, tables, lengths = args
    B, Hq, D = q.shape
    Hkv, _, BS, _ = k.shape
    L = tables.shape[1] * BS
    kc = k[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(B, Hkv, L, D).contiguous()
    vc = v[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(B, Hkv, L, D).contiguous()
    mask = (torch.arange(L, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask, enable_gqa=True)


def kernel_phase(card: str, cfg: llama.LlamaConfig) -> dict:
    """Check the kernel on a ragged set (length 1, non-multiples of the page,
    a full table) and on the main path's mid-decode lengths, in bf16 and
    float32; time it at both, the main path's numbers going to the line."""
    main_lengths = [len(p) + NEW_TOKENS // 2 for p in prompts(cfg)]
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in errs:
        for lengths in (KERNEL_LENGTHS, main_lengths):
            args = paged_inputs(dtype, cfg, lengths, SEED)
            got = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = pa.paged_decode_attention_ref(*args)
            torch.testing.assert_close(got, ref, **TOL[dtype])
            assert torch.isfinite(got).all()
            err = (got.float() - ref.float()).abs().max().item()
            errs[dtype] = max(errs[dtype], err)
            log(card, "paged_decode_attention check", dtype=str(dtype), lengths=lengths,
                max_abs_err=err, tol=TOL[dtype])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    timed = {}
    for label, lengths in (("main path", main_lengths), ("ragged, full table", KERNEL_LENGTHS)):
        args = paged_inputs(torch.bfloat16, cfg, lengths, SEED)
        lib = sdpa_call(args)
        lib_err = (lib()[:, :, 0].float() - pa.paged_decode_attention_ref(*args).float())
        t = {"kernel_ms": time_ms(lambda: pa.paged_decode_attention(*args), flush),
             "plain_ms": time_ms(lambda: pa.paged_decode_attention_ref(*args), flush),
             "library_ms": time_ms(lib, flush),
             "kernel_ms_repeat": time_ms(lambda: pa.paged_decode_attention(*args), flush)}
        t["bound_ms"], t["bound_by"] = paged_bound(args)
        log(card, f"paged_decode_attention timing ({label})", lengths=lengths, dtype="bf16",
            library_max_abs_err=lib_err.abs().max().item(), **t,
            shapes=dict(B=len(lengths), Hq=cfg.num_heads, Hkv=cfg.num_kv_heads, D=cfg.hd,
                        BS=BLOCK, max_blocks=MAX_SEQ // BLOCK))
        timed[label] = t
    t = timed["main path"]
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:31",
        "tpu_kernel": "ray_tpu/ops/paged_attention.py::_decode_kernel",
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_bf16": errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32],
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }


def prompts(cfg: llama.LlamaConfig) -> list[list[int]]:
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(0, cfg.vocab_size, 256).tolist()
    lens = [20, 75, 140, 233, 390, 600]
    out = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    out += [shared + rng.integers(0, cfg.vocab_size, n).tolist() for n in (44, 301)]
    return out  # 8 prompts, 20..557 tokens; the last two share 256 tokens


def main_path_phase(card: str, cfg: llama.LlamaConfig) -> tuple[dict, int]:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = PagedLLMEngine(
        PagedLLMConfig(model_config=cfg, max_batch_size=BATCH, max_seq_len=MAX_SEQ,
                       block_size=BLOCK, prefill_buckets=(32, 64, 128, 256, 512, 1024)),
        seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    reqs = prompts(cfg)
    try:
        pa.launches = 0  # count only the main path's launches
        t1 = time.monotonic()
        futs = [eng.generate(p, NEW_TOKENS) for p in reqs]
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t1
        launches = pa.launches
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert all(r.num_generated == NEW_TOKENS for r in results), [r.num_generated for r in results]
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.token_ids)
    assert stats["prefix_hits"] >= 1, stats
    steps = stats["decode_steps"]
    assert steps > 0 and launches == cfg.num_layers * steps, (launches, steps)
    ttft = sorted(r.ttft_s for r in results)
    decode_window = max(r.total_s for r in results) - max(r.ttft_s for r in results)
    decode_tokens = sum(r.num_generated - 1 for r in results)
    log(card, "main path: Llama-3-8B PagedLLMEngine",
        layers=cfg.num_layers, requests=len(reqs), prompt_tokens=[len(p) for p in reqs],
        new_tokens=NEW_TOKENS, decode_steps=steps, paged_decode_launches=launches,
        prefix_hits=stats["prefix_hits"], init_s=t_init, wall_s=wall,
        ttft_p50_ms=1e3 * statistics.median(ttft), ttft_max_ms=1e3 * ttft[-1],
        decode_tokens_per_s=decode_tokens / decode_window,
        decode_step_ms=1e3 * decode_window / max(steps - 1, 1),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        kv_pool_gb=eng.kv_memory_bytes() / 1e9)
    return eng.params, launches


def decode_agreement_phase(card: str, cfg: llama.LlamaConfig, params) -> None:
    """One decode step through forward_paged from copies of the same pool:
    the gather path (plain attention) against the kernel path."""
    rng = np.random.default_rng(SEED + 2)
    lens = np.asarray([1, 17, 100, 255, 256, 300, 511, 600], np.int32)
    max_blocks = MAX_SEQ // BLOCK
    nb = BATCH * max_blocks + 1
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(
        BATCH, max_blocks).astype(np.int32)).to(DEVICE)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, int(lens.max())))
                              .astype(np.int32)).to(DEVICE)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BATCH, 1)).astype(np.int32))
    tok = tok.to(DEVICE)
    lengths = torch.from_numpy(lens).to(DEVICE)
    pool = llama.init_kv_pool(cfg, nb, BLOCK, DEVICE)
    # padded tails past each row's length are written too, and masked later
    llama.forward_paged(params, prompt, cfg, pool, tables,
                        torch.zeros(BATCH, dtype=torch.int32, device=DEVICE), BLOCK)
    pool_b = {"k": pool["k"].clone(), "v": pool["v"].clone()}
    gather, _ = llama.forward_paged(params, tok, cfg, pool, tables, lengths, BLOCK,
                                    use_kernel=False)
    before = pa.launches
    kernel, _ = llama.forward_paged(params, tok, cfg, pool_b, tables, lengths, BLOCK,
                                    use_kernel=True)
    torch.cuda.synchronize()
    assert pa.launches - before == cfg.num_layers
    assert gather.shape == kernel.shape == (BATCH, 1, cfg.vocab_size)
    assert torch.isfinite(kernel).all() and torch.isfinite(gather).all()
    diff = (kernel - gather).abs().max().item()
    rel = diff / gather.abs().max().item()
    g, k = gather[:, 0], kernel[:, 0]
    top_g, top_k = g.argmax(-1), k.argmax(-1)
    same = (top_g == top_k)
    # a row may differ only where the gather path's own top two are tied
    # within the measured difference
    margin = g.max(-1).values - g.gather(1, top_k[:, None])[:, 0]
    assert bool((same | (margin <= 2 * diff)).all()), (top_g.tolist(), top_k.tolist())
    assert rel <= LOGIT_REL_TOL, rel
    log(card, "forward_paged decode: kernel path vs gather path", lengths=lens.tolist(),
        top1_agree=int(same.sum()), rows=BATCH, max_abs_diff=diff, rel_diff=rel,
        rel_tol=LOGIT_REL_TOL)
    profile_decode(card, lambda: llama.forward_paged(params, tok, cfg, pool_b, tables,
                                                     lengths, BLOCK))


def profile_decode(card: str, step, steps: int = 5) -> None:
    """Where a batch-8 decode step's time goes: host wall per step, device busy
    time per step from torch.profiler, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    log(card, "decode step breakdown (forward_paged, batch 8, kernel path)",
        wall_ms=wall_ms, device_busy_ms=busy_ms if dev else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if dev else "not measured",
        device_launches_per_step=sum(e.count for e in dev) / steps,
        top=[{"name": e.key[:70], "ms_per_step": e.self_device_time_total / 1e3 / steps,
              "calls_per_step": e.count / steps} for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    name, smi = device_phase()
    card = smi
    build_phase(card)
    cfg = llama.LlamaConfig.llama_8b()
    kernels = [kernel_phase(card, cfg)]
    params, kernels[0]["launches"] = main_path_phase(card, cfg)
    decode_agreement_phase(card, cfg, params)
    log(card, "smoke wall", seconds=time.monotonic() - t_start,
        param_count=llama.param_count_analytic(cfg))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
