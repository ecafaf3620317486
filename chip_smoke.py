"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device: the card's name, count, and nvidia-smi's name and power limit.
2. Build: every kernel source under ray_tpu_torch/csrc, one nvcc each, in
   parallel; build seconds, each kernel's registers and spill bytes from
   ptxas, and the bf16 forward's, dQ's and dK/dV's dynamic shared memory.
   None of the three bf16 kernels may spill at head dim 64, and neither
   paged kernel (the split pass, at every group it is built for, and the
   combine) at head dim 128 in bf16.
3. Kernels: each kernel against its plain PyTorch version at the main
   path's shapes (bf16 and float32), then timed with CUDA events (L2 flushed
   before every launch) beside the plain version, one library call computing
   the same function, and the least time the card could take (bound). The
   paged kernel is also checked at lengths one under, at and one over the
   edges of its splits, and its time is split between its two launches
   (split pass, combine) by torch.profiler.
4. Serving path: a PagedLLMEngine serving Llama-3-8B at full width and
   depth (random weights from a seed) answers 8 concurrent requests; the
   paged kernel's launch counter is zeroed just before and read just after,
   and every decode step of every layer must have gone through the kernel.
   Then the same engine on the same weights behind the port's serve control
   plane: ray_tpu_torch.init(), serve.run(build_openai_app(...)) and the
   HTTP proxy on a free port. Three completions one at a time must give the
   bytes of a PagedLLMEngine called directly with the same ids; then 8
   requests at once (5 completions, 2 chats, 1 SSE chat stream) must each
   give 32 tokens, the stream the text of the same body sent after them,
   with every decode step of the replica's engine through the paged kernel;
   the stream's time to its first frame, request walls, requests/s, tokens/s
   and the ingress's share of a request are logged. LlamaConfig.tiny()
   served the same way on the card and on the CPU gives the same text.
   Then one decode step through forward_paged on the gather path and on the
   kernel path, from copies of the same pool, must agree, and a profile of
   that decode step, naming both paged launches. Then LlamaConfig.tiny()
   (head dim 16, float32) served at block size 4 by an engine on the card
   and one on the CPU from the same weights: every decode step through the
   kernel, the same greedy tokens.
   Then, on the same Llama-3-8B weights: prefill/decode disaggregation (a
   prefill engine extracts three prompts' KV pages to the host, a second
   engine attaches and decodes them through the paged kernel; the handoff's
   bytes and copy times), and speculative decoding (K 4, the 8 requests)
   with a random Llama-3.2-1B draft, then draft = target on a 1B target. The
   paged kernel's launches are counted on each path (the draft's
   single-token decodes: (K - 1) x 16 layers a verify step), and the tokens
   must be the plain engine's, or part from them first at a near-tie within
   twice the kernel-vs-gather logit difference. Then the paged pair at the
   draft's shape (D 64, group 4) against its plain version, and timed.
5. Flash kernels: forward, dQ and dK/dV each against its plain version
   (bf16 and float32; causal and not; GQA 1 and 4 at head dim 64 and 128,
   and at 16 and 96, which the wrappers zero-pad to 64 and 128; ragged S 1,
   33, 95, 100, 127, 129, 1000, 2047, 2048), then timed at the trainer's
   shapes beside the plain version, SDPA and the bound, with the achieved
   TFLOP/s and the share of the bound.
6. Training path: Llama-3.2-1B at full width and depth (bf16, remat "full",
   random weights from a seed) takes 5 AdamW steps on one [4, 2048] batch;
   the three flash counters are zeroed just before and read just after, and
   each step must have launched the forward 2 L times (remat runs it again)
   and each backward kernel L times. Then loss and gradient norm through the
   flash kernels against dense attention from the same parameters; the loss
   and the wq/wk/wv gradients through the kernels against plain float32
   attention at the initial parameters and after the 5 steps; and a profile
   of one train step.
7. Other model families: MoE at Mixtral-8x7B widths cut to 4 of its 32
   layers (B 1 x S 2048) and ViT-L/16 whole (batch 64), each loss_fn and its
   backward in bf16, timed, with the gap to a float32 copy of the same
   weights; the MoE's share of (token, choice) pairs that capacity drops.
   Then the tiny float32 configs on the card against the CPU: PD and
   speculative decoding give the CPU's tokens exactly, MoE and ViT its
   logits to 2e-4.

Prints the kernels' JSON line, then as its last line
{"ok": true, "device": {...}}. Exits non-zero, before any result, without a
CUDA device; any failed check raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch import serve as rt_serve
from ray_tpu_torch.models import llama, moe, vit
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.serve.llm_paged import PagedLLMConfig, PagedLLMEngine
from ray_tpu_torch.serve.openai_api import ByteTokenizer
from ray_tpu_torch.serve.spec_decode import SpecDecodeConfig, SpecDecodeLLMEngine
from ray_tpu_torch.train import spmd

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

# training path: Llama-3.2-1B, B 4 x S 2048
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5
# flash checks: (B, S, Hq, Hkv, D); GQA 4 at D 64 as the trainer has it, ragged S
# (1, 100 and 1000 are not multiples of the 64-row tile; 127 and 129 sit one
# under and one over the bf16 forward's 128-row tile and around two bf16
# dK/dV k tiles of 64 keys; 33 and 95 sit one over and one under that
# kernel's 32-query tile at D 128), g 1, four D 128 cases, and head dims 16
# and 96, which the wrappers zero-pad to the kernels' 64 and 128
FLASH_SHAPES = [(2, 1, 8, 2, 64), (2, 100, 8, 2, 64), (2, 127, 8, 2, 64), (2, 129, 8, 8, 64),
                (2, 1000, 8, 2, 64), (1, 2048, 32, 8, 64), (2, 33, 8, 8, 128),
                (2, 95, 8, 2, 128), (1, 1000, 8, 2, 128), (1, 2047, 8, 2, 128),
                (2, 129, 4, 2, 16), (2, 1000, 8, 2, 96)]
# flash kernel vs plain. float32: both sides float32, sums reordered; atol
# 2e-5 * max(1, max |plain|) elementwise. bf16: the kernel rounds P and dS to
# bf16 (relative error up to 2^-9 each) before its tensor-core products, the
# plain version keeps them float32, and both round the output to bf16. The
# outputs are averages whose size falls along the sequence, so the bf16 check
# is per row (the last dim, D, at each batch, position and head):
# |got - plain| <= 1e-2 |plain| + 1e-4 in the 2-norm, five bf16 ulps; the
# H100 gave at most 5.6e-3. The 1e-4 floor is for rows that are zero in
# exact arithmetic (dQ of the first row when causal).
# lse is float32 on both sides (values up to ~log S + max).
FLASH_F32_ATOL = 2e-5
FLASH_BF16_ROW_RTOL, FLASH_BF16_ROW_ATOL = 1e-2, 1e-4
LSE_ATOL = 1e-4
# training agreement, flash kernels vs dense attention from the same params.
# The dense path rounds its scores to bf16 before the softmax and its
# probabilities to bf16 before PV (as the JAX model does); the kernels keep
# the scores float32 and round P and dS to bf16 before their products. On
# the H100 the loss differed by 9.2e-7 and the global grad norm by 3.6e-5
# relative; the limits are six to eight times that. The gradients of wq, wk
# and wv reach the parameters only through dQ, dK and dV and are held leaf
# by leaf as |g_flash - g_dense| / |g_dense|: measured 1.41e-2, 1.22e-2 and
# 3.9e-3 (the dense path's bf16 scores reach wq and wk through dS, and wv
# only through P), limits about two and a half times that.
TRAIN_LOSS_REL_TOL, TRAIN_GRAD_NORM_REL_TOL = 6e-6, 3e-4
TRAIN_QKV_GRAD_REL_TOL = {"wq": 3.5e-2, "wk": 3e-2, "wv": 1e-2}
# training against plain float32 attention (q, k and v upcast, probabilities
# float32, the output rounded to bf16 once), at the initial parameters and
# after the 5 steps: the relative loss gap and |g_kernels - g_plain| /
# |g_plain| of wq, wk and wv. The two share the rest of the model and differ
# in the attention arithmetic only (the kernels round P and dS to bf16
# before their products and form delta from the bf16 output). The gaps
# depend on the point (dense attention reads about the same against plain
# float32 at each), so each point has its own limits, about 2.5 times what
# the H100 read there: at the initial parameters 3.11e-5 (loss), 2.84e-2,
# 2.82e-2 and 2.13e-2 (wq, wk, wv); after 5 steps 8.3e-6, 1.22e-2, 1.06e-2
# and 3.65e-3.
TRAIN_F32_REF_TOL = {
    "initial": {"loss": 8e-5, "wq": 7e-2, "wk": 7e-2, "wv": 5.5e-2},
    "after 5 steps": {"loss": 2.1e-5, "wq": 3.1e-2, "wk": 2.7e-2, "wv": 9.2e-3},
}
# the tiny serving check: LlamaConfig.tiny() at pages of 4 tokens
TINY_BLOCK, TINY_NEW_TOKENS = 4, 12
PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024)
# HTTP serving (serve.run of build_openai_app on the main path's weights):
# completions of the main path's first three prompt lengths as text, one at
# a time; then a burst of 5 completions (the next five lengths), 2 chats and
# 1 SSE chat stream sent at once
HTTP_SEQUENTIAL_LENS, HTTP_BURST_LENS, HTTP_CHAT_LENS = (20, 75, 140), (233, 390, 600, 300,
                                                                     557), (64, 180)
# PD handoff: the first three of the main path's prompts; speculative
# decoding: K draft tokens a step, all eight prompts
PD_REQUESTS, SPEC_K = 3, 4
# draft = target: a proposal is rejected only where the draft's path (the
# paged kernel) and the verify's (the gather path, a [B, K+1] window) pick
# different tokens at a near-tie. A draft whose KV were wrong (a hole left by
# the bonus token, a page off by one) would propose at random, accepted at
# about 1 / vocab; the limit sits far above that and below a clean run.
SPEC_SAME_DRAFT_MIN_ACCEPT = 0.8
# MoE at Mixtral-8x7B widths, depth cut from 32 to 4 layers (46.7 B
# parameters, 93 GB in bf16, do not fit one 80 GB card); ViT-L/16 whole
MOE_LAYERS, MOE_BATCH, MOE_SEQ, VIT_BATCH, MODEL_STEPS = 4, 1, 2048, 64, 3
# bf16 weights and activations against a float32 copy of the same weights,
# limits set before the first card run: the loss within 1 % (MoE), the
# logits within LOGIT_REL_TOL of the largest float32 logit (ViT), the rule
# decode_agreement_phase holds the kernel path to
MOE_F32_LOSS_REL_TOL = 1e-2
# the tiny float32 configs on the card against the CPU: logits atol 2e-4,
# as tests/test_torch_llama.py holds a two-layer float32 forward
TINY_LOGIT_ATOL = 2e-4
FLASH_DTYPES = (torch.bfloat16, torch.float32)
PAGED_KERNELS = ("paged_split_kernel", "paged_combine_kernel")  # the paged pair, in launch order
FLASH_OUTPUTS = {"flash_fwd": ("o",), "flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv")}
FLASH_KERNELS = {  # name: (TPU kernel it replaces, tensor-core products per (q, k) pair,
    #                    the CUDA kernel that runs at the trainer's shapes)
    "flash_fwd": ("ray_tpu/ops/flash_attention.py:33", 2, "flash_fwd_bf16_kernel<64>"),
    "flash_bwd_dq": ("ray_tpu/ops/flash_attention.py:102", 3, "flash_bwd_dq_bf16_kernel<64>"),
    "flash_bwd_dkv": ("ray_tpu/ops/flash_attention.py:136", 4, "flash_bwd_dkv_bf16_kernel<64>"),
}


def log(card: str, what: str, **numbers) -> None:
    print(json.dumps({"what": what, **numbers, "card": card}), flush=True)


def flash_launches() -> dict:
    return {"flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.bwd_dq_launches,
            "flash_bwd_dkv": fa.bwd_dkv_launches}


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


def kernel_name(mangled: str) -> str:
    """'_ZN<len><namespace><len>flash_fwd_bf16_kernelILi64EE...' ->
    'flash_fwd_bf16_kernel<64>' (Itanium mangling: length-prefixed names)."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else "", mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    args = re.match(r"I(.+?)EE", rest)
    if not args:
        return name
    args = re.sub(r"Li(\d+)E?", r",\1", args.group(1)).replace("13__nv_bfloat16", "bf16")
    return f"{name}<{args.replace('f,', 'float,').lstrip(',')}>"


def ptxas_kernels(ptxas: str) -> dict:
    """Each kernel's registers, stack frame and spill bytes from nvcc's
    ``-Xptxas -v`` output, keyed ``name<template args>``."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def build_phase(card: str) -> None:
    t0 = time.monotonic()
    report = _build.build_all()
    log(card, "build", seconds=time.monotonic() - t0,
        nvcc_seconds={n: r["seconds"] for n, r in report.items()},
        cached=[n for n, r in report.items() if r["cached"]])
    kernels = {}
    for info in report.values():
        kernels.update(ptxas_kernels(info["ptxas"]))
    log(card, "ptxas: registers, stack frame and spill bytes per kernel", kernels=kernels)
    # the bf16 forward, dQ and dK/dV: registers, dynamic shared memory and spills
    lib = _build.load("flash_attention")
    for kernel, fn in (("flash_fwd_bf16_kernel", lib.flash_fwd_smem_bytes),
                       ("flash_bwd_dq_bf16_kernel", lib.flash_bwd_dq_smem_bytes),
                       ("flash_bwd_dkv_bf16_kernel", lib.flash_bwd_dkv_smem_bytes)):
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for D in (64, 128):
            log(card, f"{kernel}<{D}> resources", **kernels[f"{kernel}<{D}>"],
                dynamic_smem_bytes=fn(D, fa._DTYPES[torch.bfloat16]))
        assert kernels[f"{kernel}<64>"]["spill_stores"] == 0, kernels
    # the paged pair at the serving head dim: the split pass at each group it
    # is built for (Llama-3-8B runs group 4) and the combine
    paged = {n: r for n, r in kernels.items()
             if n.startswith(("paged_split_kernel<bf16,128,", "paged_combine_kernel<bf16,128>"))}
    log(card, "paged kernels resources (bf16, D 128)", kernels=paged,
        split_tokens={str(d): pa.pages_per_split(BLOCK, 128, d) * BLOCK for d in FLASH_DTYPES},
        block_size=BLOCK)
    assert len(paged) == 5 and all(r["spill_stores"] == 0 for r in paged.values()), paged


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


def split_edge_lengths(dtype, cfg: llama.LlamaConfig) -> list[int]:
    """One under, at and one over the first two split edges, the last
    position and a full table, at this dtype's split tile."""
    T = pa.pages_per_split(BLOCK, cfg.hd, dtype) * BLOCK
    return [T - 1, T, T + 1, 2 * T - 1, 2 * T, 2 * T + 1, MAX_SEQ - 1, MAX_SEQ]


def paged_launch_split(args, calls: int = 20) -> dict:
    """Device time of the split pass and of the combine per wrapper call,
    from torch.profiler over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            pa.paged_decode_attention(*args)
        torch.cuda.synchronize()
    dev, _ = device_events(prof)
    got = {name: device_ms(dev, name)[0] / calls for name in PAGED_KERNELS}
    if not all(got.values()):
        return {"split_ms": "not measured", "combine_ms": "not measured",
                "combine_share": "not measured"}
    return {"split_ms": got["paged_split_kernel"], "combine_ms": got["paged_combine_kernel"],
            "combine_share": got["paged_combine_kernel"] / sum(got.values())}


def kernel_phase(card: str, cfg: llama.LlamaConfig) -> dict:
    """Check the kernel on a ragged set (length 1, non-multiples of the page,
    a full table), on the main path's mid-decode lengths and at the split
    edges, in bf16 and float32; time it at the first two, the main path's
    numbers going to the line."""
    main_lengths = [len(p) + NEW_TOKENS // 2 for p in prompts(cfg)]
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in errs:
        for lengths in (KERNEL_LENGTHS, main_lengths, split_edge_lengths(dtype, cfg)):
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
    pages = pa.pages_per_split(BLOCK, cfg.hd, torch.bfloat16)
    tile = {"pages_per_split": pages, "split_tokens": pages * BLOCK,
            "n_splits": -(-(MAX_SEQ // BLOCK) // pages)}
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
        t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
        t.update(paged_launch_split(args))
        t["live_splits"] = sum(-(-n // tile["split_tokens"]) for n in lengths) * cfg.num_kv_heads
        log(card, f"paged_decode_attention timing ({label})", lengths=lengths, dtype="bf16",
            library_max_abs_err=lib_err.abs().max().item(), **t, **tile,
            shapes=dict(B=len(lengths), Hq=cfg.num_heads, Hkv=cfg.num_kv_heads, D=cfg.hd,
                        BS=BLOCK, max_blocks=MAX_SEQ // BLOCK))
        timed[label] = t
    t = timed["main path"]
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:31",
        "tpu_kernel": "ray_tpu/ops/paged_attention.py::_decode_kernel",
        "kernel": "paged_split_kernel<bf16,128,4> + paged_combine_kernel<bf16,128>",
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_bf16": errs[torch.bfloat16],
        "max_abs_err_f32": errs[torch.float32],
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "combine_share": t["combine_share"], **tile,
    }


def prompts(cfg: llama.LlamaConfig) -> list[list[int]]:
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(0, cfg.vocab_size, 256).tolist()
    lens = [20, 75, 140, 233, 390, 600]
    out = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    out += [shared + rng.integers(0, cfg.vocab_size, n).tolist() for n in (44, 301)]
    return out  # 8 prompts, 20..557 tokens; the last two share 256 tokens


def main_path_phase(card: str, cfg: llama.LlamaConfig) -> tuple[dict, int, dict]:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = PagedLLMEngine(
        PagedLLMConfig(model_config=cfg, max_batch_size=BATCH, max_seq_len=MAX_SEQ,
                       block_size=BLOCK, prefill_buckets=PREFILL_BUCKETS),
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
    plain = {"tokens": [r.token_ids for r in results],
             "decode_tokens_per_s": decode_tokens / decode_window}
    return eng.params, launches, plain


def decode_agreement_phase(card: str, cfg: llama.LlamaConfig, params) -> float:
    """One decode step through forward_paged from copies of the same pool:
    the gather path (plain attention) against the kernel path. Returns the
    largest logit difference, the scale of a near-tie."""
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
    return diff


def tree_map(fn, params: dict) -> dict:
    return {n: tree_map(fn, p) if isinstance(p, dict) else fn(p) for n, p in params.items()}


# ---------------------------------------------------------------- HTTP serving
def text_of(n: int, rng) -> str:
    """n printable ASCII characters: ByteTokenizer encodes them as n ids."""
    return "".join(chr(int(c)) for c in rng.integers(32, 127, n))


def http_post(port: int, sub: str, body: dict) -> tuple:
    """POST /v1/<sub>: (the JSON answer, or a stream's chunks; wall seconds;
    for a stream the seconds to its first data frame, else None)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/{sub}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            return json.loads(r.read()), time.monotonic() - t0, None
        chunks, first = [], None
        for line in r:
            line = line.decode().strip()
            if not line:
                continue
            first = first if first is not None else time.monotonic() - t0
            if line == "data: [DONE]":
                break
            chunk = json.loads(line[len("data: "):])
            assert "error" not in chunk, chunk
            chunks.append(chunk)
        return chunks, time.monotonic() - t0, first


def answer_text(out) -> str:
    """The text of an OpenAI answer, or of its SSE chunks joined."""
    if isinstance(out, list):
        return "".join(c["choices"][0].get("text", c["choices"][0].get("delta", {})
                                           .get("content", "")) for c in out)
    choice = out["choices"][0]
    return choice["text"] if "text" in choice else choice["message"]["content"]


def serve_http_phase(card: str, cfg: llama.LlamaConfig, params) -> int:
    """The main path's engine behind serve.run(build_openai_app(...)) and the
    HTTP proxy, on the main path's weights. One request at a time, each
    answer must be the bytes of a PagedLLMEngine called directly with the
    same ids (one request alone runs the same shapes on both sides). Then
    a burst of 8 requests at once: every answer 32 tokens, the stream's text
    that of the same body sent after the burst, and every decode step of the
    replica's engine through the paged kernel. Returns the burst's launches."""
    tok = ByteTokenizer()
    rng = np.random.default_rng(SEED + 9)
    conf = PagedLLMConfig(model_config=cfg, max_batch_size=BATCH, max_seq_len=MAX_SEQ,
                          block_size=BLOCK, prefill_buckets=PREFILL_BUCKETS)
    seq_texts = [text_of(n, rng) for n in HTTP_SEQUENTIAL_LENS]
    eng = PagedLLMEngine(conf, params=params, device=DEVICE)
    try:
        direct = [eng.generate_sync(tok.encode(t), NEW_TOKENS, timeout=600) for t in seq_texts]
    finally:
        eng.shutdown()
    burst = [("completions", {"prompt": text_of(n, rng), "max_tokens": NEW_TOKENS})
             for n in HTTP_BURST_LENS]
    burst += [("chat/completions", {"messages": [{"role": "user", "content": text_of(n, rng)}],
                                    "max_tokens": NEW_TOKENS}) for n in HTTP_CHAT_LENS]
    stream_body = {"messages": [{"role": "system", "content": text_of(40, rng)},
                                {"role": "user", "content": text_of(97, rng)}],
                   "max_tokens": NEW_TOKENS}
    burst.append(("chat/completions", {**stream_body, "stream": True}))
    results: list = [None] * len(burst)

    def client(i: int) -> None:
        try:
            results[i] = http_post(port, *burst[i])
        except Exception as e:  # noqa: BLE001 - raised below, in the phase's thread
            results[i] = e

    ray_tpu_torch.init()
    try:
        t0 = time.monotonic()
        handle = rt_serve.run(rt_serve.build_openai_app(conf, params=params),
                              route_prefix="/v1")
        t_run = time.monotonic() - t0
        port = rt_serve.start_http_proxy(port=0).port
        # the ingress alone: GET /v1/models goes client -> proxy -> router ->
        # replica and back, and does no engine work
        models_rtt = []
        for _ in range(20):
            t2 = time.monotonic()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=60) as r:
                assert json.loads(r.read())["data"][0]["object"] == "model"
            models_rtt.append(time.monotonic() - t2)
        seq = [http_post(port, "completions", {"prompt": t, "max_tokens": NEW_TOKENS})
               for t in seq_texts]
        # the replica's stats keep each request's engine timings, so the HTTP
        # wall can be held against the engine's own total_s
        served = ray_tpu_torch.get(handle.stats.remote(),
                                   timeout=60)["recent_requests"][-len(seq_texts):]
        # the stream's body once before the burst: its prompt blocks are then
        # cached, so the stream and the same body after the burst both
        # prefill the same suffix over the same cached blocks
        warm = http_post(port, "chat/completions", stream_body)[0]
        steps0 = ray_tpu_torch.get(handle.stats.remote(), timeout=60)["decode_steps"]
        pa.launches = 0  # count only the burst's launches
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(burst))]
        t1 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        burst_wall = time.monotonic() - t1
        launches = pa.launches
        steps = ray_tpu_torch.get(handle.stats.remote(), timeout=60)["decode_steps"] - steps0
        after = http_post(port, "chat/completions", stream_body)[0]
    finally:
        rt_serve.shutdown()
        ray_tpu_torch.shutdown()
    failed = [r for r in results if not isinstance(r, tuple)]
    assert not failed, failed
    for (out, _, _), res in zip(seq, direct):
        assert answer_text(out) == tok.decode(res.token_ids), (answer_text(out), res.token_ids)
        assert out["usage"]["completion_tokens"] == res.num_generated == NEW_TOKENS
    assert all(out["usage"]["completion_tokens"] == NEW_TOKENS for out, _, _ in results[:-1])
    chunks, _, ttft = results[-1]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert after["usage"]["completion_tokens"] == NEW_TOKENS
    assert answer_text(chunks) == answer_text(after), (answer_text(chunks), answer_text(after))
    assert steps > 0 and launches == cfg.num_layers * steps, (launches, steps)
    walls = sorted(w for _, w, _ in results)
    seq_walls = [w for _, w, _ in seq]
    ingress = [w - r["total_s"] for w, r in zip(seq_walls, served)]
    tokens = NEW_TOKENS * len(burst)
    log(card, "HTTP serve: Llama-3-8B OpenAIServer via serve.run and the HTTP proxy",
        serve_run_s=t_run, sequential_prompt_chars=list(HTTP_SEQUENTIAL_LENS),
        sequential_same_bytes_as_direct_engine=True,
        sequential_http_wall_ms=[1e3 * w for w in seq_walls],
        sequential_replica_engine_total_ms=[1e3 * r["total_s"] for r in served],
        sequential_direct_engine_total_ms=[1e3 * r.total_s for r in direct],
        replica_decode_step_ms=[1e3 * (r["total_s"] - r["ttft_s"]) / (NEW_TOKENS - 1)
                                for r in served],
        direct_decode_step_ms=[1e3 * (r.total_s - r.ttft_s) / (NEW_TOKENS - 1) for r in direct],
        wall_minus_replica_engine_ms=[1e3 * x for x in ingress],
        models_roundtrip_p50_ms=1e3 * statistics.median(models_rtt),
        models_roundtrip_max_ms=1e3 * max(models_rtt),
        ingress_share=sum(ingress) / sum(seq_walls),
        burst_requests=len(burst), new_tokens=NEW_TOKENS, burst_wall_s=burst_wall,
        stream_ttft_ms=1e3 * ttft, request_wall_p50_ms=1e3 * statistics.median(walls),
        request_wall_max_ms=1e3 * walls[-1], requests_per_s=len(burst) / burst_wall,
        tokens_per_s_over_burst_wall=tokens / burst_wall, decode_steps=steps,
        paged_decode_launches=launches, stream_same_text_as_after_burst=True,
        warm_full_prefill_same_text_as_stream=answer_text(warm) == answer_text(after))
    return launches


def tiny_http_phase(card: str) -> None:
    """LlamaConfig.tiny() (float32) at pages of TINY_BLOCK tokens served
    through build_openai_app and the HTTP proxy, once on the CPU and once on
    the card from the same weights: the same text for the same 3 bodies, and
    on the card every decode step through the paged kernel."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    bodies = [("completions", {"prompt": "paged attention on Hopper",
                               "max_tokens": TINY_NEW_TOKENS}),
              ("chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                    "max_tokens": TINY_NEW_TOKENS}),
              ("completions", {"prompt": "y" * 39, "max_tokens": TINY_NEW_TOKENS})]
    texts, launches, steps = {}, {}, {}
    for where, device in (("cpu", torch.device("cpu")), ("card", DEVICE)):
        ray_tpu_torch.init()
        try:
            handle = rt_serve.run(rt_serve.build_openai_app(
                PagedLLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=cfg.max_seq_len,
                               block_size=TINY_BLOCK),
                params=tree_map(lambda t: t.to(device), params), device=device),
                route_prefix="/v1")
            port = rt_serve.start_http_proxy(port=0).port
            pa.launches = 0
            texts[where] = [answer_text(http_post(port, sub, b)[0]) for sub, b in bodies]
            launches[where] = pa.launches
            steps[where] = ray_tpu_torch.get(handle.stats.remote(), timeout=60)["decode_steps"]
        finally:
            rt_serve.shutdown()
            ray_tpu_torch.shutdown()
    log(card, "tiny HTTP serve: LlamaConfig.tiny() via build_openai_app, card vs CPU",
        block_size=TINY_BLOCK, decode_steps=steps, paged_decode_launches=launches,
        same_text=texts["card"] == texts["cpu"])
    assert steps["card"] > 0 and launches["card"] == cfg.num_layers * steps["card"], (
        steps, launches)
    assert launches["cpu"] == 0 and texts["card"] == texts["cpu"], texts


def tiny_engine_phase(card: str) -> None:
    """LlamaConfig.tiny() (head dim 16, group 2, float32) at pages of
    TINY_BLOCK tokens: an engine on the card, every decode step through the
    paged kernel, gives the greedy tokens of an engine on the CPU from the
    same weights."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    reqs = [[5, 9, 13, 2, 7], [3, 3, 8], list(range(1, 40))]
    tokens, launches, steps = {}, {}, {}
    for where, device in (("cpu", torch.device("cpu")), ("card", DEVICE)):
        eng = PagedLLMEngine(
            PagedLLMConfig(model_config=cfg, max_batch_size=4, max_seq_len=cfg.max_seq_len,
                           block_size=TINY_BLOCK),
            params=tree_map(lambda t: t.to(device), params), device=device)
        try:
            pa.launches = 0
            futs = [eng.generate(p, TINY_NEW_TOKENS) for p in reqs]
            tokens[where] = [f.result(timeout=300).token_ids for f in futs]
            launches[where], steps[where] = pa.launches, eng.stats()["decode_steps"]
        finally:
            eng.shutdown()
    log(card, "tiny engine: LlamaConfig.tiny() at block size 4, card vs CPU",
        head_dim=cfg.hd, group=cfg.num_heads // cfg.num_kv_heads, block_size=TINY_BLOCK,
        decode_steps=steps, paged_decode_launches=launches,
        same_tokens=tokens["card"] == tokens["cpu"])
    assert steps["card"] > 0 and launches["card"] == cfg.num_layers * steps["card"], (
        steps, launches)
    assert launches["cpu"] == 0 and tokens["card"] == tokens["cpu"], tokens


def device_events(prof) -> tuple[list, dict]:
    """The profiled kernels with device time, and the device time (ms) under
    each user annotation, such as the optimizer's step. An annotation's time
    is that of kernels already in the list, so it is kept apart."""
    dev, marked = [], {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            if e.is_user_annotation:
                marked[e.key] = e.self_device_time_total / 1e3
            else:
                dev.append(e)
    return dev, marked


def device_ms(dev, name: str) -> tuple[float, int]:
    """Device ms and calls of the profiled kernels whose name holds `name`."""
    hits = [e for e in dev if name in e.key]
    return sum(e.self_device_time_total for e in hits) / 1e3, sum(e.count for e in hits)


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
    dev, _ = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
    paged = {name: dict(zip(("ms_per_step", "calls_per_step"),
                            (x / steps for x in device_ms(dev, name))))
             for name in PAGED_KERNELS}
    log(card, "decode step breakdown (forward_paged, batch 8, kernel path)",
        wall_ms=wall_ms, device_busy_ms=busy_ms if dev else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if dev else "not measured",
        device_launches_per_step=sum(e.count for e in dev) / steps,
        paged_launches=paged if dev else "not measured",
        top=[{"name": e.key[:70], "ms_per_step": e.self_device_time_total / 1e3 / steps,
              "calls_per_step": e.count / steps} for e in top])


def flash_inputs(dtype, B, S, Hq, Hkv, D, seed: int):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(DEVICE).to(dtype)

    return t(B, S, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D), t(B, S, Hq, D)


def flash_err(got, ref) -> dict:
    """The largest abs difference, the largest per-row relative difference
    (2-norm over the last dim) and whether the dtype's rule above holds."""
    got, want = got.float(), ref.float()
    diff = (got - want).abs().max().item()
    row_err = torch.linalg.vector_norm(got - want, dim=-1)
    row_ref = torch.linalg.vector_norm(want, dim=-1)
    if ref.dtype == torch.float32:
        ok = diff <= FLASH_F32_ATOL * max(1.0, want.abs().max().item())
    else:
        ok = bool((row_err <= FLASH_BF16_ROW_RTOL * row_ref + FLASH_BF16_ROW_ATOL).all())
    # relative to max(|plain|, 1e-2) per row, so rows that are zero stay finite
    rel = (row_err / row_ref.clamp(min=FLASH_BF16_ROW_ATOL / FLASH_BF16_ROW_RTOL)).max().item()
    return {"max_abs_err": diff, "max_row_rel_err": rel, "ok": ok}


def flash_ops(name: str, B, S, Hq, Hkv, D) -> int:
    """The tensor-core products of one causal call, over the S (S + 1) / 2
    live (query, key) pairs."""
    return 2 * FLASH_KERNELS[name][1] * B * Hq * D * (S * (S + 1) // 2)


def flash_bound(name: str, B, S, Hq, Hkv, D, item: int) -> tuple[float, str]:
    """Least time for one causal call: each input read once and each output
    written once, against its products at the bf16 peak."""
    ops = flash_ops(name, B, S, Hq, Hkv, D)
    qb, kvb, row = B * S * Hq * D * item, B * S * Hkv * D * item, B * Hq * S * 4
    nbytes = {"flash_fwd": 2 * qb + 2 * kvb + row,            # q, k, v -> o, lse
              "flash_bwd_dq": 3 * qb + 2 * kvb + 2 * row,     # q, k, v, dO, lse, delta -> dq
              "flash_bwd_dkv": 2 * qb + 4 * kvb + 2 * row}[name]  # ... -> dk, dv
    t_ops, t_bytes = ops / PEAK_FLOPS[torch.bfloat16], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flash_kernel_phase(card: str) -> list[dict]:
    """Each flash kernel against its plain version on the same inputs (the
    backward ones fed the plain forward's lse and delta), then timed at the
    trainer's shapes."""
    errs = {n: {d: {"max_abs_err": 0.0, "max_row_rel_err": 0.0} for d in FLASH_DTYPES}
            for n in FLASH_KERNELS}
    failed = []
    for dtype in FLASH_DTYPES:
        for shape in FLASH_SHAPES:
            for causal in (True, False):
                q, k, v, do = flash_inputs(dtype, *shape, seed=SEED)
                o, lse = fa.flash_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal)
                lse_err = (lse - lse_ref).abs().max().item()
                delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
                dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
                dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
                torch.cuda.synchronize()
                dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta, causal)
                got = {"o": flash_err(o, o_ref),
                       "dq": flash_err(dq, fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta,
                                                               causal)),
                       "dk": flash_err(dk, dk_ref), "dv": flash_err(dv, dv_ref)}
                for n, outs in FLASH_OUTPUTS.items():
                    for key, worst in errs[n][dtype].items():
                        errs[n][dtype][key] = max([worst] + [got[out][key] for out in outs])
                log(card, "flash kernels check", dtype=str(dtype), shape=shape, causal=causal,
                    errors=got, lse_max_abs_err=lse_err, lse_atol=LSE_ATOL,
                    rule=(f"max abs <= {FLASH_F32_ATOL} * max(1, max |plain|)"
                          if dtype == torch.float32 else
                          f"per row |d| <= {FLASH_BF16_ROW_RTOL} |plain| + {FLASH_BF16_ROW_ATOL}"))
                failed += [(str(dtype), shape, causal, out) for out, e in got.items()
                           if not e["ok"]]
                if lse_err > LSE_ATOL:
                    failed.append((str(dtype), shape, causal, "lse"))
                del q, k, v, do, o, lse, o_ref, lse_ref, delta, dq, dk, dv, dk_ref, dv_ref
    assert not failed, failed

    cfg = llama.LlamaConfig.llama_1b()
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    q, k, v, do = flash_inputs(torch.bfloat16, *shape, seed=SEED)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    # the library yardstick: SDPA in its own [B, H, S, D] layout (transposed
    # here, outside the timed calls); its backward gives dq, dk and dv at once
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = (lib_out.detach().transpose(1, 2).float() - o.float()).abs().max().item()
    dot = do.transpose(1, 2).contiguous()
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True),
                      lambda: fa.flash_fwd_ref(q, k, v, True)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                         lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, True)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                          lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, True)),
    }
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    with torch.no_grad():
        lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                     retain_graph=True), flush)
    entries = []
    for name, (kernel, plain) in calls.items():
        t = {"kernel_ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush, 5, 1),
             "kernel_ms_repeat": time_ms(kernel, flush)}
        t["bound_ms"], t["bound_by"] = flash_bound(name, *shape, q.element_size())
        t["achieved_tflops"] = flash_ops(name, *shape) / t["kernel_ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
        t["library_ms"] = lib_fwd_ms if name == "flash_fwd" else lib_bwd_ms
        library = ("SDPA forward, is_causal, enable_gqa" if name == "flash_fwd" else
                   "SDPA backward: dq, dk and dv in one call")
        log(card, f"{name} timing (trainer shapes)", dtype="bf16", causal=True,
            shapes=dict(zip("B S Hq Hkv D".split(), shape)), library=library,
            library_fwd_max_abs_err=lib_err, **t)
        entries.append({
            "name": name, "kernel": FLASH_KERNELS[name][2], "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attention.cu", "replaces": FLASH_KERNELS[name][0],
            "max_abs_err": errs[name][torch.bfloat16]["max_abs_err"],
            "max_abs_err_bf16": errs[name][torch.bfloat16]["max_abs_err"],
            "max_row_rel_err_bf16": errs[name][torch.bfloat16]["max_row_rel_err"],
            "max_abs_err_f32": errs[name][torch.float32]["max_abs_err"],
            "max_row_rel_err_f32": errs[name][torch.float32]["max_row_rel_err"],
            "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": library,
        })
    return entries


def train_batch(cfg: llama.LlamaConfig):
    rng = np.random.default_rng(SEED + 3)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    targets = np.concatenate([tokens[:, 1:], np.full((TRAIN_BATCH, 1), -100)], axis=1)
    return torch.from_numpy(tokens).to(DEVICE), torch.from_numpy(targets).to(DEVICE)


def model_flops_per_step(cfg: llama.LlamaConfig) -> float:
    """6 N per token for the weight products (N without the input embedding,
    a lookup) plus the causal attention products, forward and backward,
    without remat's recompute."""
    n = llama.param_count_analytic(cfg) - cfg.vocab_size * cfg.hidden_size
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 3 * 4 * TRAIN_BATCH * cfg.num_heads * cfg.hd * pairs * cfg.num_layers
    return 6 * n * TRAIN_BATCH * TRAIN_SEQ + attn


def trainer_phase(card: str, cfg: llama.LlamaConfig):
    """The training path: init_state and make_train_step on Llama-3.2-1B,
    TRAIN_STEPS steps on one fixed batch, counting the flash launches."""
    opt = spmd.make_optimizer(warmup=1)
    t0 = time.monotonic()
    state = spmd.init_state(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), opt,
                            device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    # the steps update the parameters in place; the copy waits on the host,
    # out of the peak memory of the steps
    initial = tree_map(lambda t: t.to("cpu", copy=True), state.params)
    step = spmd.make_train_step(cfg, opt, device=DEVICE)
    tokens, targets = train_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0  # the training path's only
    for _ in range(TRAIN_STEPS):
        t1 = time.monotonic()
        state, m = step(state, tokens, targets)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        times.append(time.monotonic() - t1)
    launches = flash_launches()
    L = cfg.num_layers
    want = {"flash_fwd": 2 * L * TRAIN_STEPS, "flash_bwd_dq": L * TRAIN_STEPS,
            "flash_bwd_dkv": L * TRAIN_STEPS}
    assert launches == want, (launches, want)
    assert state.step == TRAIN_STEPS
    assert np.isfinite(losses).all() and np.isfinite(norms).all(), (losses, norms)
    assert losses[-1] < losses[0], losses
    step_s = statistics.median(times[1:])
    flops = model_flops_per_step(cfg)
    log(card, "training path: Llama-3.2-1B train steps", layers=L, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, remat=cfg.remat_policy if cfg.remat else "none",
        param_count=llama.param_count(state.params), init_s=t_init, losses=losses,
        grad_norms=norms, step_s=times, step_ms_median_2_to_5=1e3 * step_s,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, model_flops_per_step=flops,
        train_mfu=flops / step_s / PEAK_FLOPS[torch.bfloat16],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, flash_launches=launches,
        launches_per_step={n: c / TRAIN_STEPS for n, c in launches.items()})
    return launches, state, step, (tokens, targets), initial


def training_agreement_phase(card: str, cfg: llama.LlamaConfig, params, batch) -> None:
    """loss_fn and its backward from the same parameters, once through the
    flash kernels (auto_attention) and once through dense attention."""
    tensors = spmd.leaves(params)
    at = {n: next(i for i, t in enumerate(tensors) if t is params["layers"][n])
          for n in TRAIN_QKV_GRAD_REL_TOL}
    got, qkv_grads = {}, {}
    for label, attn_fn in (("flash", None), ("dense", llama.attention)):
        before = flash_launches()
        loss = llama.loss_fn(params, *batch, cfg, attn_fn)
        grads = torch.autograd.grad(loss, tensors)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        got[label] = (loss.item(), norm.item(),
                      {n: c - before[n] for n, c in flash_launches().items()})
        qkv_grads[label] = {n: grads[i].float() for n, i in at.items()}
        del loss, grads
    assert all(c == 0 for c in got["dense"][2].values()), got
    assert all(c > 0 for c in got["flash"][2].values()), got
    rel_loss = abs(got["flash"][0] - got["dense"][0]) / abs(got["dense"][0])
    rel_norm = abs(got["flash"][1] - got["dense"][1]) / abs(got["dense"][1])
    rel_qkv = {n: (torch.linalg.vector_norm(qkv_grads["flash"][n] - g)
                   / torch.linalg.vector_norm(g)).item()
               for n, g in qkv_grads["dense"].items()}
    assert np.isfinite([got["flash"][:2], got["dense"][:2]]).all(), got
    log(card, "training agreement: flash kernels vs dense attention", loss_flash=got["flash"][0],
        loss_dense=got["dense"][0], loss_rel_diff=rel_loss, loss_rel_tol=TRAIN_LOSS_REL_TOL,
        grad_norm_flash=got["flash"][1], grad_norm_dense=got["dense"][1],
        grad_norm_rel_diff=rel_norm, grad_norm_rel_tol=TRAIN_GRAD_NORM_REL_TOL,
        grad_rel_diff=rel_qkv, grad_rel_tol=TRAIN_QKV_GRAD_REL_TOL)
    assert rel_loss <= TRAIN_LOSS_REL_TOL and rel_norm <= TRAIN_GRAD_NORM_REL_TOL, got
    assert all(rel_qkv[n] <= tol for n, tol in TRAIN_QKV_GRAD_REL_TOL.items()), rel_qkv


def plain_f32_attention(q, k, v, causal: bool = True):
    """Plain float32 attention for the training checks: q, k and v upcast,
    the probabilities kept float32, the output rounded to q's dtype once
    (the flash forward's plain version, differentiated by autograd)."""
    return fa.flash_fwd_ref(q, k, v, causal)[0]


def loss_and_qkv_grads(cfg: llama.LlamaConfig, params, batch, attn_fn) -> tuple:
    """loss_fn through attn_fn (None: auto_attention, the flash kernels at
    the trainer's shapes) and the float32 gradients of wq, wk and wv."""
    names = list(TRAIN_QKV_GRAD_REL_TOL)
    wanted = [params["layers"][n].requires_grad_() for n in names]
    loss = llama.loss_fn(params, *batch, cfg, attn_fn)
    grads = torch.autograd.grad(loss, wanted)
    return loss.item(), {n: g.float() for n, g in zip(names, grads)}


def attention_gaps(got: tuple, ref: tuple) -> dict:
    """Relative gaps of one (loss, gradients) reading against another's."""
    gaps = {"loss": abs(got[0] - ref[0]) / abs(ref[0])}
    for n, g in got[1].items():
        gaps[n] = (torch.linalg.vector_norm(g - ref[1][n])
                   / torch.linalg.vector_norm(ref[1][n])).item()
    return gaps


def f32_reference_phase(card: str, cfg: llama.LlamaConfig, points: dict, batch) -> None:
    """The loss and the wq/wk/wv gradients through the flash kernels against
    plain float32 attention from the same parameters, at each point."""
    readings = {}
    for label, params in points.items():
        before = flash_launches()
        kernels = loss_and_qkv_grads(cfg, params, batch, None)
        mid = flash_launches()
        plain = loss_and_qkv_grads(cfg, params, batch, plain_f32_attention)
        assert all(mid[n] > before[n] for n in mid) and flash_launches() == mid
        readings[label] = attention_gaps(kernels, plain)
        readings[label]["loss_kernels"], readings[label]["loss_plain"] = kernels[0], plain[0]
        del kernels, plain
    log(card, "training: flash kernels vs plain float32 attention (relative gaps)",
        readings=readings, tol=TRAIN_F32_REF_TOL)
    over = [(p, n) for p, gaps in readings.items() for n, tol in TRAIN_F32_REF_TOL[p].items()
            if not gaps[n] <= tol]
    assert not over, (over, readings)


def profile_train_step(card: str, step, state, batch) -> None:
    """Where one train step's time goes: host wall, device busy time from
    torch.profiler, the top kernels and the flash kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, _ = step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    dev, marked = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    flash_ms = sum(e.self_device_time_total for e in dev if "flash_" in e.key) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in dev
                  if e.key.startswith("nvjet") or "gemm" in e.key) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    log(card, "train step breakdown (Llama-3.2-1B, B 4 x S 2048, under the profiler)",
        wall_ms=wall_ms, device_busy_ms=busy_ms if dev else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if dev else "not measured",
        flash_ms=flash_ms if dev else "not measured",
        flash_share_of_busy=flash_ms / busy_ms if dev else "not measured",
        cublas_gemm_ms=gemm_ms if dev else "not measured", annotated_ms=marked,
        device_launches=sum(e.count for e in dev),
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count}
             for e in top])


# ---------------------------------------------------------------- PD, speculative decoding
def near_tie_rule(cfg: llama.LlamaConfig, params, reqs, want, got, tol: float) -> dict:
    """Each request's tokens must equal the plain engine's, or part from them
    first at a near-tie: a step where a dense forward of the common prefix
    puts the two tokens within `tol` (twice the kernel-vs-gather logit
    difference decode_agreement_phase measured) of each other. Past that
    step the contexts differ, so the tokens may too."""
    parted = []
    for i, (prompt, w, g) in enumerate(zip(reqs, want, got)):
        assert len(w) == len(g), (len(w), len(g))
        j = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if j is None:
            continue
        seq = torch.tensor([prompt + w[:j]], dtype=torch.int32, device=DEVICE)
        with torch.no_grad():
            logits = llama.forward(params, seq, cfg, llama.attention)[0, -1]
        parted.append({"request": i, "step": j,
                       "margin": (logits[w[j]] - logits[g[j]]).abs().item()})
        del logits
    over = [p for p in parted if not p["margin"] <= tol]
    assert not over, (over, tol)
    return {"requests_same_tokens": len(reqs) - len(parted), "parted_at_near_ties": parted,
            "near_tie_tol": tol}


def copy_ms(fn) -> float:
    """Host wall of copies that end in a sync, median of 3."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.monotonic() - t0))
    return statistics.median(times)


def serve(eng, reqs) -> tuple[list, float, dict]:
    """All requests at once: the results, the decode tokens/s (tokens after
    each request's first over the window after the last first token, as the
    main path counts them) and the engine's stats."""
    futs = [eng.generate(p, NEW_TOKENS) for p in reqs]
    results = [f.result(timeout=900) for f in futs]
    torch.cuda.synchronize()
    window = max(r.total_s for r in results) - max(r.ttft_s for r in results)
    return results, sum(r.num_generated - 1 for r in results) / window, eng.stats()


def pd_phase(card: str, cfg: llama.LlamaConfig, params, plain: dict, tol: float) -> int:
    """Prefill/decode disaggregation at the serving config: one engine
    extracts each prompt's KV pages to the host, a second engine on the same
    card attaches them and decodes through the paged kernel."""
    reqs = prompts(cfg)[:PD_REQUESTS]
    conf = PagedLLMConfig(model_config=cfg, max_batch_size=BATCH, max_seq_len=MAX_SEQ,
                          block_size=BLOCK, prefill_buckets=PREFILL_BUCKETS)
    prefiller = PagedLLMEngine(conf, params=params, device=DEVICE)
    decoder = PagedLLMEngine(conf, params=params, device=DEVICE)
    try:
        pa.launches = 0  # count only this path's launches
        t0 = time.monotonic()
        handoffs = [prefiller.prefill_extract(p) for p in reqs]
        t_extract = time.monotonic() - t0
        futs = [decoder.attach_sequence(h, NEW_TOKENS) for h in handoffs]
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        launches, steps = pa.launches, decoder.stats()["decode_steps"]
    finally:
        prefiller.shutdown()
        decoder.shutdown()
    assert steps > 0 and launches == cfg.num_layers * steps, (launches, steps)
    kv = [t for h in handoffs for t in h["kv"].values()]
    assert all(t.device.type == "cpu" and t.dtype == cfg.dtype for t in kv)
    nbytes = sum(t.numel() * t.element_size() for t in kv)
    on_card = [t.to(DEVICE) for t in kv]
    h2d = copy_ms(lambda: [t.to(DEVICE) for t in kv])
    d2h = copy_ms(lambda: [t.cpu() for t in on_card])
    del on_card, kv, handoffs
    window = max(r.total_s for r in results) - max(r.ttft_s for r in results)
    agree = near_tie_rule(cfg, params, reqs, plain["tokens"][:PD_REQUESTS],
                          [r.token_ids for r in results], tol)
    log(card, "PD handoff: Llama-3-8B, prefill engine -> host -> decode engine",
        requests=len(reqs), prompt_tokens=[len(p) for p in reqs], new_tokens=NEW_TOKENS,
        handoff_bytes=nbytes, prefill_extract_s=t_extract, host_to_device_ms=h2d,
        device_to_host_ms=d2h, host_to_device_gb_per_s=nbytes / h2d / 1e6,
        device_to_host_gb_per_s=nbytes / d2h / 1e6, decode_steps=steps,
        paged_decode_launches=launches,
        decode_tokens_per_s=sum(r.num_generated - 1 for r in results) / window, **agree)
    return launches


def spec_run(card: str, label: str, cfg: llama.LlamaConfig, params, dcfg: llama.LlamaConfig,
             draft, plain: dict, tol: float) -> tuple[int, dict]:
    """Speculative decoding of the main path's prompts at K = SPEC_K: the
    paged launches (the draft's single-token decodes, (K - 1) x draft layers
    a step), the greedy tokens against the plain engine's under the
    near-tie rule, the acceptance and the decode tokens/s."""
    reqs = prompts(cfg)
    conf = SpecDecodeConfig(model_config=cfg, draft_model_config=dcfg,
                            num_speculative_tokens=SPEC_K, max_batch_size=BATCH,
                            max_seq_len=MAX_SEQ, block_size=BLOCK,
                            prefill_buckets=PREFILL_BUCKETS)
    eng = SpecDecodeLLMEngine(conf, params=params, draft_params=draft, device=DEVICE)
    try:
        pa.launches = 0  # count only this path's launches
        results, tps, stats = serve(eng, reqs)
        launches = pa.launches
    finally:
        eng.shutdown()
    steps = stats["decode_steps"]
    assert steps > 0 and launches == (SPEC_K - 1) * dcfg.num_layers * steps, (launches, steps)
    agree = near_tie_rule(cfg, params, reqs, plain["tokens"], [r.token_ids for r in results],
                          tol)
    out = {"acceptance": stats["accepted_tokens"] / stats["proposed_tokens"],
           # over the batch: each verify step scores every active request
           "tokens_per_verify_step": sum(r.num_generated - 1 for r in results) / steps,
           "decode_tokens_per_s": tps, "plain_decode_tokens_per_s": plain["decode_tokens_per_s"]}
    log(card, f"speculative decoding: {label}", K=SPEC_K, requests=len(reqs),
        new_tokens=NEW_TOKENS, verify_steps=steps, paged_decode_launches=launches,
        proposed=stats["proposed_tokens"], accepted=stats["accepted_tokens"],
        speed_vs_plain=tps / plain["decode_tokens_per_s"], **out, **agree)
    return launches, out


def spec_phase(card: str, cfg: llama.LlamaConfig, params, plain: dict, tol: float) -> dict:
    """Target Llama-3-8B with a random Llama-3.2-1B draft (head dim 64, group
    4), then draft = target on a 1B target, each against its plain engine.
    Returns the paged launches of each."""
    dcfg = llama.LlamaConfig.llama_1b()
    draft = llama.init(dcfg, torch.Generator(device=DEVICE).manual_seed(7), DEVICE)
    launches = {}
    launches["speculative: 8B target, 1B draft"], _ = spec_run(
        card, "Llama-3-8B target, random Llama-3.2-1B draft", cfg, params, dcfg, draft,
        plain, tol)
    eng = PagedLLMEngine(PagedLLMConfig(model_config=dcfg, max_batch_size=BATCH,
                                        max_seq_len=MAX_SEQ, block_size=BLOCK,
                                        prefill_buckets=PREFILL_BUCKETS),
                         params=draft, device=DEVICE)
    try:
        results, tps, _ = serve(eng, prompts(cfg))
    finally:
        eng.shutdown()
    plain_1b = {"tokens": [r.token_ids for r in results], "decode_tokens_per_s": tps}
    launches["speculative: 1B, draft = target"], same = spec_run(
        card, "Llama-3.2-1B, draft = target", dcfg, draft, dcfg, draft, plain_1b, tol)
    assert same["acceptance"] >= SPEC_SAME_DRAFT_MIN_ACCEPT, same
    return launches


def draft_kernel_phase(card: str, dcfg: llama.LlamaConfig) -> dict:
    """The paged pair at the draft's shape (Llama-3.2-1B: D 64, group 4,
    pages of 16) against its plain version in bf16 and float32, then timed
    in bf16 at the main path's mid-decode lengths beside its plain version,
    SDPA over pre-gathered KV and the byte bound."""
    lengths = [len(p) + NEW_TOKENS // 2 for p in prompts(dcfg)]
    errs = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in errs:
        for lens in (lengths, KERNEL_LENGTHS, split_edge_lengths(dtype, dcfg)):
            args = paged_inputs(dtype, dcfg, lens, SEED)
            got = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            ref = pa.paged_decode_attention_ref(*args)
            torch.testing.assert_close(got, ref, **TOL[dtype])
            errs[dtype] = max(errs[dtype], (got.float() - ref.float()).abs().max().item())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    args = paged_inputs(torch.bfloat16, dcfg, lengths, SEED)
    t = {"kernel_ms": time_ms(lambda: pa.paged_decode_attention(*args), flush),
         "plain_ms": time_ms(lambda: pa.paged_decode_attention_ref(*args), flush),
         "library_ms": time_ms(sdpa_call(args), flush),
         "kernel_ms_repeat": time_ms(lambda: pa.paged_decode_attention(*args), flush)}
    t["bound_ms"], t["bound_by"] = paged_bound(args)
    t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
    out = {"kernel": "paged_split_kernel<bf16,64,4> + paged_combine_kernel<bf16,64>",
           "max_abs_err_bf16": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
           "tol": {str(d): TOL[d] for d in errs}, **t,
           "launches_per_speculative_step": (SPEC_K - 1) * dcfg.num_layers}
    log(card, "paged_decode_attention at the draft's shape (Llama-3.2-1B)", lengths=lengths,
        dtype="bf16", shapes=dict(B=len(lengths), Hq=dcfg.num_heads, Hkv=dcfg.num_kv_heads,
                                  D=dcfg.hd, BS=BLOCK, max_blocks=MAX_SEQ // BLOCK), **out)
    return out


# ---------------------------------------------------------------- MoE, ViT
def grad_step_ms(loss_fn, leaves) -> tuple[float, float]:
    """(loss, host ms) of loss_fn() and its backward: the median of
    MODEL_STEPS runs after one warm-up."""
    times = []
    for i in range(MODEL_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = loss_fn()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        if i:
            times.append(1e3 * (time.monotonic() - t0))
        assert all(torch.isfinite(g).all() for g in grads)
        del grads
    return loss.item(), statistics.median(times)


def profile_grad_step(card: str, label: str, loss_fn, leaves) -> None:
    """Where one loss + backward's time goes: host wall, device busy time
    from torch.profiler, the cuBLAS GEMMs' share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        grads = torch.autograd.grad(loss_fn(), leaves)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    del grads
    dev, _ = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in dev
                  if e.key.startswith("nvjet") or "gemm" in e.key) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    log(card, f"{label} step breakdown (under the profiler)", wall_ms=wall_ms,
        device_busy_ms=busy_ms if dev else "not measured",
        device_idle_share=1 - busy_ms / wall_ms if dev else "not measured",
        cublas_gemm_ms=gemm_ms if dev else "not measured",
        gemm_share_of_busy=gemm_ms / busy_ms if dev else "not measured",
        device_launches=sum(e.count for e in dev),
        top=[{"name": e.key[:70], "ms": e.self_device_time_total / 1e3, "calls": e.count}
             for e in top])


def moe_phase(card: str) -> None:
    """Mixtral-8x7B widths at 4 of its 32 layers: loss_fn and its backward
    at B 1 x S 2048 in bf16, the share of (token, choice) pairs that
    capacity drops in each layer, and the forward loss against a float32
    copy of the same weights."""
    full = moe.MoEConfig.mixtral_8x7b()
    cfg = dataclasses.replace(full, base=dataclasses.replace(full.base, num_layers=MOE_LAYERS))
    params = moe.init(cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    n_params = sum(t.numel() for t in spmd.leaves(params))
    rng = np.random.default_rng(SEED + 4)
    tokens = torch.from_numpy(rng.integers(0, cfg.base.vocab_size, (MOE_BATCH, MOE_SEQ)))
    tokens = tokens.to(DEVICE)
    targets = torch.roll(tokens, -1, dims=1)
    leaves = [t.requires_grad_() for t in spmd.leaves(params)]
    torch.cuda.reset_peak_memory_stats()
    loss, step_ms = grad_step_ms(lambda: moe.loss_fn(params, tokens, targets, cfg), leaves)
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile_grad_step(card, "MoE (Mixtral widths, 4 layers, B 1 x S 2048)",
                      lambda: moe.loss_fn(params, tokens, targets, cfg), leaves)
    for t in leaves:
        t.requires_grad_(False)
    del leaves
    route, kept = moe.route, []

    def counting_route(xt, router_w, cfg_, capacity):
        dispatch, combine, aux = route(xt, router_w, cfg_, capacity)
        kept.append(dispatch.sum() / (xt.shape[0] * cfg_.top_k))
        return dispatch, combine, aux

    moe.route = counting_route  # one forward, to read the dispatch of each layer
    try:
        with torch.no_grad():
            logits, aux = moe.forward(params, tokens, cfg)
    finally:
        moe.route = route
    assert torch.isfinite(logits).all() and len(kept) == MOE_LAYERS
    del logits
    with torch.no_grad():
        loss_fwd = moe.loss_fn(params, tokens, targets, cfg).item()
        cfg32 = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, dtype=torch.float32))
        params = tree_map(lambda t: t.float(), params)  # the bf16 copy is dropped here
        gc.collect()
        torch.cuda.empty_cache()
        loss32 = moe.loss_fn(params, tokens, targets, cfg32).item()
    del params
    gap = abs(loss_fwd - loss32) / abs(loss32)
    log(card, "MoE: Mixtral-8x7B widths, 4 of 32 layers, loss_fn + backward (bf16)",
        layers=MOE_LAYERS, layers_published=full.base.num_layers, batch=MOE_BATCH,
        seq=MOE_SEQ, experts=cfg.num_experts, top_k=cfg.top_k,
        capacity=max(1, int(cfg.capacity_factor * cfg.top_k * MOE_BATCH * MOE_SEQ
                            / cfg.num_experts)),
        param_count=n_params, loss=loss, aux=aux.item(),
        dropped_share_per_layer=[1 - k.item() for k in kept], step_ms=step_ms,
        tokens_per_s=1e3 * MOE_BATCH * MOE_SEQ / step_ms, peak_mem_gb=peak,
        loss_forward=loss_fwd, loss_f32=loss32, loss_rel_gap_f32=gap,
        loss_rel_tol=MOE_F32_LOSS_REL_TOL)
    assert np.isfinite([loss, loss_fwd, loss32, aux.item()]).all()
    assert gap <= MOE_F32_LOSS_REL_TOL, gap


def vit_phase(card: str) -> None:
    """ViT-L/16 whole (24 layers, hidden 1024, 224 x 224, patch 16): loss_fn
    and its backward at batch 64 in bf16, then the logits against a float32
    copy of the same weights."""
    cfg = vit.ViTConfig.vit_l16()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = vit.init(cfg, gen, DEVICE)
    images = torch.rand((VIT_BATCH, cfg.image_size, cfg.image_size, 3), generator=gen,
                        device=DEVICE)
    labels = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen, device=DEVICE)
    leaves = [t.requires_grad_() for t in spmd.leaves(params)]
    torch.cuda.reset_peak_memory_stats()
    loss, step_ms = grad_step_ms(lambda: vit.loss_fn(params, images, labels, cfg), leaves)
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile_grad_step(card, "ViT-L/16 (batch 64)",
                      lambda: vit.loss_fn(params, images, labels, cfg), leaves)
    with torch.no_grad():
        logits = vit.forward(params, images, cfg)
        logits32 = vit.forward(tree_map(lambda t: t.float(), params), images,
                               dataclasses.replace(cfg, dtype=torch.float32))
    assert torch.isfinite(logits).all() and logits.shape == (VIT_BATCH, cfg.num_classes)
    diff = (logits - logits32).abs().max().item()
    rel = diff / logits32.abs().max().item()
    log(card, "ViT-L/16: loss_fn + backward (bf16)", layers=cfg.num_layers,
        hidden=cfg.hidden_size, image_size=cfg.image_size, patch=cfg.patch_size,
        batch=VIT_BATCH, param_count=sum(t.numel() for t in leaves), loss=loss,
        step_ms=step_ms, images_per_s=1e3 * VIT_BATCH / step_ms, peak_mem_gb=peak,
        logits_max_abs_gap_f32=diff, logits_rel_gap_f32=rel, rel_tol=LOGIT_REL_TOL)
    assert np.isfinite(loss) and rel <= LOGIT_REL_TOL, rel


def tiny_models_phase(card: str) -> None:
    """The tiny float32 configs on the card against the CPU, from the same
    weights: PD and speculative decoding (a random draft, and draft =
    target) give the CPU's greedy tokens exactly, and the plain engine's;
    the MoE and ViT forwards give the CPU's logits to TINY_LOGIT_ATOL."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    drafts = {"random draft": llama.init(cfg, torch.Generator().manual_seed(SEED + 7), "cpu"),
              "draft = target": params}
    mcfg, vcfg = moe.MoEConfig.tiny(), vit.ViTConfig.tiny()
    mparams = moe.init(mcfg, torch.Generator().manual_seed(SEED), "cpu")
    vparams = vit.init(vcfg, torch.Generator().manual_seed(SEED), "cpu")
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    images = torch.from_numpy(rng.random((4, vcfg.image_size, vcfg.image_size, 3), np.float32))
    reqs = [[5, 9, 13, 2, 7], [3, 3, 8], list(range(1, 40))]
    conf = dict(max_batch_size=4, max_seq_len=cfg.max_seq_len, block_size=TINY_BLOCK)
    got = {}
    for where, device in (("cpu", torch.device("cpu")), ("card", DEVICE)):
        def to(tree):
            return tree_map(lambda t: t.to(device), tree)

        plain = PagedLLMEngine(PagedLLMConfig(model_config=cfg, **conf), params=to(params),
                               device=device)
        prefiller = PagedLLMEngine(PagedLLMConfig(model_config=cfg, **conf),
                                   params=to(params), device=device)
        decoder = PagedLLMEngine(PagedLLMConfig(model_config=cfg, **conf), params=to(params),
                                 device=device)
        try:
            out = {"plain": [plain.generate_sync(r, TINY_NEW_TOKENS).token_ids for r in reqs]}
            pa.launches = 0
            handoffs = [prefiller.prefill_extract(r) for r in reqs]
            futs = [decoder.attach_sequence(h, TINY_NEW_TOKENS) for h in handoffs]
            out["PD"] = [f.result(timeout=300).token_ids for f in futs]
            out["PD launches"] = (pa.launches, decoder.stats()["decode_steps"])
        finally:
            for eng in (plain, prefiller, decoder):
                eng.shutdown()
        for label, draft in drafts.items():
            eng = SpecDecodeLLMEngine(
                SpecDecodeConfig(model_config=cfg, draft_model_config=cfg,
                                 num_speculative_tokens=SPEC_K, **conf),
                params=to(params), draft_params=to(draft), device=device)
            try:
                pa.launches = 0
                futs = [eng.generate(r, TINY_NEW_TOKENS) for r in reqs]
                out[label] = [f.result(timeout=300).token_ids for f in futs]
                stats = eng.stats()
                out[f"{label} launches"] = (pa.launches, stats["decode_steps"])
                out[f"{label} acceptance"] = stats["accepted_tokens"] / stats["proposed_tokens"]
            finally:
                eng.shutdown()
        with torch.no_grad():
            logits, aux = moe.forward(to(mparams), tokens.to(device), mcfg)
            out["moe"] = (logits.cpu(), aux.cpu())
            out["vit"] = vit.forward(to(vparams), images.to(device), vcfg).cpu()
        got[where] = out
    cpu, card_ = got["cpu"], got["card"]
    moe_err = (card_["moe"][0] - cpu["moe"][0]).abs().max().item()
    vit_err = (card_["vit"] - cpu["vit"]).abs().max().item()
    labels = ["PD", *drafts]
    log(card, "tiny float32 configs, card vs CPU: PD, speculative decoding, MoE, ViT",
        same_tokens={k: card_[k] == cpu[k] for k in ["plain", *labels]},
        same_as_plain={k: card_[k] == card_["plain"] for k in labels},
        launches_and_steps={k: {"cpu": cpu[f"{k} launches"], "card": card_[f"{k} launches"]}
                            for k in labels},
        acceptance={k: card_[f"{k} acceptance"] for k in drafts},
        moe_logits_max_abs_err=moe_err, moe_aux_card=card_["moe"][1].item(),
        moe_aux_cpu=cpu["moe"][1].item(), vit_logits_max_abs_err=vit_err,
        atol=TINY_LOGIT_ATOL)
    for k in ["plain", *labels]:
        assert card_[k] == cpu[k] and (k == "plain" or card_[k] == card_["plain"]), k
    per_step = {"PD": cfg.num_layers, **{k: (SPEC_K - 1) * cfg.num_layers for k in drafts}}
    for k, n in per_step.items():
        launches, steps = card_[f"{k} launches"]
        assert steps > 0 and launches == n * steps and cpu[f"{k} launches"][0] == 0, k
    # float32 with the same weights on both sides: no near-ties at this size
    assert cpu["draft = target acceptance"] == card_["draft = target acceptance"] == 1.0
    assert moe_err <= TINY_LOGIT_ATOL and vit_err <= TINY_LOGIT_ATOL, (moe_err, vit_err)
    torch.testing.assert_close(card_["moe"][1], cpu["moe"][1], rtol=1e-5, atol=0.0)


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
    params, kernels[0]["launches"], plain = main_path_phase(card, cfg)
    http_launches = serve_http_phase(card, cfg, params)
    tiny_http_phase(card)
    near_tie = 2 * decode_agreement_phase(card, cfg, params)
    tiny_engine_phase(card)
    # the other serving paths on the main path's weights: HTTP, PD,
    # speculative decoding, and the paged pair at the draft's shape
    paths = {"decode (main path)": kernels[0]["launches"], "HTTP serve": http_launches,
             "PD decode": pd_phase(card, cfg, params, plain, near_tie)}
    gc.collect()
    paths.update(spec_phase(card, cfg, params, plain, near_tie))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    kernels[0]["launches_by_path"] = paths
    kernels[0]["draft_shape"] = draft_kernel_phase(card, llama.LlamaConfig.llama_1b())
    t_serve = time.monotonic() - t_start

    flash = flash_kernel_phase(card)
    torch.cuda.empty_cache()
    cfg_train = llama.LlamaConfig.llama_1b()
    launches, state, step, batch, initial = trainer_phase(card, cfg_train)
    for entry in flash:
        entry["launches"] = launches[entry["name"]]
    training_agreement_phase(card, cfg_train, state.params, batch)
    initial = tree_map(lambda t: t.to(DEVICE), initial)
    f32_reference_phase(card, cfg_train, {"initial": initial, "after 5 steps": state.params},
                        batch)
    del initial
    profile_train_step(card, step, state, batch)
    kernels += flash
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    t_models = time.monotonic()
    moe_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    vit_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    tiny_models_phase(card)
    log(card, "smoke wall", seconds=time.monotonic() - t_start, serving_seconds=t_serve,
        moe_vit_tiny_seconds=time.monotonic() - t_models,
        param_count_serving=llama.param_count_analytic(cfg),
        param_count_training=llama.param_count_analytic(cfg_train))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
