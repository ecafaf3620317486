"""Paged decode attention: wrapper over the Hopper kernel, and its plain version.

Replaces ``ray_tpu/ops/paged_attention.py::_decode_kernel``, the Pallas TPU
kernel on the serving decode path (``forward_paged`` with S == 1). One
query token per sequence attends over a KV cache kept in pages scattered
through a pool; a block table maps each sequence block to its page.

The kernel is ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a, built by
``_build``). It is bound by bytes: it must read ``sum(lengths) * Hkv * D *
2`` K/V elements once and does about ``4 * Hq * D`` flops per cached token,
far below what the card computes per byte moved. Its design, one CTA per
(sequence, kv head) looping over that sequence's live pages with the float32
online softmax kept on chip, is described in the source.

``paged_decode_attention`` runs the kernel on CUDA tensors and raises on
anything it cannot take; CPU tensors go to ``paged_decode_attention_ref``,
the same computation in plain PyTorch. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

launches = 0  # kernel launches by paged_decode_attention, for path checks

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8
_MAX_BLOCK_SIZE = 64


def paged_decode_attention_ref(q, k_pages, v_pages, tables, lengths):
    """Plain PyTorch version: gather each sequence's pages, float32 scores,
    positions >= lengths[b] masked, softmax with the kernel's dead-row rule
    (a row with no live key gives zeros), output in q's dtype."""
    B, Hq, D = q.shape
    Hkv, _, BS, _ = k_pages.shape
    max_blocks = tables.shape[1]
    g = Hq // Hkv
    idx = tables.long()
    # [Hkv, B, max_blocks, BS, D] -> [B, Hkv, max_blocks * BS, D]
    k = k_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, Hkv, max_blocks * BS, D).float()
    v = v_pages[:, idx].permute(1, 0, 2, 3, 4).reshape(B, Hkv, max_blocks * BS, D).float()
    q4 = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", q4, k) * (1.0 / math.sqrt(D))
    kpos = torch.arange(max_blocks * BS, device=q.device)
    s = torch.where(kpos[None, None, None, :] < lengths.long()[:, None, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    alive = (m > NEG_INF / 2).float()
    p = torch.exp(s - m * alive) * alive
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v) / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)


def _check(q, k_pages, v_pages, tables, lengths):
    B, Hq, D = q.shape
    Hkv, _, BS, Dk = k_pages.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q, k_pages and v_pages must share a dtype")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: tables and lengths must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be 16-byte aligned")
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"paged_decode_attention: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {D} not in {_HEAD_DIMS}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= _MAX_GROUP:
        raise ValueError(f"paged_decode_attention: Hq {Hq} must be 1..{_MAX_GROUP} "
                         f"times Hkv {Hkv}")
    if BS % 8 or not 8 <= BS <= _MAX_BLOCK_SIZE:
        raise ValueError(f"paged_decode_attention: block size {BS} must be a multiple "
                         f"of 8 in 8..{_MAX_BLOCK_SIZE}")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"paged_decode_attention: tables {tuple(tables.shape)} and "
                         f"lengths {tuple(lengths.shape)} do not match batch {B}")


def paged_decode_attention(q, k_pages, v_pages, tables, lengths):
    """q [B, Hq, D]; k/v_pages [Hkv, NB, BS, D]; tables [B, max_blocks] int32
    (pool block id per sequence block; unused entries must be valid ids,
    their reads are masked); lengths [B] int32 = valid KV tokens, including
    the token being decoded. Returns [B, Hq, D] in q's dtype."""
    global launches
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pages, v_pages, tables, lengths)
    _check(q, k_pages, v_pages, tables, lengths)
    B, Hq, D = q.shape
    Hkv, NB, BS, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = _build.load("paged_attention").paged_decode_attention_launch
    if fn.argtypes is None:  # pointers and the stream as void*, sizes as int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), B, Hkv, NB, BS, tables.shape[1],
                Hq // Hkv, D, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed (cudaError {rc})")
    launches += 1
    return out
