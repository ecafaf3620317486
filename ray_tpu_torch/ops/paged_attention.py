"""Paged decode attention: wrapper over the Hopper kernel, and its plain version.

Replaces ``ray_tpu/ops/paged_attention.py::_decode_kernel``, the Pallas TPU
kernel on the serving decode path (``forward_paged`` with S == 1). One
query token per sequence attends over a KV cache kept in pages scattered
through a pool; a block table maps each sequence block to its page.

The kernel is ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a, built by
``_build``). It is bound by bytes: it must read ``sum(lengths) * Hkv * D *
2`` K/V elements once and does about ``4 * Hq * D`` flops per cached token,
far below what the card computes per byte moved. Its design is split-K
flash-decoding, described in the source: each CTA takes one run of
``pages_per_split`` pages of a sequence for all query heads of a kv head and
writes a float32 partial (m, l, acc) to a workspace; a second kernel merges
the live splits of each row. ``paged_decode_attention_split_ref`` is that
split and merge in plain PyTorch, for the tests.

``paged_decode_attention`` runs the kernel on CUDA tensors and raises on
anything it cannot take; CPU tensors go to ``paged_decode_attention_ref``,
the same computation in plain PyTorch. ``launches`` counts wrapper calls
that launched the kernel pair. It reads nothing back from the card: the
number of splits comes from the table's width, not from ``lengths``.

Shapes: any head dim in 1..256 (``check_shape`` raises outside it, so an
engine can refuse a model up front with the kernel's own message), any
group and any page size:

- the kernel is built for head dims 16, 32, 48, 64, 80, 96, 128 and 256; a
  head dim between them runs on the next one up (``kernel_head_dim``) with
  the caller's head dim passed at run time: the kernel steps through the
  pool's rows of that many values, copies each row in the widest aligned
  pieces its length allows, zero-fills the columns above it in shared
  memory, scales by 1/sqrt of it and writes that many output columns. The
  pool is not padded, so a PD handoff carries the model's own head dim.

- a group above 8 query heads a kv head is cut into chunks of at most 8 on
  the kernel's grid (``Hkv * n_chunks`` CTAs along y, one launch pair),
  rather than by the wrapper launching the kernel once a chunk over slices
  of ``q.view(B, Hkv, g, D)``: the slices are not contiguous, so each launch
  would copy its q chunk in and its output out, and a group of 16 or 32
  would cost 2 or 4 launch pairs where the split tile already costs two.
  On the grid q and out are read and written in place and registers stay
  those of a group of 8; each chunk's CTAs read the kv head's pages again,
  mostly from L2.
- a page above 64 tokens is served as ``r`` contiguous sub-pages of the
  largest size at most 64 that divides it (``as_sub_pages``): the pool
  ``[Hkv, NB, BS, D]`` is viewed as ``[Hkv, NB * r, BS / r, D]`` without a
  copy and table entry ``t`` becomes ``t * r + j``, one small int32 op (one
  elementwise launch) a call; the kernel itself does not change.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

launches = 0  # kernel launches by paged_decode_attention, for path checks
# serve replicas' engines launch from their own threads
_launches_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 256)
_MAX_GROUP = 8  # query heads one CTA serves; a larger group is cut into chunks
_MAX_BLOCK_SIZE = 64  # tokens of a page the kernel reads; larger pages are cut


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


def paged_decode_attention_split_ref(q, k_pages, v_pages, tables, lengths, pages_per_split):
    """The kernel's split and merge in plain PyTorch: the query heads of each
    kv head cut into chunks of at most ``_MAX_GROUP`` (one CTA each), the
    keys of each row cut into runs of ``pages_per_split`` pages, each live
    run's float32 partial (m, l, acc) with the reference's rules, and the
    merge out = sum_s e^(m_s - m*) acc_s / max(sum_s e^(m_s - m*) l_s, 1e-30)
    over the live runs, m* = max_s m_s. A run is live when its first page
    holds a position < lengths[b]; a row with none gives zeros."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[0]
    g = Hq // Hkv
    q4 = q.reshape(B, Hkv, g, D)
    out = [_split_ref_chunk(q4[:, :, h0:h0 + _MAX_GROUP], k_pages, v_pages, tables, lengths,
                            pages_per_split) for h0 in range(0, g, _MAX_GROUP)]
    return torch.cat(out, dim=2).reshape(B, Hq, D).to(q.dtype)


def _split_ref_chunk(q4, k_pages, v_pages, tables, lengths, pages_per_split):
    """One chunk of query heads, q4 [B, Hkv, gc, D]: the split partials and
    their merge, float32 [B, Hkv, gc, D]."""
    B, Hkv, _, D = q4.shape
    BS = k_pages.shape[2]
    max_blocks = tables.shape[1]
    n_splits = -(-max_blocks // pages_per_split)
    T = pages_per_split * BS
    pad = n_splits * pages_per_split - max_blocks  # the last run's missing pages
    idx = torch.cat([tables.long(), tables.new_zeros(B, pad).long()], dim=1)

    def runs(pages):  # [B, Hkv, n_splits, T, D] in float32
        x = pages[:, idx].permute(1, 0, 2, 3, 4).float()
        return x.reshape(B, Hkv, n_splits, T, D)

    k, v = runs(k_pages), runs(v_pages)
    s = torch.einsum("bhgd,bhstd->bhgst", q4.float(), k) * (1.0 / math.sqrt(D))
    kpos = torch.arange(n_splits * T, device=q4.device).reshape(n_splits, T)
    lens = lengths.long()[:, None, None, None, None]
    s = torch.where(kpos < torch.clamp(lens, max=max_blocks * BS), s, NEG_INF)
    m = s.amax(dim=-1)                                    # [B, Hkv, g, n_splits]
    alive = (m > NEG_INF / 2).float()
    p = torch.exp(s - (m * alive)[..., None]) * alive[..., None]
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgst,bhstd->bhgsd", p, v)
    live = (torch.arange(n_splits, device=q4.device) * T)[None, :] < lengths.long()[:, None]
    live = live[:, None, None, :]                         # [B, 1, 1, n_splits]
    m = torch.where(live, m, NEG_INF)
    m_star = m.amax(dim=-1, keepdim=True)
    row_alive = (m_star > NEG_INF / 2).float()
    w = torch.exp(m - m_star * row_alive) * row_alive * live.float()
    return (w[..., None] * acc).sum(dim=-2) / torch.clamp((w * l).sum(dim=-1),
                                                          min=1e-30)[..., None]


def check_shape(Hq, Hkv, D, block_size):
    """Raise ValueError unless the kernel takes this head dim (1..256), group
    (Hq // Hkv, any whole number) and page size (any)."""
    if not 0 < D <= _HEAD_DIMS[-1]:
        raise ValueError(f"paged_decode_attention: head dim {D} must be in "
                         f"1..{_HEAD_DIMS[-1]}")
    if Hkv < 1 or Hq < Hkv or Hq % Hkv:
        raise ValueError(f"paged_decode_attention: Hq {Hq} must be a whole number of "
                         f"times Hkv {Hkv}")
    if block_size < 1:
        raise ValueError(f"paged_decode_attention: block size {block_size} must be >= 1")


def kernel_head_dim(D: int) -> int:
    """The head dim of the kernel that serves a caller's ``D``: the next
    instantiated one at or above it."""
    return next(d for d in _HEAD_DIMS if d >= D)


def sub_page_size(block_size: int) -> int:
    """The page size the kernel reads a ``block_size`` page as: the largest
    divisor of ``block_size`` that is at most 64 (itself up to 64)."""
    return next(d for d in range(min(block_size, _MAX_BLOCK_SIZE), 0, -1)
                if block_size % d == 0)


def as_sub_pages(k_pages, v_pages, tables):
    """Pages of ``BS`` tokens as ``r = BS / sub_page_size(BS)`` contiguous
    sub-pages each: the pools viewed as ``[Hkv, NB * r, BS / r, D]`` (no
    copy) and each table entry ``t`` replaced by ``t * r .. t * r + r - 1``,
    so ``tables`` [B, max_blocks] becomes [B, max_blocks * r]. The inputs
    themselves when ``r`` is 1."""
    Hkv, NB, BS, D = k_pages.shape
    sub = sub_page_size(BS)
    r = BS // sub
    if r == 1:
        return k_pages, v_pages, tables
    j = _sub_page_offsets(r, tables.dtype, tables.device)
    sub_tables = torch.add(j, tables[:, :, None], alpha=r).reshape(tables.shape[0], -1)
    return (k_pages.view(Hkv, NB * r, sub, D), v_pages.view(Hkv, NB * r, sub, D), sub_tables)


@functools.lru_cache(maxsize=None)
def _sub_page_offsets(r: int, dtype, device) -> torch.Tensor:
    """0 .. r - 1, made once per device: the transform is then one launch."""
    return torch.arange(r, dtype=dtype, device=device)


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
    check_shape(Hq, Hkv, D, BS)
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"paged_decode_attention: tables {tuple(tables.shape)} and "
                         f"lengths {tuple(lengths.shape)} do not match batch {B}")


@functools.lru_cache(maxsize=None)
def _split_pages(lib, block_size, head_dim, dtype) -> int:
    """The library's split tile in pages (a compile-time constant per block
    size, head dim and dtype)."""
    fn = lib.paged_decode_split_pages
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int] * 3
    pages = fn(block_size, head_dim, _DTYPES[dtype])
    if pages < 1:
        raise ValueError(f"paged_decode_attention: no split tile for block size "
                         f"{block_size}, head dim {head_dim}, {dtype}")
    return pages


def pages_per_split(block_size, head_dim, dtype) -> int:
    """Pages one CTA of the kernel takes at this page size (at most 64: a
    larger page is read as ``sub_page_size`` pages), head dim (that of the
    kernel serving it) and dtype (builds the kernel if it is not built)."""
    return _split_pages(_build.load("paged_attention"), block_size,
                        kernel_head_dim(head_dim), dtype)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths):
    """q [B, Hq, D]; k/v_pages [Hkv, NB, BS, D]; tables [B, max_blocks] int32
    (pool block id per sequence block; unused entries must be valid ids,
    their reads are masked); lengths [B] int32 = valid KV tokens, including
    the token being decoded. Returns [B, Hq, D] in q's dtype."""
    global launches
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pages, v_pages, tables, lengths)
    _check(q, k_pages, v_pages, tables, lengths)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    k_pages, v_pages, tables = as_sub_pages(k_pages, v_pages, tables)
    B, Hq, D = q.shape
    Hkv, NB, BS, _ = k_pages.shape
    lib = _build.load("paged_attention")
    max_blocks = tables.shape[1]
    Dk = kernel_head_dim(D)
    n_splits = -(-max_blocks // _split_pages(lib, BS, Dk, q.dtype))
    workspace = torch.empty(B * Hq * n_splits * (Dk + 2), dtype=torch.float32, device=q.device)
    fn = lib.paged_decode_attention_launch
    if fn.argtypes is None:  # pointers and the stream as void*, sizes as int
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), workspace.data_ptr(), B, Hkv, NB, BS,
                max_blocks, n_splits, Hq // Hkv, Dk, D, _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed (cudaError {rc})")
    with _launches_lock:
        launches += 1
    return out
