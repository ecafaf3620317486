"""Flash attention, forward and backward: wrappers over the Hopper kernels,
their plain versions, and the autograd Function that joins them.

Replaces the three Pallas TPU kernels of ``ray_tpu/ops/flash_attention.py``
on the training path (``llama.forward`` -> ``auto_attention`` ->
``flash_attention``):

- ``_fwd_kernel`` (``:33``): blockwise attention with the online softmax,
  writing O and the row logsumexp (lse);
- ``_bwd_dq_kernel`` (``:102``): dQ = sum_k dS K;
- ``_bwd_dkv_kernel`` (``:136``): dV = sum_q P^T dO, dK = sum_q dS^T Q;

with P = exp(S * scale - lse) and dS = P * (dO V^T - delta) * scale, where
delta = rowsum(dO * O) is plain PyTorch outside the kernels, as JAX
computes it outside Pallas. The kernels are ``csrc/flash_attention.cu``
(CUDA C++ for sm_90a, built by ``_build``). At training shapes all three
are bound by operations; the source says what its design does about it.

Layouts follow the model: q ``[B, S, Hq, D]``, k/v ``[B, S, Hkv, D]`` with
Hq a multiple of Hkv (GQA: query head h reads kv head h // (Hq // Hkv)),
lse and delta ``[B, Hq, S]`` float32. The kernels read q/k/v/dO through
their strides, so the model's tensors go in without a copy, and mask the
ragged sequence edge themselves: no KV repeat and no sequence padding.

The kernels are built for head dims 64 and 128. Any other multiple of 8 up
to 128 is zero-padded to the next of the two (``pad_head_dim``, one copy of
each input) and the outputs are sliced back: zero columns leave Q K^T
unchanged and give zero columns of O, dQ, dK and dV, so the result is exact
as long as the scale stays 1/sqrt of the caller's head dim, which the
launchers are given.

Each of ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` runs its
kernel on CUDA tensors and raises on anything the kernel cannot take; CPU
tensors go to the plain version (``*_ref``), the same arithmetic in float32
PyTorch with the reference's rules: ``NEG_INF`` is the finite -1e30, a row
is alive while its max is above ``NEG_INF / 2``, and a row with no live key
gives zeros and an lse of ``NEG_INF``. ``fwd_launches``,
``bwd_dq_launches`` and ``bwd_dkv_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build

NEG_INF = -1e30

fwd_launches = 0      # kernel launches by flash_fwd, for path checks
bwd_dq_launches = 0   # ... by flash_bwd_dq
bwd_dkv_launches = 0  # ... by flash_bwd_dkv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)  # what the kernels are built for; others are padded


# ---------------------------------------------------------------- plain versions
def _grouped(x, hkv):
    """[B, S, Hq, D] -> float32 [B, S, Hkv, g, D]."""
    B, S, Hq, D = x.shape
    return x.float().reshape(B, S, hkv, Hq // hkv, D)


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _scores(q, k, causal, scale=None):
    """Scaled float32 scores [B, Hkv, g, S, S], causal mask applied."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(q, k.shape[2]), k.float())
    s = s * _scale(q, scale)
    if causal:
        i = torch.arange(q.shape[1], device=q.device)
        s = torch.where(i[:, None] >= i[None, :], s, NEG_INF)
    return s


def _recompute_p(q, k, lse, causal, scale=None):
    """P = exp(S - lse) with the causal mask and dead rows zeroed: one
    definition for dQ and dK/dV, as ``_recompute_p`` (``:87``) is for the
    TPU kernels."""
    B, S, Hq, _ = q.shape
    Hkv = k.shape[2]
    lse = lse.reshape(B, Hkv, Hq // Hkv, S)[..., None]
    alive = (lse > NEG_INF / 2).float()
    return torch.exp(_scores(q, k, causal, scale) - lse * alive) * alive


def _ungroup(x, like):
    """[B, Hkv, g, S, D] -> [B, S, Hq, D] in ``like``'s dtype."""
    B, Hkv, g, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * g, D).to(like.dtype)


def flash_fwd_ref(q, k, v, causal, scale=None):
    """Plain version of the forward kernel: (o [B,S,Hq,D] in q's dtype,
    lse [B,Hq,S] float32). ``scale`` defaults to 1/sqrt(D)."""
    B, S, Hq, _ = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    alive = (m > NEG_INF / 2).float()
    p = torch.exp(s - m * alive) * alive
    l = p.sum(dim=-1, keepdim=True)
    o = p @ v.float().permute(0, 2, 1, 3)[:, :, None] / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), NEG_INF)
    return _ungroup(o, q), lse.reshape(B, Hq, S)


def _ds(q, k, v, do, lse, delta, causal, scale):
    """(P, dS), both [B, Hkv, g, S, S] float32."""
    B, S, Hq, _ = q.shape
    Hkv = k.shape[2]
    p = _recompute_p(q, k, lse, causal, scale)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(do, Hkv), v.float())
    delta = delta.reshape(B, Hkv, Hq // Hkv, S)[..., None]
    return p, p * (dp - delta) * _scale(q, scale)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale=None):
    """Plain version of the dQ kernel: dq [B,S,Hq,D] in q's dtype."""
    _, ds = _ds(q, k, v, do, lse, delta, causal, scale)
    return _ungroup(ds @ k.float().permute(0, 2, 1, 3)[:, :, None], q)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale=None):
    """Plain version of the dK/dV kernel: (dk, dv) [B,S,Hkv,D], summed over
    each kv head's query group, in k's and v's dtypes."""
    p, ds = _ds(q, k, v, do, lse, delta, causal, scale)
    Hkv = k.shape[2]
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, _grouped(do, Hkv))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, _grouped(q, Hkv))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------- kernel wrappers
def _check(name, q, k, v, *same_as_q):
    """Validate what the kernels take; returns (B, S, Hq, Hkv, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k and v must be [B, S, H, D]")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    for t in (k, v, *same_as_q):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: all of q, k, v (and dO) must be {q.dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: a tensor is on {t.device}, q on {q.device}")
    if tuple(k.shape) != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    for t in same_as_q:
        if t.shape != q.shape:
            raise ValueError(f"{name}: dO {tuple(t.shape)} does not match q {tuple(q.shape)}")
    if not 0 < D <= _KERNEL_HEAD_DIMS[-1] or D % 8:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 up to "
                         f"{_KERNEL_HEAD_DIMS[-1]}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{name}: Hq {Hq} is not a multiple of Hkv {Hkv}")
    if Hq > 65535 or B > 65535:
        raise ValueError(f"{name}: batch {B} and heads {Hq} must be at most 65535")
    return B, S, Hq, Hkv, D


def kernel_head_dim(D):
    """The head dim the kernels run for a caller's D: the next of 64, 128."""
    return next(d for d in _KERNEL_HEAD_DIMS if d >= D)


def pad_head_dim(x, D):
    """``x`` zero-padded along its last dim to ``D``; ``x`` itself when it
    has that size already. Used with the caller's scale, the padded call
    sliced back to the caller's head dim is exact (see the module doc)."""
    return x if x.shape[-1] == D else F.pad(x, (0, D - x.shape[-1]))


def _rowstats(name, t, B, Hq, S, device):
    if t.dtype != torch.float32 or tuple(t.shape) != (B, Hq, S) or t.device != device:
        raise ValueError(f"{name}: lse and delta must be float32 [B, Hq, S] = "
                         f"{(B, Hq, S)} on {device}")
    return t.contiguous()


def _strided(t):
    """``t`` itself when the kernels can read it through its strides (unit
    stride over D, 16-byte aligned base and rows), else a contiguous copy.
    The model's q/k/v and their gradients are always read in place."""
    item = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            (s * item) % 16 == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def _launch(fn_name, tensors, strided, dims):
    """Call one C launcher: pointers, the [b, s, h] strides of the tensors in
    ``strided``, then the int dims and the current stream."""
    fn = getattr(_build.load("flash_attention"), fn_name)
    if fn.argtypes is None:  # pointers and the stream as void*, strides by pointer
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * len(dims) + [ctypes.c_void_p])
    strides = [s for t in strided for s in t.stride()[:3]]
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), (ctypes.c_longlong * len(strides))(*strides),
                *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: kernel launch failed (cudaError {rc})")


def flash_fwd(q, k, v, causal):
    """Forward kernel: (o [B,S,Hq,D] in q's dtype, lse [B,Hq,S] float32)."""
    global fwd_launches
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, causal)
    B, S, Hq, Hkv, D = _check("flash_fwd", q, k, v)
    Dk = kernel_head_dim(D)
    q, k, v = (_strided(pad_head_dim(x, Dk)) for x in (q, k, v))
    o = torch.empty(B, S, Hq, Dk, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, Hq, S, dtype=torch.float32, device=q.device)
    if o.numel():
        _launch("flash_fwd_launch", [q, k, v, o, lse], [q, k, v, o],
                [B, S, Hkv, Hq // Hkv, Dk, int(causal), _DTYPES[q.dtype], D])
        fwd_launches += 1
    return o[..., :D], lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal):
    """dQ kernel: dq [B,S,Hq,D] in q's dtype."""
    global bwd_dq_launches
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal)
    B, S, Hq, Hkv, D = _check("flash_bwd_dq", q, k, v, do)
    lse = _rowstats("flash_bwd_dq", lse, B, Hq, S, q.device)
    delta = _rowstats("flash_bwd_dq", delta, B, Hq, S, q.device)
    Dk = kernel_head_dim(D)
    q, k, v, do = (_strided(pad_head_dim(x, Dk)) for x in (q, k, v, do))
    dq = torch.empty(B, S, Hq, Dk, dtype=q.dtype, device=q.device)
    if dq.numel():
        _launch("flash_bwd_dq_launch", [q, k, v, do, lse, delta, dq], [q, k, v, do, dq],
                [B, S, Hkv, Hq // Hkv, Dk, int(causal), _DTYPES[q.dtype], D])
        bwd_dq_launches += 1
    return dq[..., :D]


def flash_bwd_dkv(q, k, v, do, lse, delta, causal):
    """dK/dV kernel: (dk, dv) [B,S,Hkv,D], summed over each group."""
    global bwd_dkv_launches
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
    B, S, Hq, Hkv, D = _check("flash_bwd_dkv", q, k, v, do)
    lse = _rowstats("flash_bwd_dkv", lse, B, Hq, S, q.device)
    delta = _rowstats("flash_bwd_dkv", delta, B, Hq, S, q.device)
    Dk = kernel_head_dim(D)
    q, k, v, do = (_strided(pad_head_dim(x, Dk)) for x in (q, k, v, do))
    dk = torch.empty(B, S, Hkv, Dk, dtype=k.dtype, device=k.device)
    dv = torch.empty(B, S, Hkv, Dk, dtype=v.dtype, device=v.device)
    if dk.numel():
        _launch("flash_bwd_dkv_launch", [q, k, v, do, lse, delta, dk, dv],
                [q, k, v, do, dk, dv],
                [B, S, Hkv, Hq // Hkv, Dk, int(causal), _DTYPES[q.dtype], D])
        bwd_dkv_launches += 1
    return dk[..., :D], dv[..., :D]


# ---------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``custom_vjp`` (``:231``): the forward
    saves q, k, v, o and lse; the backward forms delta = rowsum(dO * O) in
    float32 and runs the dQ and dK/dV calls."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Drop-in ``attn_fn`` for ``models.llama``: q [B,S,Hq,D], k/v
    [B,S,Hkv,D] (GQA) -> [B,S,Hq,D], differentiable through the kernels."""
    return _FlashAttention.apply(q, k, v, causal)
