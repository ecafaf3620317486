"""Llama-family transformer in PyTorch: the serving path of ray_tpu.models.llama.

The parameter tree keeps the JAX package's layout, so weights convert with
no transposes (``from_jax``): a dict with ``embed [V, h]``, ``final_norm
[h]``, ``lm_head [h, V]`` (untied configs) and ``layers``, whose entries are
stacked over a leading ``[L, ...]`` axis and applied as ``x @ W`` with ``W``
``[in, out]``. Norm weights are float32; everything else is ``cfg.dtype``.

Numerics follow the reference op for op: RMSNorm accumulates in float32,
rotary embeddings rotate split halves with float32 angles, attention scores
and softmax are float32 and the probabilities are cast back to the query's
dtype before the PV product, logits come out in float32.

Unlike the JAX functions, which return new caches, ``forward_paged`` and
``forward_with_cache`` write the new K/V into the pool or cache they are
given, in place, and hand the same dict back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops.paged_attention import paged_decode_attention

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    # ---- presets (sizes per public Llama/GPT specs) ----
    @staticmethod
    def tiny() -> "LlamaConfig":  # for tests
        return LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
            num_heads=4, num_kv_heads=2, max_seq_len=128, dtype=torch.float32,
            remat=False,
        )

    @staticmethod
    def gpt2_124m() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=50257, hidden_size=768, intermediate_size=3072, num_layers=12,
            num_heads=12, num_kv_heads=12, max_seq_len=1024, rope_theta=10000.0,
            tie_embeddings=True,
        )

    @staticmethod
    def llama_1b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192, num_layers=16,
            num_heads=32, num_kv_heads=8, head_dim=64, max_seq_len=8192,
        )

    @staticmethod
    def llama_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336, num_layers=32,
            num_heads=32, num_kv_heads=8, max_seq_len=8192,
        )

    @staticmethod
    def llama_70b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672, num_layers=80,
            num_heads=64, num_kv_heads=8, max_seq_len=8192,
        )


# ---------------------------------------------------------------- params
def init(cfg: LlamaConfig, generator: torch.Generator, device=None) -> dict:
    """Scaled-normal init in the JAX tree layout, drawn from ``generator``
    (which must live on ``device``). Stacked ``[L, ...]`` weights are drawn
    one layer at a time, so the float32 draw never exceeds one layer."""
    device = resolve_device(device)
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def draw(fan_in, shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(cfg.dtype)

    def dense(fan_in, *shape):
        if len(shape) == 2:
            return draw(fan_in, shape)
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for i in range(shape[0]):
            out[i] = draw(fan_in, shape[1:])
        return out

    layers = {
        "attn_norm": torch.ones(L, h, dtype=torch.float32, device=device),
        "wq": dense(h, L, h, nh * hd),
        "wk": dense(h, L, h, nkv * hd),
        "wv": dense(h, L, h, nkv * hd),
        "wo": dense(nh * hd, L, nh * hd, h),
        "mlp_norm": torch.ones(L, h, dtype=torch.float32, device=device),
        "w_gate": dense(h, L, h, m),
        "w_up": dense(h, L, h, m),
        "w_down": dense(m, L, m, h),
    }
    params = {
        "embed": dense(h, cfg.vocab_size, h),
        "layers": layers,
        "final_norm": torch.ones(h, dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(h, h, cfg.vocab_size)
    return params


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: arrays exported by jax are read-only
    if a.dtype.name == "bfloat16":  # numpy has no bf16: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax(params_np: dict, cfg: LlamaConfig, device=None) -> dict:
    """The JAX param dict (numpy arrays, e.g. ``jax.tree.map(np.asarray,
    params)``) as the port's tensors. The layouts match, so nothing is
    transposed; arrays are cast to ``cfg.dtype`` except the float32 norms."""
    device = resolve_device(device)

    def conv(name, a):
        t = _to_torch(a, device)
        return t.float() if name.endswith("norm") else t.to(cfg.dtype)

    out = {k: conv(k, v) for k, v in params_np.items() if k != "layers"}
    out["layers"] = {k: conv(k, v) for k, v in params_np["layers"].items()}
    return out


def param_count_analytic(cfg: LlamaConfig) -> int:
    h, m, L, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.vocab_size
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    per_layer = h * nh * hd + 2 * h * nkv * hd + nh * hd * h + 3 * h * m + 2 * h
    total = v * h + L * per_layer + h
    if not cfg.tie_embeddings:
        total += h * v
    return total


# ---------------------------------------------------------------- ops
def rms_norm(x, weight, eps):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope(x, positions, theta):
    """Rotary embedding over split halves; x: [B, S, H, D], positions [B, S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mlp(x, layer, cfg: LlamaConfig, i: int):
    y = rms_norm(x, layer["mlp_norm"][i], cfg.rms_eps)
    gate = F.silu(y @ layer["w_gate"][i])
    return x + ((gate * (y @ layer["w_up"][i])) @ layer["w_down"][i])


def _qkv(x, layer, cfg: LlamaConfig, i: int, positions):
    B, S, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    y = rms_norm(x, layer["attn_norm"][i], cfg.rms_eps)
    q = (y @ layer["wq"][i]).reshape(B, S, nh, hd)
    k = (y @ layer["wk"][i]).reshape(B, S, nkv, hd)
    v = (y @ layer["wv"][i]).reshape(B, S, nkv, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _logits(params, x, cfg: LlamaConfig):
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(cfg.dtype)).float()


def _cached_attention(q, k_cache, v_cache, lengths, q_positions):
    """q: [B,S,Hq,D]; caches [B,Smax,Hkv,D]; lengths [B] = valid KV prefix."""
    B, S, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float() / math.sqrt(D)
    kpos = torch.arange(Smax, device=q.device)
    valid = kpos[None, None, None, None, :] <= q_positions[:, None, None, :, None]
    valid &= kpos[None, None, None, None, :] < (lengths + S)[:, None, None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache)
    return out.reshape(B, S, Hq, D)


# ---------------------------------------------------------------- KV-cached inference
def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device=None) -> dict:
    """Dense per-slot KV cache: [L, B, S, Hkv, D] per k/v."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def init_kv_pool(cfg: LlamaConfig, num_blocks: int, block_size: int, device=None) -> dict:
    """Paged KV pool: [L, Hkv, N_blocks, block_size, D] per k/v. Head-major,
    so a (head, block) pair is one contiguous [block_size, D] page for the
    decode kernel (ops/paged_attention.py)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, cfg.num_kv_heads, num_blocks, block_size, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def forward_paged(params, tokens, cfg: LlamaConfig, pool: dict, tables, lengths,
                  block_size: int, use_kernel: bool | None = None):
    """Cached forward over a PAGED pool. tokens [B,S] append at positions
    [lengths, lengths+S); tables [B, max_blocks] int32 map sequence-block
    index -> pool block id. Returns (logits [B,S,V] float32, pool).

    The new K/V are written into ``pool`` in place (the JAX version donates
    the pool and returns a new one). Positions past the table (bucket padding
    of a near-full sequence) write into the reserved garbage block 0. The
    decode step (S == 1) on a CUDA tensor runs the paged-attention kernel,
    which reads pages in place through the table; otherwise attention reads
    a gathered per-sequence view (pool[:, tables])."""
    B, S = tokens.shape
    max_blocks = tables.shape[1]
    if use_kernel is None:
        use_kernel = S == 1 and tokens.is_cuda
    dev = tokens.device
    positions = lengths[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    seq_blk = (positions // block_size).long()
    # torch does not clamp an out-of-range gather the way jax does: zero the
    # index first, then route those positions to block 0
    oob = seq_blk >= max_blocks
    rows = torch.arange(B, device=dev)[:, None]
    table_idx = tables.long()
    blk_idx = table_idx[rows, torch.where(oob, 0, seq_blk)]
    blk_idx = torch.where(oob, 0, blk_idx)  # [B,S]
    blk_off = (positions % block_size).long()
    x = params["embed"][tokens.long()].to(cfg.dtype)
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    layer = params["layers"]
    for i in range(cfg.num_layers):
        kp, vp = pool["k"][i], pool["v"][i]  # [Hkv, NB, BS, D] views
        q, k, v = _qkv(x, layer, cfg, i, positions)
        # head-major scatter: kp[h, blk_idx[b,s], blk_off[b,s]] = k[b,s,h]
        kp[:, blk_idx, blk_off] = k.permute(2, 0, 1, 3).to(kp.dtype)
        vp[:, blk_idx, blk_off] = v.permute(2, 0, 1, 3).to(vp.dtype)
        if use_kernel:
            o = paged_decode_attention(q[:, 0].contiguous(), kp, vp, tables,
                                       lengths + 1)[:, None]  # [B,1,Hq,D]
        else:
            k_seq = kp[:, table_idx].permute(1, 2, 3, 0, 4).reshape(
                B, max_blocks * block_size, nkv, hd)
            v_seq = vp[:, table_idx].permute(1, 2, 3, 0, 4).reshape(
                B, max_blocks * block_size, nkv, hd)
            o = _cached_attention(q, k_seq, v_seq, lengths, positions)
        x = x + (o.reshape(B, S, nh * hd) @ layer["wo"][i])
        x = _mlp(x, layer, cfg, i)
    return _logits(params, x, cfg), pool


def _write_cache(cache_l, new, lengths):
    """Write new [B,S,H,D] at per-row offsets lengths[b] of cache [B,Smax,H,D],
    in place. The start is clamped to Smax - S, as jax's
    dynamic_update_slice clamps it."""
    B, S = new.shape[:2]
    start = lengths.long().clamp(0, cache_l.shape[1] - S)
    cols = start[:, None] + torch.arange(S, device=new.device)[None, :]
    cache_l[torch.arange(B, device=new.device)[:, None], cols] = new.to(cache_l.dtype)
    return cache_l


def forward_with_cache(params, tokens, cfg: LlamaConfig, cache: dict, lengths):
    """Append ``tokens`` [B,S] at positions [lengths, lengths+S) of the dense
    cache (written in place) and return (logits [B,S,V] float32, cache).
    Works for prefill (S=prompt, lengths=0) and decode (S=1)."""
    B, S = tokens.shape
    positions = lengths[:, None] + torch.arange(S, dtype=torch.int32,
                                                device=tokens.device)[None, :]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    nh, hd = cfg.num_heads, cfg.hd
    layer = params["layers"]
    for i in range(cfg.num_layers):
        q, k, v = _qkv(x, layer, cfg, i, positions)
        k_cache = _write_cache(cache["k"][i], k, lengths)
        v_cache = _write_cache(cache["v"][i], v, lengths)
        o = _cached_attention(q, k_cache, v_cache, lengths, positions)
        x = x + (o.reshape(B, S, nh * hd) @ layer["wo"][i])
        x = _mlp(x, layer, cfg, i)
    return _logits(params, x, cfg), cache
