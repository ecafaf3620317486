"""Vision Transformer (ViT) family in PyTorch (port of ray_tpu/models/vit.py).

Patchify is a reshape and transpose followed by one matmul (no conv op);
the blocks are pre-LN non-causal attention (``llama.attention(causal=False)``)
and a GELU MLP (the tanh approximation, ``jax.nn.gelu``'s default). The
parameter tree keeps the reference's layout: stacked ``[L, ...]`` layer
leaves, float32 LayerNorm scales and biases, everything else ``cfg.dtype``.
LayerNorm takes its statistics in float32 and casts back; the logits come
out in float32. ``cfg.remat`` recomputes each block in the backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    num_classes: int = 1000
    dtype: Any = torch.bfloat16
    remat: bool = True
    ln_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def hd(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_classes=10, dtype=torch.float32, remat=False)

    @staticmethod
    def vit_b16() -> "ViTConfig":
        return ViTConfig(hidden_size=768, intermediate_size=3072, num_layers=12,
                         num_heads=12)

    @staticmethod
    def vit_l16() -> "ViTConfig":
        return ViTConfig()  # defaults are ViT-L/16


def init(cfg: ViTConfig, generator: torch.Generator, device=None) -> dict:
    """Scaled-normal init in the reference's tree layout, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    patch_dim = 3 * cfg.patch_size ** 2

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def dense(fan_in, *shape):
        return (normal(*shape) / math.sqrt(fan_in)).to(cfg.dtype)

    def const(fill, *shape, dtype=torch.float32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    layers = {
        "ln1_scale": const(1.0, L, h), "ln1_bias": const(0.0, L, h),
        "wq": dense(h, L, h, h), "wk": dense(h, L, h, h),
        "wv": dense(h, L, h, h), "wo": dense(h, L, h, h),
        "ln2_scale": const(1.0, L, h), "ln2_bias": const(0.0, L, h),
        "w1": dense(h, L, h, m), "b1": const(0.0, L, m, dtype=cfg.dtype),
        "w2": dense(m, L, m, h), "b2": const(0.0, L, h, dtype=cfg.dtype),
    }
    return {
        "patch_embed": dense(patch_dim, patch_dim, h),
        "pos_embed": (normal(cfg.num_patches + 1, h) * 0.02).to(cfg.dtype),
        "cls_token": const(0.0, h, dtype=cfg.dtype),
        "layers": layers,
        "final_ln_scale": const(1.0, h),
        "final_ln_bias": const(0.0, h),
        "head": dense(h, h, cfg.num_classes),
    }


def from_jax(params_np: dict, cfg: ViTConfig, device=None) -> dict:
    """The JAX param dict (numpy arrays) as tensors, each leaf keeping the
    reference's dtype (float32 LayerNorm leaves, the rest ``cfg.dtype``)."""
    return llama.tree_to_torch(params_np, resolve_device(device))


def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def patchify(images, patch_size: int):
    """[B, H, W, 3] -> [B, N, patch_dim] (reshape and transpose, no conv op)."""
    B, H, W, C = images.shape
    ph = pw = patch_size
    x = images.reshape(B, H // ph, ph, W // pw, pw, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // ph) * (W // pw), ph * pw * C)


def _block(cfg: ViTConfig, x, layer):
    B, S, _ = x.shape
    nh, hd = cfg.num_heads, cfg.hd
    y = _layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], cfg.ln_eps)
    q = (y @ layer["wq"]).reshape(B, S, nh, hd)
    k = (y @ layer["wk"]).reshape(B, S, nh, hd)
    v = (y @ layer["wv"]).reshape(B, S, nh, hd)
    o = llama.attention(q, k, v, causal=False)
    x = x + (o.reshape(B, S, nh * hd) @ layer["wo"])
    y = _layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], cfg.ln_eps)
    return x + (F.gelu(y @ layer["w1"] + layer["b1"], approximate="tanh") @ layer["w2"]
                + layer["b2"])


def forward(params, images, cfg: ViTConfig):
    """images [B, H, W, 3] float -> logits [B, num_classes] (float32)."""
    B = images.shape[0]
    x = patchify(images.to(cfg.dtype), cfg.patch_size) @ params["patch_embed"]
    cls = params["cls_token"].expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    for layer in llama._layers(params):
        if cfg.remat:
            x = checkpoint(_block, cfg, x, layer, use_reentrant=False)
        else:
            x = _block(cfg, x, layer)
    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"], cfg.ln_eps)
    return (x[:, 0] @ params["head"].to(cfg.dtype)).float()


def loss_fn(params, images, labels, cfg: ViTConfig):
    """Mean softmax cross-entropy of the logits against integer labels [B]."""
    logits = forward(params, images, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (logz - gold).mean()
