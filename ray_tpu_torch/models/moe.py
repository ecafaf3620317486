"""Mixture-of-Experts transformer in PyTorch (port of ray_tpu/models/moe.py).

A Llama backbone (``models.llama`` ops) whose MLP is replaced in every
block by a capacity-bounded top-k MoE layer. Tokens are routed with dense
dispatch/combine einsums over an [E, C] capacity buffer, as the reference
does. ``forward`` runs on one device; ``logical_axes`` shards the experts
over the ``expert`` mesh dim, and ``parallel.model_parallel.moe_forward``
runs the same forward on a mesh, each rank computing its own experts.

Numerics follow the reference: the router's logits and softmax are
float32; the top-k order is descending with ties to the lower expert index
(a stable sort, as ``jax.lax.top_k`` orders them); a (token, choice) pair
takes its slot in its expert's buffer in token-major, choice-minor order;
the dispatch and combine tensors are built in the activations' dtype.
Attention is the dense ``llama.attention(causal=True)``, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    base: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig.tiny)
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01

    @staticmethod
    def tiny() -> "MoEConfig":
        return MoEConfig(base=llama.LlamaConfig.tiny(), num_experts=4, top_k=2)

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        return MoEConfig(
            base=llama.LlamaConfig(
                vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                num_layers=32, num_heads=32, num_kv_heads=8, max_seq_len=8192,
                rope_theta=1e6,
            ),
            num_experts=8, top_k=2,
        )


def logical_axes(cfg: MoEConfig) -> dict:
    """Param sharding tree: experts lead with the ``expert`` axis."""
    ax = llama.logical_axes(cfg.base)
    ax["layers"] = dict(ax["layers"])
    ax["layers"].update({
        "router": (None, None, None),
        "e_gate": (None, "expert", "embed_fsdp", "mlp"),
        "e_up": (None, "expert", "embed_fsdp", "mlp"),
        "e_down": (None, "expert", "mlp", "embed_fsdp"),
    })
    # every block is MoE: the dense MLP weights are replaced by experts
    for dense_key in ("w_gate", "w_up", "w_down"):
        ax["layers"].pop(dense_key, None)
    return ax


def init(cfg: MoEConfig, generator: torch.Generator, device=None) -> dict:
    """The Llama init with the dense MLP weights dropped, plus the router
    ``[L, h, E]`` and the experts ``e_gate``/``e_up`` ``[L, E, h, m]`` and
    ``e_down`` ``[L, E, m, h]``, scaled normal in ``cfg.base.dtype``, drawn
    from ``generator`` one expert matrix at a time."""
    device = resolve_device(device)
    base = cfg.base
    params = llama.init(base, generator, device)
    # the experts replace the dense MLP (for Mixtral-8x7B ~5.6B dead parameters)
    for dense_key in ("w_gate", "w_up", "w_down"):
        del params["layers"][dense_key]
    h, m, L, E = base.hidden_size, base.intermediate_size, base.num_layers, cfg.num_experts

    def dense(fan_in, *shape):
        out = torch.empty(shape, dtype=base.dtype, device=device)
        for idx in itertools.product(*map(range, shape[:-2])):
            x = torch.randn(shape[-2:], generator=generator, device=device)
            out[idx] = (x / math.sqrt(fan_in)).to(base.dtype)
        return out

    params["layers"]["router"] = dense(h, L, h, E)
    params["layers"]["e_gate"] = dense(h, L, E, h, m)
    params["layers"]["e_up"] = dense(h, L, E, h, m)
    params["layers"]["e_down"] = dense(m, L, E, m, h)
    return params


def from_jax(params_np: dict, cfg: MoEConfig, device=None) -> dict:
    """The JAX param dict (numpy arrays) as tensors, each leaf keeping the
    reference's dtype: float32 norms, and the router and experts in the
    base dtype."""
    return llama.tree_to_torch(params_np, resolve_device(device))


def route(xt, router_w, cfg: MoEConfig, capacity: int):
    """Capacity-bounded top-k routing of tokens xt [T, H]: the dispatch and
    combine tensors [T, E, C] (in xt's dtype) and the switch-style
    load-balancing aux loss (float32 scalar)."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax((xt @ router_w).float(), dim=-1)  # [T, E]
    # top-k expert choice per token: descending, ties to the lower index
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_e = order.values[:, :k], order.indices[:, :k]  # [T, k]
    # position of each (token, choice) in its expert's capacity buffer
    onehot = F.one_hot(topk_e, E)  # [T, k, E]
    flat = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).reshape(T, k, E)
    within_cap = (pos >= 0) & (pos < capacity)
    disp = (F.one_hot(pos.clamp(0, capacity - 1), capacity).to(xt.dtype)
            * within_cap[..., None].to(xt.dtype)
            * onehot[..., None].to(xt.dtype))  # [T, k, E, C]
    dispatch = disp.sum(dim=1)
    combine = (disp * topk_p[:, :, None, None].to(xt.dtype)).sum(dim=1)
    density = onehot.sum(dim=1).float().mean(dim=0)  # [E]
    aux = (density * probs.mean(dim=0)).sum() * (E ** 2) / k
    return dispatch, combine, aux


def moe_mlp(x, router_w, e_gate, e_up, e_down, cfg: MoEConfig):
    """Capacity-bounded top-k MoE layer; x [B, S, H] -> ([B, S, H], aux)."""
    B, S, H = x.shape
    T = B * S
    # Python float arithmetic, as the reference computes it
    C = max(1, int(cfg.capacity_factor * cfg.top_k * T / cfg.num_experts))
    xt = x.reshape(T, H)
    dispatch, combine, aux = route(xt, router_w, cfg, C)
    expert_in = torch.einsum("tec,th->ech", dispatch, xt)  # [E, C, H]
    gate = F.silu(torch.einsum("ech,ehm->ecm", expert_in, e_gate))
    up = torch.einsum("ech,ehm->ecm", expert_in, e_up)
    expert_out = torch.einsum("ecm,emh->ech", gate * up, e_down)
    out = torch.einsum("tec,ech->th", combine, expert_out)
    return out.reshape(B, S, H), aux


def _block(cfg: MoEConfig, x, layer, positions):
    base = cfg.base
    B, S, _ = x.shape
    q, k, v = llama._qkv(x, layer, base, positions)
    o = llama.attention(q, k, v, causal=True)
    x = x + (o.reshape(B, S, -1) @ layer["wo"])
    y = llama.rms_norm(x, layer["mlp_norm"], base.rms_eps)
    mlp_out, aux = moe_mlp(y, layer["router"], layer["e_gate"], layer["e_up"],
                           layer["e_down"], cfg)
    return x + mlp_out, aux


def forward(params, tokens, cfg: MoEConfig, positions=None):
    """Token ids [B, S] -> (logits [B, S, V] float32, total aux loss). With
    ``cfg.base.remat`` each block runs under ``torch.utils.checkpoint``."""
    base = cfg.base
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = params["embed"][tokens.long()].to(base.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in llama._layers(params):
        if base.remat:
            x, aux = checkpoint(_block, cfg, x, layer, positions, use_reentrant=False)
        else:
            x, aux = _block(cfg, x, layer, positions)
        aux_total = aux_total + aux
    return llama._logits(params, x, base), aux_total


def loss_fn(params, tokens, targets, cfg: MoEConfig):
    """Next-token cross-entropy (mean over targets != -100) plus
    ``router_aux_coeff`` times the aux loss."""
    logits, aux = forward(params, tokens, cfg)
    return llama.token_nll(logits, targets) + cfg.router_aux_coeff * aux
