"""The Llama and MoE forwards on a mesh, written as each rank's part.

JAX runs ``models/llama.py`` unchanged on sharded arrays and lets XLA's
partitioner insert the collectives; here each rank runs the body that
partitioner would make, on its local shards (``DTensor.to_local``), with the
collectives written out (the counterpart of a ``shard_map`` body):

- ``fsdp``: each layer's weights are all-gathered over the dim where they
  are used (ZeRO-3), inside the block, so a remat block gathers again in
  the backward; the gather's backward is a reduce-scatter.
- ``tensor``: q/k/v and the MLP's gate/up are column-parallel (each rank its
  heads, GQA groups whole, and its MLP columns); ``wo`` and ``w_down`` are
  row-parallel, their products summed over the dim. A head count that
  ``tensor`` does not divide (kv heads fewer than ranks) is served by
  gathering wk/wv and taking the kv head of each local query head. The
  vocabulary is split too: the embedding looks up the rank's rows and sums
  over the dim, the head gives the rank's logits, and the loss is the
  vocab-parallel cross-entropy (a max and a sum of exponentials over the
  dim, the gold logit from the rank that holds it).
- ``data``/``fsdp``: the batch is split data-major; ``seq``: each rank holds
  one contiguous block of the sequence, rope takes its global positions and
  attention is a ring (``ring_attention.make_ring_attn_fn``).
- ``expert`` (MoE): each rank runs its experts over the whole batch's
  dispatch and the combine is summed over the dim.

Gradients follow one rule: each rank's objective is its share of the
global loss, ``sum(nll * valid) / sum(valid)`` summed over every rank, so
the shares of ranks that compute the same tokens (``tensor``, ``expert``,
``pipe``) are divided by their number; every collective's backward is its
adjoint (``parallel.collectives``); and a parameter's gradient is
summed over each mesh dim on which the parameter is replicated. On a dim of
size 1 nothing is communicated.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.parallel import sharding as shd
from ray_tpu_torch.parallel.collectives import DeviceCollectiveGroup
from ray_tpu_torch.parallel.mesh import mesh_shape

BATCH_AXES = ("data", "fsdp")  # the batch's split, outer first
TOKEN_AXES = ("data", "fsdp", "seq")  # dims over which ranks hold different tokens


class MeshContext:
    """A mesh's dims as this rank sees them: sizes, positions, groups."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.names = tuple(mesh.mesh_dim_names)
        self.groups = {a: DeviceCollectiveGroup(mesh, a) for a in self.names}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.groups[axis].rank() if axis in self.groups else 0

    def sum(self, x, *axes):
        """Differentiable sum over ``axes``."""
        for a in axes:
            if self.size(a) > 1:
                x = self.groups[a].allreduce(x, "sum")
        return x

    def reduce_(self, x, axes, op=dist.ReduceOp.SUM):
        """In-place, non-differentiable all-reduce over ``axes``."""
        for a in axes:
            if self.size(a) > 1:
                dist.all_reduce(x, op=op, group=self.groups[a].group)
        return x

    def gather(self, x, axis: str, dim: int):
        return x if self.size(axis) == 1 else self.groups[axis].allgather(x, axis=dim)

    def batch_slice(self, t: torch.Tensor, seq_dim: int | None = 1) -> torch.Tensor:
        """This rank's block of a global [B, S, ...] tensor: B split over
        ``data`` then ``fsdp``, S over ``seq`` (when ``seq_dim`` is given)."""
        n = self.size("data") * self.size("fsdp")
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} does not split over data x fsdp = {n}")
        b = t.shape[0] // n
        i = self.rank("data") * self.size("fsdp") + self.rank("fsdp")
        t = t[i * b:(i + 1) * b]
        if seq_dim is not None and self.size("seq") > 1:
            n_seq = self.size("seq")
            if t.shape[seq_dim] % n_seq:
                raise ValueError(f"sequence {t.shape[seq_dim]} does not split over seq = {n_seq}")
            s = t.shape[seq_dim] // n_seq
            t = t.narrow(seq_dim, self.rank("seq") * s, s)
        return t

    def gather_batch(self, x):
        """A batch block [b, ...] back to the global batch (inner dim first)."""
        for a in reversed(BATCH_AXES):
            x = self.gather(x, a, 0)
        return x

    def replication(self, placements) -> int:
        """How many ranks hold the same shard: the product of the sizes of
        the dims on which ``placements`` replicate."""
        return math.prod(self.size(a) for a, p in zip(self.names, placements)
                         if isinstance(p, Replicate))


def _unshard(w, placements, ctx: MeshContext, offset: int = 0, axes=("fsdp",)):
    """``w`` all-gathered over the mesh dims in ``axes`` that shard it;
    ``offset`` is subtracted from the placement's tensor dim (1 for a
    layer slice of a stacked leaf)."""
    for a, p in zip(ctx.names, placements):
        if a in axes and isinstance(p, Shard):
            w = ctx.gather(w, a, p.dim - offset)
    return w


def local_tree(params: dict, grad: bool = False) -> dict:
    """The local shard of every DTensor in ``params`` (sharing its storage);
    with ``grad``, each a leaf that requires grad."""
    def leaf(v):
        v = v.to_local() if isinstance(v, DTensor) else v
        return v.detach().requires_grad_() if grad else v

    return {k: local_tree(v, grad) if isinstance(v, dict) else leaf(v)
            for k, v in params.items()}


# ---------------------------------------------------------------- Llama
def check_splits(cfg: llama.LlamaConfig, ctx: MeshContext) -> None:
    """Refuse what the layout cannot split evenly: query heads and the
    vocabulary over ``tensor``."""
    tp = ctx.size("tensor")
    if cfg.num_heads % tp:
        raise ValueError(f"{cfg.num_heads} heads do not split over tensor = {tp}")
    _vocab_start(cfg, ctx)


def _vocab_start(cfg, ctx: MeshContext) -> tuple[int, int]:
    tp = ctx.size("tensor")
    if cfg.vocab_size % tp:
        raise ValueError(f"vocab {cfg.vocab_size} does not split over tensor = {tp}")
    n = cfg.vocab_size // tp
    return ctx.rank("tensor") * n, n


def embed_tokens(params, plc, tokens, cfg: llama.LlamaConfig, ctx: MeshContext):
    """Vocab-parallel lookup of tokens [b, s] in the rank's embedding rows."""
    table = _unshard(params["embed"], plc["embed"], ctx)  # [V/tp, h]
    if ctx.size("tensor") == 1:
        return table[tokens.long()].to(cfg.dtype)
    start, n = _vocab_start(cfg, ctx)
    ids = tokens.long() - start
    inside = (ids >= 0) & (ids < n)
    x = table[ids.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
    return ctx.sum(x, "tensor").to(cfg.dtype)


def _kv(y, w, cfg: llama.LlamaConfig, ctx: MeshContext, plc):
    """k, v [b, s, kv heads, hd] for the rank's query heads."""
    B, S, _ = y.shape
    hd, tp = cfg.hd, ctx.size("tensor")
    if cfg.num_kv_heads % tp == 0:
        return (y @ w["wk"]).reshape(B, S, -1, hd), (y @ w["wv"]).reshape(B, S, -1, hd)
    # fewer kv heads than ranks: every rank takes the kv head of each of its query heads
    nq = cfg.num_heads // tp
    g = cfg.num_heads // cfg.num_kv_heads
    pick = (torch.arange(nq, device=y.device) + ctx.rank("tensor") * nq) // g
    out = []
    for name in ("wk", "wv"):
        full = _unshard(w[name], plc[name], ctx, 1, axes=("tensor",))
        out.append((y @ full).reshape(B, S, cfg.num_kv_heads, hd)[:, :, pick])
    return out


def _block(cfg: llama.LlamaConfig, ctx: MeshContext, plc: dict, x, layer, positions, attn_fn):
    B, S, _ = x.shape
    w = {n: _unshard(t, plc[n], ctx, 1) for n, t in layer.items()}
    y = llama.rms_norm(x, w["attn_norm"], cfg.rms_eps)
    q = (y @ w["wq"]).reshape(B, S, -1, cfg.hd)
    k, v = _kv(y, w, cfg, ctx, plc)
    q, k = llama.rope(q, positions, cfg.rope_theta), llama.rope(k, positions, cfg.rope_theta)
    o = attn_fn(q, k, v).reshape(B, S, -1)
    x = x + ctx.sum(o @ w["wo"], "tensor")
    y = llama.rms_norm(x, w["mlp_norm"], cfg.rms_eps)
    gate = F.silu(y @ w["w_gate"])
    return x + ctx.sum((gate * (y @ w["w_up"])) @ w["w_down"], "tensor")


def _remat_kwargs(cfg: llama.LlamaConfig) -> dict:
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                llama._save_weight_products)}
    return {}


def _layer_slices(params, plc) -> tuple[list[dict], dict]:
    names = list(params["layers"])
    layers = [dict(zip(names, ws))
              for ws in zip(*(params["layers"][n].unbind(0) for n in names))]
    return layers, plc["layers"]


def forward(params, plc, tokens, cfg: llama.LlamaConfig, ctx: MeshContext, attn_fn, positions):
    """This rank's logits [b, s, V/tensor] (float32) from its local
    parameter shards ``params`` (placed as ``plc`` says) and token block."""
    x = embed_tokens(params, plc, tokens, cfg, ctx)
    layers, lplc = _layer_slices(params, plc)
    remat = _remat_kwargs(cfg) if cfg.remat else None
    for layer in layers:
        if remat is not None:
            x = checkpoint(_block, cfg, ctx, lplc, x, layer, positions, attn_fn,
                           use_reentrant=False, **remat)
        else:
            x = _block(cfg, ctx, lplc, x, layer, positions, attn_fn)
    return logits(params, plc, x, cfg, ctx)


def logits(params, plc, x, cfg, ctx: MeshContext):
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_eps)
    if cfg.tie_embeddings:
        head = _unshard(params["embed"], plc["embed"], ctx).T
    else:
        head = _unshard(params["lm_head"], plc["lm_head"], ctx)
    return (x @ head.to(cfg.dtype)).float()


def token_nll_sum(logits_local, targets, cfg, ctx: MeshContext):
    """(sum of nll over the rank's valid targets, their count): the
    vocab-parallel cross-entropy, summed over ``tensor`` inside."""
    valid = targets != -100
    tsafe = torch.where(valid, targets, 0).long()
    if ctx.size("tensor") == 1:
        logz = torch.logsumexp(logits_local, dim=-1)
        gold = logits_local.gather(-1, tsafe[..., None])[..., 0]
    else:
        mx = ctx.reduce_(logits_local.detach().amax(dim=-1), ("tensor",), dist.ReduceOp.MAX)
        se = ctx.sum(torch.exp(logits_local - mx[..., None]).sum(dim=-1), "tensor")
        logz = torch.log(se) + mx
        start, n = _vocab_start(cfg, ctx)
        ids = tsafe - start
        inside = (ids >= 0) & (ids < n)
        gold = logits_local.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0] * inside
        gold = ctx.sum(gold, "tensor")
    return ((logz - gold) * valid).sum(), valid.sum()


# ---------------------------------------------------------------- MoE, expert parallel
def _moe_block(cfg: moe.MoEConfig, ctx: MeshContext, plc, x, layer, positions):
    base = cfg.base
    B, S, _ = x.shape
    w = {n: _unshard(t, plc[n], ctx, 1) for n, t in layer.items()}
    y = llama.rms_norm(x, w["attn_norm"], base.rms_eps)
    q = (y @ w["wq"]).reshape(B, S, -1, base.hd)
    k, v = _kv(y, w, base, ctx, plc)
    q, k = llama.rope(q, positions, base.rope_theta), llama.rope(k, positions, base.rope_theta)
    o = llama.attention(q, k, v, causal=True).reshape(B, S, -1)
    x = x + ctx.sum(o @ w["wo"], "tensor")
    y = llama.rms_norm(x, w["mlp_norm"], base.rms_eps)
    # routing over the whole batch, as the unsharded layer routes it (the
    # capacity and the buffer slots depend on every token)
    y_all = ctx.gather_batch(y)
    T, H = y_all.shape[0] * S, y_all.shape[2]
    C = max(1, int(cfg.capacity_factor * cfg.top_k * T / cfg.num_experts))
    xt = y_all.reshape(T, H)
    dispatch, combine, aux = moe.route(xt, w["router"], cfg, C)
    E_local = w["e_gate"].shape[0]
    first = ctx.rank("expert") * E_local
    mine = slice(first, first + E_local)
    expert_in = torch.einsum("tec,th->ech", dispatch[:, mine], xt)
    gate = F.silu(torch.einsum("ech,ehm->ecm", expert_in, w["e_gate"]))
    up = torch.einsum("ech,ehm->ecm", expert_in, w["e_up"])
    expert_out = torch.einsum("ecm,emh->ech", gate * up, w["e_down"])
    out = ctx.sum(torch.einsum("tec,ech->th", combine[:, mine], expert_out), "expert", "tensor")
    out = ctx.batch_slice(out.reshape(-1, S, H), seq_dim=None)
    return x + out, aux


def moe_forward(params, tokens, cfg: moe.MoEConfig, mesh):
    """``moe.forward`` on a mesh: ``params`` are DTensors placed by
    ``moe.logical_axes``, ``tokens`` the global [B, S] ids (numpy or
    torch). Returns (logits, a DTensor of the global [B, S, V] split on
    the batch over ``data``/``fsdp`` and on the vocabulary over ``tensor``;
    the aux loss, a float32 scalar). Attention is dense over the whole
    sequence, as the reference's MoE runs it, so ``seq`` replicates."""
    ctx = MeshContext(mesh)
    base = cfg.base
    plc = shd.tree_shardings(mesh, moe.logical_axes(cfg))
    local = local_tree(params)
    device = local["final_norm"].device
    tokens = torch.as_tensor(tokens, device=device)
    tok = ctx.batch_slice(tokens, seq_dim=None)
    B, S = tok.shape
    positions = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    x = embed_tokens(local, plc, tok, base, ctx)
    aux_total = torch.zeros((), dtype=torch.float32, device=device)
    layers, lplc = _layer_slices(local, plc)
    for layer in layers:
        x, aux = _moe_block(cfg, ctx, lplc, x, layer, positions)
        aux_total = aux_total + aux
    out = logits(local, plc, x, base, ctx)
    placements = [Shard(0) if a in BATCH_AXES else Shard(2) if a == "tensor" else Replicate()
                  for a in ctx.names]
    full_shape = (tokens.shape[0], S, base.vocab_size)
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=full_shape,
                              stride=(S * base.vocab_size, base.vocab_size, 1)), aux_total
