"""Pipeline parallelism: the GPipe step over a ``pipe`` mesh dim, the port of
ray_tpu/parallel/pipeline.py.

As in the JAX module:

- The Llama params are stacked ``[L, ...]``; sharding that leading dim over
  ``pipe`` IS the stage assignment, each stage holding ``L / P`` contiguous
  layers.
- Microbatches move between stage neighbours with a permutation along
  ``pipe`` (the GPipe schedule: ``M + P - 1`` ticks, stage s runs
  microbatch ``t - s`` at tick t). Every rank runs its stage on every tick
  and routes with ``torch.where`` on tensors (stage 0 takes the embedding,
  the others what they received), so every rank builds the same autograd
  graph and runs the same collectives in the same order, forward and
  backward: ``collectives.DeviceCollectiveGroup.permute``'s backward is the
  inverse permutation, and a rank that skipped one would leave its
  neighbour waiting.
- Tensor parallelism composes inside each stage Megatron-style
  (``model_parallel._block``): wq/wk/wv and w_gate/w_up output-sharded over
  ``tensor``, wo/w_down input-sharded, one sum over ``tensor`` after each.
- The loss is seeded on ONE rank per batch shard, the last stage's tensor
  rank 0: the sum over ``tensor``'s backward is a sum too, so a loss seeded
  on every tensor rank would make each upstream gradient T times too large.
  Each leaf's gradient is then summed over the mesh dims it is replicated
  on (``spmd``'s rule): layer leaves over (data, fsdp), the norms over
  ``tensor`` too, embed/final norm/head over all four dims (the stages that
  do not own them give exact zeros through the routing).

In a PP layout ``fsdp`` is plain data parallelism: the parameters are
replicated over it, not gathered. The batch is split over (data, fsdp).
Where JAX runs the schedule as a ``lax.scan`` inside one ``shard_map``, each
rank here runs the ticks as a Python loop on its local shards; autograd
keeps every tick's activations (``cfg.remat`` recomputes each block), and
the last stage's M outputs are kept in a list.

``CompiledStagePipeline`` (actor stages over compiled graphs) is not ported
(ROADMAP queue 1 item 5a-iii, after the compiled graphs of item 8).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import model_parallel as mp
from ray_tpu_torch.parallel import sharding as shd
from ray_tpu_torch.parallel.mesh import AXES, mesh_shape
from ray_tpu_torch.train import spmd


def _placements(spec, mesh_dims=AXES) -> list:
    """Placements (one per mesh dim) of a PartitionSpec-like tuple: entry d
    names the mesh dim (a str) or dims (a tuple, outer first) splitting
    tensor dim d, or None."""
    out = [Replicate() for _ in mesh_dims]
    for d, names in enumerate(spec):
        for name in (names,) if isinstance(names, str) else names or ():
            out[mesh_dims.index(name)] = Shard(d)
    return out


def layer_specs(mesh_dims=AXES) -> dict:
    """Placements of the stacked layer params in a PP layout: the leading
    (stack) dim over ``pipe``, the Megatron in/out dims over ``tensor``."""
    t = "tensor"
    specs = {
        "attn_norm": ("pipe", None),
        "wq": ("pipe", None, t),
        "wk": ("pipe", None, t),
        "wv": ("pipe", None, t),
        "wo": ("pipe", t, None),
        "mlp_norm": ("pipe", None),
        "w_gate": ("pipe", None, t),
        "w_up": ("pipe", None, t),
        "w_down": ("pipe", t, None),
    }
    return {k: _placements(s, mesh_dims) for k, s in specs.items()}


def param_specs(cfg: llama.LlamaConfig, mesh_dims=AXES) -> dict:
    tree = {
        "embed": _placements((None, None), mesh_dims),
        "layers": layer_specs(mesh_dims),
        "final_norm": _placements((None,), mesh_dims),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = _placements((None, None), mesh_dims)
    return tree


BATCH_SPEC = _placements((("data", "fsdp"), None))


def _check(cfg: llama.LlamaConfig, shape: dict) -> tuple[int, int]:
    """(pipe, tensor) sizes of a mesh ``{dim: size}`` the PP step can run on."""
    for ax in ("pipe", "tensor", "data", "fsdp"):
        if ax not in shape:
            raise ValueError(f"PP mesh needs a {ax!r} axis, got {dict(shape)}")
    for ax in ("seq", "expert"):
        if shape.get(ax, 1) != 1:
            raise ValueError(f"PP step does not compose with {ax!r}>1 yet")
    n_stages, tp = shape["pipe"], shape["tensor"]
    if cfg.num_layers % n_stages:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by pipe={n_stages}")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        # the mesh step could gather kv heads (model_parallel._kv); the
        # reference refuses here, and so does the port
        raise ValueError(
            f"heads {cfg.num_heads}/kv {cfg.num_kv_heads} not divisible by tensor={tp}")
    return n_stages, tp


def shard_pp_params(params: dict, cfg: llama.LlamaConfig, mesh) -> dict:
    """Full tensors (held whole by every rank) as DTensors placed by
    ``param_specs``; a tree already of DTensors is returned as it is."""
    if all(isinstance(p, DTensor) for p in spmd.leaves(params)):
        return params
    return shd.place_params(params, param_specs(cfg, mesh.mesh_dim_names), mesh)


def _make_local_step(cfg: llama.LlamaConfig, mesh, num_microbatches: int,
                     attn_fn: Callable | None):
    """``(run, ctx, placements tree)``: ``run(params, tokens, targets) ->
    (loss, grads, placements)`` is the PP forward and backward of this rank
    on its shards of ``params`` (PP DTensors), ``grads`` the local
    gradients (in ``spmd.leaves(params)`` order) summed over the dims each
    leaf is replicated on, ``loss`` the global loss on every rank."""
    shape = mesh_shape(mesh)
    n_stages, _ = _check(cfg, shape)
    M = num_microbatches
    attn_fn = attn_fn or llama.auto_attention
    ctx = mp.MeshContext(mesh)
    plc = param_specs(cfg, ctx.names)
    lplc = plc["layers"]
    remat = mp._remat_kwargs(cfg) if cfg.remat else None
    stage = ctx.rank("pipe")
    owner = stage == n_stages - 1 and ctx.rank("tensor") == 0
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    ticks = M + n_stages - 1

    def objective(local, tokens, targets):
        """This rank's share of the loss: sum(nll * valid) / global count on
        the owner, zero elsewhere (every rank computes it, as the
        reference's lockstep stages do)."""
        Bl, S = tokens.shape
        if Bl % M:
            raise ValueError(f"local batch {Bl} not divisible by microbatches {M}")
        Bm = Bl // M
        device = tokens.device
        toks_mb = tokens.reshape(M, Bm, S).long()
        positions = torch.arange(S, dtype=torch.int32, device=device).expand(Bm, S)
        layers, _ = mp._layer_slices(local, plc)
        first = torch.tensor(stage == 0, device=device)

        def stage_fn(x):
            for layer in layers:
                if remat is not None:
                    x = checkpoint(mp._block, cfg, ctx, lplc, x, layer, positions, attn_fn,
                                   use_reentrant=False, **remat)
                else:
                    x = mp._block(cfg, ctx, lplc, x, layer, positions, attn_fn)
            return x

        recv = torch.zeros((Bm, S, cfg.hidden_size), dtype=cfg.dtype, device=device)
        outputs = []
        for t in range(ticks):
            # stage 0 feeds microbatch t (clipped past the drain ticks, where
            # its compute is discarded); the later stages take the rotation
            emb = local["embed"][toks_mb[min(t, M - 1)]].to(cfg.dtype)
            x = stage_fn(torch.where(first, emb, recv))
            if t >= n_stages - 1:  # the last stage completes microbatch t - (P - 1)
                outputs.append(x)
            if t < ticks - 1:
                recv = ctx.groups["pipe"].permute(x, perm)
        x = llama.rms_norm(torch.cat(outputs), local["final_norm"], cfg.rms_eps)
        head = local["embed"].T if cfg.tie_embeddings else local["lm_head"]
        logits = (x @ head.to(cfg.dtype)).float()
        valid = targets != -100
        tsafe = torch.where(valid, targets, 0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tsafe[..., None])[..., 0]
        nll_sum = ((logz - gold) * valid).sum()
        count = ctx.reduce_(valid.sum().float(), mp.BATCH_AXES).clamp(min=1)
        return torch.where(torch.tensor(owner, device=device), nll_sum, 0.0) / count

    def run(params, tokens, targets):
        local = mp.local_tree(params, grad=True)
        device = local["final_norm"].device
        tok = ctx.batch_slice(torch.as_tensor(tokens, device=device), seq_dim=None)
        tgt = ctx.batch_slice(torch.as_tensor(targets, device=device), seq_dim=None)
        obj = objective(local, tok, tgt)
        placements = spmd.leaves(spmd._like(params, plc))
        grads = list(torch.autograd.grad(obj, spmd.leaves(local)))
        with torch.no_grad():
            for g, pl in zip(grads, placements):
                ctx.reduce_(g, [a for a, p in zip(ctx.names, pl) if not isinstance(p, Shard)])
            loss = ctx.reduce_(obj.detach().clone(), ctx.names)
        return loss, grads, placements

    return run, ctx, plc


def make_pp_loss_and_grad(cfg: llama.LlamaConfig, mesh, num_microbatches: int,
                          attn_fn: Callable | None = None) -> Callable:
    """``(params, tokens, targets) -> (loss, grads)``: ``params`` full
    tensors or DTensors placed by ``param_specs``, ``tokens``/``targets``
    the global [B, S] batch on every rank; ``loss`` the global loss on every
    rank, ``grads`` DTensors placed like the params, globally reduced."""
    run, _, _ = _make_local_step(cfg, mesh, num_microbatches, attn_fn)

    def loss_and_grad(params, tokens, targets):
        params = shard_pp_params(params, cfg, mesh)
        loss, grads, placements = run(params, tokens, targets)
        out = [DTensor.from_local(g, mesh, pl, run_check=False, shape=p.shape,
                                  stride=p.stride())
               for g, pl, p in zip(grads, placements, spmd.leaves(params))]
        return loss, spmd._rebuild(params, out)

    return loss_and_grad


def pp_state_shardings(cfg: llama.LlamaConfig, mesh, state: spmd.TrainState) -> spmd.TrainState:
    """TrainState placements for PP layouts (params by ``param_specs``; the
    optimizer's moments mirror their parameter's; scalars replicated)."""
    return spmd.state_shardings(cfg, mesh, state, param_specs(cfg, mesh.mesh_dim_names))


def make_pp_train_step(cfg: llama.LlamaConfig, mesh, num_microbatches: int, optimizer=None,
                       attn_fn: Callable | None = None) -> Callable:
    """PP analog of ``spmd.make_train_step``: returns ``compile_step(state)
    -> step(state, tokens, targets) -> (state, {"loss", "grad_norm",
    "step"})``. A full state (a fresh optimizer) is sharded on the first
    call; the parameters and the optimizer state are updated in place."""
    optimizer = optimizer or spmd.make_optimizer()
    run, ctx, plc = _make_local_step(cfg, mesh, num_microbatches, attn_fn)
    checked = []

    def step_fn(state: spmd.TrainState, tokens, targets):
        state = spmd.shard_state(cfg, mesh, state, optimizer, plc)
        loss, grads, placements = run(state.params, tokens, targets)
        with torch.no_grad():
            norm = spmd._mesh_global_norm(grads, placements, ctx)
            optimizer.clip_(grads, norm)
            optimizer.step_(grads, state.opt_state)
        new_state = spmd.TrainState(state.params, state.opt_state, state.step + 1)
        if not checked:
            spmd.check_opt_shardings(cfg, mesh, new_state, plc)
            checked.append(True)
        return new_state, {"loss": loss, "grad_norm": norm, "step": new_state.step}

    def compile_step(state: spmd.TrainState) -> Callable:
        pp_state_shardings(cfg, mesh, state)  # the state must have the model's tree
        return step_fn

    return compile_step
