"""Training steps: the counterpart of ray_tpu/train/spmd.py.

``make_train_step`` builds ``(state, tokens, targets) -> (state, metrics)``
as the JAX step does, in one of two forms, told apart by its second
argument:

- ``make_train_step(cfg, mesh, optimizer=None, attn_fn=None)``, with a
  ``DeviceMesh`` (``parallel.mesh.make_mesh``), is the mesh step. As in JAX
  it returns ``compile_step(state) -> step``. Parameters are DTensors placed
  by ``llama.logical_axes`` through the rule table (``state_shardings``);
  AdamW's moments take their parameter's placements, which the step checks
  after its first update (``check_opt_shardings``); each rank runs its part
  of the forward and backward (``parallel.model_parallel``). ``step`` takes
  the global [B, S] batch on every rank, shards a full state on its first
  call (as JAX's ``in_shardings`` would) and gives the full loss and grad
  norm on every rank. Under ``seq > 1`` attention must be a ring
  (``make_ring_attn_fn``, the default there). A ``pipe`` dim acts as a
  replicated dim here, as in the JAX step, which has no rule for it.
  ``state_from_jax`` makes a sharded state from the JAX ``TrainState``'s
  params (``pp_state_from_jax`` one placed for the pipeline step), and
  ``make_auto_train_step`` picks the GPipe step
  (``parallel.pipeline.make_pp_train_step``) for a ``pipe`` dim above 1
  and this step otherwise.
- ``make_train_step(cfg, optimizer=None, attn_fn=None, device=None)``, with
  an ``Optimizer`` or nothing second, is the one-device step, called
  directly: the state lives on ``device`` (the card unless ``"cpu"`` is
  asked for).

Both run the forward and backward of ``models.llama``, then the optimizer
of ``make_optimizer``, which matches the JAX package's optax chain exactly:

- ``clip_by_global_norm(1.0)`` in optax's form: the gradients are left as
  they are when their global norm is below the limit, else become
  ``g / norm * max_norm`` (``clip_grad_norm_`` would add 1e-6 to the norm);
- ``torch.optim.AdamW`` with b1 0.9, b2 0.95, eps 1e-8 and decoupled weight
  decay on every parameter (optax ``mask=None``): ``p(1 - lr * wd) - lr *
  mu_hat / (sqrt(nu_hat) + eps)`` is optax's ``p - lr * (mu_hat /
  (sqrt(nu_hat) + eps) + wd * p)``, moments kept in the parameter's dtype as
  optax keeps them;
- the learning rate of ``optax.warmup_cosine_decay_schedule(0, lr, warmup,
  10000, 0.1 * lr)`` at the number of updates already done, so the first
  step runs at lr 0.

The step updates the parameters and the optimizer state in place (the JAX
step donates its state) and hands them back in a new ``TrainState``.
``grad_norm`` is the global norm of the unclipped gradients, ``step`` the
count after the update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel import model_parallel as mp
from ray_tpu_torch.parallel import sharding as shd
from ray_tpu_torch.parallel.mesh import mesh_shape
from ray_tpu_torch.parallel.ring_attention import make_ring_attn_fn

# the JAX package's make_optimizer constants
DECAY_STEPS, END_LR_FRACTION = 10000, 0.1
B1, B2, EPS = 0.9, 0.95, 1e-8
MAX_NORM = 1.0


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int


def leaves(tree: dict) -> list[torch.Tensor]:
    """Tensors of a nested dict, in insertion order."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _rebuild(like: dict, flat) -> dict:
    """A tree shaped like ``like`` from ``flat`` (in ``leaves`` order)."""
    flat = iter(flat)

    def rec(node):
        return {k: rec(v) if isinstance(v, dict) else next(flat) for k, v in node.items()}

    return rec(like)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Global-norm clipping, then ``torch.optim.AdamW`` under a
    warmup-cosine schedule (built by ``make_optimizer``)."""

    learning_rate: float
    weight_decay: float
    warmup: int

    def schedule(self, count: int) -> float:
        """Learning rate after ``count`` updates: linear from 0 over the
        warmup, then cosine down to a tenth of the peak at DECAY_STEPS."""
        lr = self.learning_rate
        if count < self.warmup:
            return -lr * (1 - count / self.warmup) + lr
        span = DECAY_STEPS - self.warmup
        cosine = 0.5 * (1 + math.cos(math.pi * min(count - self.warmup, span) / span))
        alpha = END_LR_FRACTION if lr else 0.0
        return lr * ((1 - alpha) * cosine + alpha)

    def init(self, params: dict) -> dict:
        """A fresh AdamW over ``params``; over a DTensor's local shard (the
        update is elementwise), so its moments are shaped as that shard."""
        adamw = torch.optim.AdamW([_local(p) for p in leaves(params)], lr=0.0, betas=(B1, B2),
                                  eps=EPS,
                                  weight_decay=self.weight_decay, foreach=True)
        return {"count": 0, "adamw": adamw}

    @staticmethod
    def clip_(grads: list[torch.Tensor], norm: torch.Tensor) -> None:
        """Scale ``grads`` in place to a global norm of at most MAX_NORM."""
        keep = norm < MAX_NORM
        div, mul = torch.where(keep, 1.0, norm), torch.where(keep, 1.0, MAX_NORM)
        for g in grads:
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))

    def step_(self, grads: list, opt_state: dict) -> None:
        """One AdamW update of the parameters and ``opt_state`` with
        ``grads`` (already clipped, local shards of DTensors), in place."""
        adamw = opt_state["adamw"]
        for p, g in zip(adamw.param_groups[0]["params"], grads):
            p.grad = g
        adamw.param_groups[0]["lr"] = self.schedule(opt_state["count"])
        adamw.step()
        adamw.zero_grad(set_to_none=True)
        opt_state["count"] += 1

    @torch.no_grad()
    def update(self, params: dict, grads: list[torch.Tensor], opt_state: dict) -> torch.Tensor:
        """Clip ``grads`` (in ``leaves(params)`` order) and apply one AdamW
        update to ``params`` and ``opt_state``, in place. Returns the global
        norm of the unclipped gradients, a float32 scalar on their device."""
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
        self.clip_(grads, norm)
        self.step_(grads, opt_state)
        return norm


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = 100) -> Optimizer:
    return Optimizer(learning_rate, weight_decay, warmup)


def init_state(cfg: llama.LlamaConfig, generator: torch.Generator, optimizer=None,
               device=None) -> TrainState:
    """Seeded ``llama.init`` on ``device`` (the card unless ``"cpu"`` is
    asked for; raises without one) and a fresh optimizer state."""
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()
    params = llama.init(cfg, generator, device)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_train_step(cfg: llama.LlamaConfig, *args, **kwargs) -> Callable:
    """``make_train_step(cfg, mesh, optimizer=None, attn_fn=None)`` when the
    second argument (or ``mesh=``) is a ``DeviceMesh``: the mesh step's
    ``compile_step``. Otherwise ``make_train_step(cfg, optimizer=None,
    attn_fn=None, device=None)``: the one-device step (module doc)."""
    if isinstance(args[0] if args else kwargs.get("mesh"), DeviceMesh):
        return _make_mesh_train_step(cfg, *args, **kwargs)
    return _make_device_train_step(cfg, *args, **kwargs)


def _make_device_train_step(cfg, optimizer=None, attn_fn=None, device=None) -> Callable:
    device = resolve_device(device)
    optimizer = optimizer or make_optimizer()

    def step_fn(state: TrainState, tokens, targets):
        tokens = torch.as_tensor(tokens, device=device)
        targets = torch.as_tensor(targets, device=device)
        tensors = [p.requires_grad_() for p in leaves(state.params)]
        loss = llama.loss_fn(state.params, tokens, targets, cfg, attn_fn)
        grads = list(torch.autograd.grad(loss, tensors))
        grad_norm = optimizer.update(state.params, grads, state.opt_state)
        new_state = TrainState(state.params, state.opt_state, state.step + 1)
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm,
                           "step": new_state.step}

    return step_fn


# ---------------------------------------------------------------- the mesh step
def _like(tree: dict, other: dict) -> dict:
    """``other``'s entries in ``tree``'s key order (``leaves`` follows it)."""
    return {k: _like(v, other[k]) if isinstance(v, dict) else other[k] for k, v in tree.items()}


def _mirror(opt_state: dict, params: dict, param_sh: dict, rep) -> list[dict]:
    adamw = opt_state["adamw"]
    return [{k: pl if isinstance(v, torch.Tensor) and v.shape == p.shape else rep
             for k, v in adamw.state.get(p, {}).items()}
            for p, pl in zip(adamw.param_groups[0]["params"], leaves(_like(params, param_sh)))]


def mirror_opt_shardings(opt_state: dict, params: dict, param_sh: dict, rep) -> dict:
    """Placements of an optimizer state: every state tensor of AdamW shaped
    like its parameter (the moments) takes the parameter's placements, the
    rest (step counts) replicate. Matched per parameter, not by shape: wq
    and wo share a shape but not placements."""
    return {"count": rep,
            "adamw": _rebuild(params, _mirror(opt_state, params, param_sh, rep))}


def _param_shardings(cfg: llama.LlamaConfig, mesh, param_sh: dict | None) -> dict:
    """``param_sh``, or the placements of the model's logical axes."""
    return param_sh or shd.tree_shardings(mesh, llama.logical_axes(cfg))


def state_shardings(cfg: llama.LlamaConfig, mesh, state: TrainState,
                    param_sh: dict | None = None) -> TrainState:
    """Placements for TrainState: params by logical axes (or ``param_sh``);
    opt_state mirrors params."""
    param_sh = _param_shardings(cfg, mesh, param_sh)
    rep = shd.replicated(mesh)
    return TrainState(params=param_sh,
                      opt_state=mirror_opt_shardings(state.opt_state, state.params, param_sh,
                                                     rep),
                      step=rep)


def check_opt_shardings(cfg: llama.LlamaConfig, mesh, state: TrainState,
                        param_sh: dict | None = None) -> None:
    """Raise unless every AdamW state tensor is laid out as
    ``mirror_opt_shardings`` says: each moment exactly as its parameter's
    local shard (shape, dtype, device), so that its global view under the
    parameter's placements (logical axes, or ``param_sh``) is the
    parameter's shape."""
    param_sh = _param_shardings(cfg, mesh, param_sh)
    want = _mirror(state.opt_state, state.params, param_sh, shd.replicated(mesh))
    adamw = state.opt_state["adamw"]
    for name, p, local, sh in zip(_names(state.params), leaves(state.params),
                                  adamw.param_groups[0]["params"], want):
        if not isinstance(p, DTensor) or local.data_ptr() != p.to_local().data_ptr():
            raise AssertionError(f"AdamW does not update the local shard of {name}")
        moments = [k for k, v in adamw.state.get(local, {}).items() if v.dim()]
        for k in moments:
            v = adamw.state[local][k]
            if (sh[k] != list(p.placements) or v.shape != local.shape
                    or v.dtype != local.dtype or v.device != local.device):
                raise AssertionError(f"AdamW {k} of {name}: {tuple(v.shape)} {v.dtype} on "
                                     f"{v.device}, its shard {tuple(local.shape)} {local.dtype}")
        if adamw.state and len(moments) != 2:
            raise AssertionError(f"AdamW keeps {moments} for {name}")


def _names(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for k, v in tree.items():
        out.extend(_names(v, f"{prefix}{k}.") if isinstance(v, dict) else [prefix + k])
    return out


def shard_state(cfg: llama.LlamaConfig, mesh, state: TrainState, optimizer=None,
                param_sh: dict | None = None) -> TrainState:
    """``state`` with its params as DTensors on ``mesh``, placed by logical
    axes (or ``param_sh``); a state already sharded is returned as it is. A
    full state must have a fresh optimizer (its moments are not carried
    over)."""
    if all(isinstance(p, DTensor) for p in leaves(state.params)):
        return state
    opt = state.opt_state
    if opt.get("count", 0) or opt["adamw"].state:
        raise ValueError("only a state with a fresh optimizer can be sharded")
    optimizer = optimizer or make_optimizer()
    params = shd.place_params(state.params, _param_shardings(cfg, mesh, param_sh), mesh)
    return TrainState(params, optimizer.init(params), state.step)


def state_from_jax(params_np: dict, cfg: llama.LlamaConfig, mesh, optimizer=None,
                   param_sh: dict | None = None) -> TrainState:
    """The JAX ``TrainState.params`` (numpy arrays, ``jax.tree.map(np.asarray,
    params)``) as a sharded port state with a fresh optimizer: ``from_jax``
    on the host, then each rank's shard (placed by logical axes, or
    ``param_sh``) onto its device."""
    optimizer = optimizer or make_optimizer()
    params = llama.from_jax(params_np, cfg, device="cpu")
    params = shd.place_params(params, _param_shardings(cfg, mesh, param_sh), mesh)
    return TrainState(params, optimizer.init(params), 0)


def pp_state_from_jax(params_np: dict, cfg: llama.LlamaConfig, mesh,
                      optimizer=None) -> TrainState:
    """``state_from_jax`` placed for the pipeline step
    (``parallel.pipeline.param_specs``: layers over ``pipe`` and
    ``tensor``, the rest replicated)."""
    from ray_tpu_torch.parallel.pipeline import param_specs

    return state_from_jax(params_np, cfg, mesh, optimizer,
                          param_specs(cfg, mesh.mesh_dim_names))


def _mesh_global_norm(grads, placements, ctx: mp.MeshContext) -> torch.Tensor:
    """The global norm of sharded gradients as one full scalar: each local
    sum of squares divided by the number of ranks holding the same shard,
    then summed over every rank."""
    total = sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 / ctx.replication(pl)
                for g, pl in zip(grads, placements))
    return torch.sqrt(ctx.reduce_(total, ctx.names))


def _make_mesh_train_step(cfg, mesh, optimizer=None, attn_fn=None) -> Callable:
    optimizer = optimizer or make_optimizer()
    ctx = mp.MeshContext(mesh)
    mp.check_splits(cfg, ctx)
    shape = mesh_shape(mesh)
    if shape.get("seq", 1) > 1:
        attn_fn = attn_fn or make_ring_attn_fn(mesh, "seq")
        if getattr(attn_fn, "seq_axis", None) != "seq":
            raise ValueError("under seq > 1 each rank holds one block of the sequence: "
                             "attention must be make_ring_attn_fn(mesh, 'seq')")
    attn_fn = attn_fn or llama.auto_attention
    param_sh = shd.tree_shardings(mesh, llama.logical_axes(cfg))
    # ranks that hold the same tokens share one objective
    share = 1.0 / math.prod(n for a, n in shape.items() if a not in mp.TOKEN_AXES)
    checked = []

    def step_fn(state: TrainState, tokens, targets):
        state = shard_state(cfg, mesh, state, optimizer)
        device = leaves(state.params)[0].to_local().device
        tok = ctx.batch_slice(torch.as_tensor(tokens, device=device))
        tgt = ctx.batch_slice(torch.as_tensor(targets, device=device))
        local = mp.local_tree(state.params, grad=True)
        placements = leaves(_like(state.params, param_sh))
        B, S = tok.shape
        start = ctx.rank("seq") * S
        positions = torch.arange(start, start + S, dtype=torch.int32,
                                 device=device).expand(B, S)
        logits = mp.forward(local, param_sh, tok, cfg, ctx, attn_fn, positions)
        num, count = mp.token_nll_sum(logits, tgt, cfg, ctx)
        count = ctx.reduce_(count.float(), mp.TOKEN_AXES).clamp(min=1)
        objective = num / count * share
        grads = list(torch.autograd.grad(objective, leaves(local)))
        with torch.no_grad():
            for g, pl in zip(grads, placements):
                replicated = [a for a, p in zip(ctx.names, pl) if not isinstance(p, Shard)]
                ctx.reduce_(g, replicated)
            norm = _mesh_global_norm(grads, placements, ctx)
            optimizer.clip_(grads, norm)
            optimizer.step_(grads, state.opt_state)
            loss = ctx.reduce_(objective.detach().clone(), ctx.names)
        new_state = TrainState(state.params, state.opt_state, state.step + 1)
        if not checked:
            check_opt_shardings(cfg, mesh, new_state)
            checked.append(True)
        return new_state, {"loss": loss, "grad_norm": norm, "step": new_state.step}

    def compile_step(state: TrainState) -> Callable:
        state_shardings(cfg, mesh, state)  # the state must have the model's tree
        return step_fn

    return compile_step


def make_auto_train_step(cfg: llama.LlamaConfig, mesh, optimizer=None,
                         attn_fn: Callable | None = None, num_microbatches: int = 2) -> Callable:
    """The train step for the mesh's layout: the GPipe pipeline step of
    ``num_microbatches`` (``parallel.pipeline.make_pp_train_step``) when a
    ``pipe`` dim above 1 is present, the single-program mesh step
    otherwise. Returns compile_step(state)."""
    if mesh_shape(mesh).get("pipe", 1) > 1:
        from ray_tpu_torch.parallel.pipeline import make_pp_train_step

        return make_pp_train_step(cfg, mesh, num_microbatches, optimizer=optimizer,
                                  attn_fn=attn_fn)
    return make_train_step(cfg, mesh, optimizer=optimizer, attn_fn=attn_fn)
