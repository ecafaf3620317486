"""Rank functions for tests/test_torch_parallel_ranks.py and
tests/test_torch_parallel.py, run by ``ray_tpu_torch.parallel.launch`` in
rank processes. This module imports torch and the port only (no jax): the
JAX side of every comparison runs in the test process.

``world_checks`` runs every multi-rank check in ONE world of 8 CPU ranks
over gloo, building a ``DeviceMesh`` per layout over the same ranks, and
returns what the tests compare (rank 0 returns the gathered tensors, every
rank its own collective results).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

# The Llama layouts: (name, mesh dims, attention, remat policy or None).
LAYOUTS = [
    ("dryrun_8", dict(data=1, fsdp=2, tensor=2, seq=2), "ring", "full"),
    ("data2_fsdp2_seq2", dict(data=2, fsdp=2, seq=2), "ring", None),
    ("data2_fsdp2_tensor2", dict(data=2, fsdp=2, tensor=2), "dense", None),
    ("data2_tensor2_seq2", dict(data=2, tensor=2, seq=2), "ring", "dots"),
    ("tensor_flash", dict(data=2, fsdp=2, tensor=2), "flash", None),
    # 2 kv heads over 4 ranks: each rank gathers wk/wv and takes its kv head
    ("data2_tensor4", dict(data=2, tensor=4), "dense", None),
    # the mesh step on a pipe mesh: pipe acts as a replicated dim
    ("data2_pipe2_tensor2", dict(data=2, pipe=2, tensor=2), "dense", None),
]
STEPS = 3
LR, WARMUP = 1e-3, 1
B, S = 4, 32
RING_SHAPE = dict(B=2, S=64, Hq=4, Hkv=2, D=16)
COLLECTIVE_AXIS = "expert"  # size 4 in the data 2 x expert 4 mesh
PERM = [(0, 1), (1, 2), (2, 0)]  # position 3 sends and receives nothing
# the pipeline step (tests/test_pipeline.py's _tiny_cfg, float32, no remat):
# (name, mesh dims, microbatches, batch) for the loss and gradients
PP_CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_heads=4, num_kv_heads=2,
              max_seq_len=32, rope_theta=10000.0, remat=False)
PP_CASES = [("pipe2_fsdp2_tensor2", dict(data=1, pipe=2, fsdp=2, tensor=2), 2, 4),
            ("pipe4_tensor2", dict(data=1, pipe=4, tensor=2), 3, 6)]
PP_TRAIN_DIMS = dict(data=1, pipe=2, fsdp=2, tensor=2)
PP_TRAIN_STEPS, PP_TRAIN_LR, PP_SEQ = 6, 1e-2, 16


def batch(seed: int = 0, vocab: int = 256):
    """Tokens and targets [B, S]: next tokens with a scatter of -100, so the
    shards hold different numbers of valid targets."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    targets[rng.random((B, S)) < 0.15] = -100
    targets[0, : S // 2] = -100  # one data shard far fewer valid targets than the others
    return tokens, targets


def pp_batch(batch: int, seed: int):
    """Tokens and targets [batch, PP_SEQ] over PP_CFG's vocabulary."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, PP_CFG["vocab_size"], (batch, PP_SEQ)).astype(np.int32)
    targets = rng.integers(0, PP_CFG["vocab_size"], (batch, PP_SEQ)).astype(np.int32)
    return tokens, targets


def ring_inputs(seed: int = 3):
    r = RING_SHAPE
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((r["B"], r["S"], r["Hq"], r["D"])).astype(np.float32)
    k = rng.standard_normal((r["B"], r["S"], r["Hkv"], r["D"])).astype(np.float32)
    v = rng.standard_normal((r["B"], r["S"], r["Hkv"], r["D"])).astype(np.float32)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, dout


def collective_inputs(rank: int):
    """Each rank's float and int pieces [4, 6] (a function of the rank) and
    the cotangent used for the gradients."""
    rng = np.random.default_rng(100 + rank)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    xi = rng.integers(-50, 50, (4, 6)).astype(np.int32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    return x, xi, w


def _flat(params) -> dict:
    from torch.distributed.tensor import DTensor

    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"layers.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach() for k, v in out.items()}


def _load_tree(path: str) -> dict:
    with np.load(path) as f:
        params_np = {"layers": {}}
        for k in f.files:
            if k.startswith("layers."):
                params_np["layers"][k[len("layers."):]] = f[k]
            else:
                params_np[k] = f[k]
    return params_np


def _llama_layouts(rank: int, args: dict, out: dict) -> None:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import spmd

    params_np = _load_tree(args["llama_npz"])
    tokens, targets = batch()
    for name, dims, attn, remat in LAYOUTS:
        cfg = llama.LlamaConfig.tiny()
        if remat:
            cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat)
        mesh = make_mesh(8, **dims, device_type="cpu")
        opt = spmd.make_optimizer(LR, warmup=WARMUP)
        state = spmd.state_from_jax(params_np, cfg, mesh, opt)
        step = spmd.make_train_step(cfg, mesh, opt, flash_attention if attn == "flash" else None)
        step = step(state)
        losses, norms = [], []
        for _ in range(STEPS):
            state, m = step(state, tokens, targets)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        spmd.check_opt_shardings(cfg, mesh, state)
        full = _flat(state.params)
        if rank == 0:
            out[f"{name}.loss"] = np.array(losses)
            out[f"{name}.grad_norm"] = np.array(norms)
            out.update({f"{name}.param.{k}": v for k, v in full.items()})


def _moe(rank: int, args: dict, out: dict) -> None:
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.model_parallel import moe_forward

    params_np = _load_tree(args["moe_npz"])
    cfg = moe.MoEConfig.tiny()
    mesh = make_mesh(8, data=2, expert=4, device_type="cpu")
    params = shd.shard_params(moe.from_jax(params_np, cfg, "cpu"), moe.logical_axes(cfg), mesh)
    tokens = np.random.default_rng(1).integers(0, cfg.base.vocab_size, (2, 16))
    logits, aux = moe_forward(params, tokens, cfg, mesh)
    full = logits.full_tensor()
    if rank == 0:
        out["moe.logits"] = full
        out["moe.aux"] = aux.detach()


def pp_cfg(layers: int):
    from ray_tpu_torch.models import llama

    return llama.LlamaConfig(num_layers=layers, dtype=torch.float32, **PP_CFG)


def _pipeline(rank: int, args: dict, out: dict) -> None:
    """The PP loss and gradients of each PP_CASES layout, PP_TRAIN_STEPS
    pipeline train steps, and make_auto_train_step on a pipe mesh, from the
    JAX init's weights."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.train import spmd

    cfg = pp_cfg(4)
    for name, dims, microbatches, n in PP_CASES:
        mesh = make_mesh(8, **dims, device_type="cpu")
        params = llama.from_jax(_load_tree(args["pp_grad_npz"]), cfg, "cpu")
        loss, grads = pipeline.make_pp_loss_and_grad(cfg, mesh, microbatches)(
            params, *pp_batch(n, 1))
        full = _flat(grads)
        out[f"pp.{name}.loss"] = loss
        if rank == 0:
            out.update({f"pp.{name}.grad.{k}": v for k, v in full.items()})
    cfg = pp_cfg(2)
    mesh = make_mesh(8, **PP_TRAIN_DIMS, device_type="cpu")
    opt = spmd.make_optimizer(PP_TRAIN_LR, warmup=1)
    state = spmd.pp_state_from_jax(_load_tree(args["pp_train_npz"]), cfg, mesh, opt)
    step = pipeline.make_pp_train_step(cfg, mesh, 2, optimizer=opt)(state)
    tokens, targets = pp_batch(4, 2)
    losses, norms = [], []
    for _ in range(PP_TRAIN_STEPS):
        state, m = step(state, tokens, targets)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = _flat(state.params)
    if rank == 0:
        out["pp.train.loss"], out["pp.train.grad_norm"] = np.array(losses), np.array(norms)
        out.update({f"pp.train.param.{k}": v for k, v in full.items()})
    # the auto step on the pipe mesh, one step from the JAX init's weights
    state = spmd.pp_state_from_jax(_load_tree(args["pp_auto_npz"]), cfg, mesh)
    step = spmd.make_auto_train_step(cfg, mesh, num_microbatches=2)(state)
    _, m = step(state, *pp_batch(4, 5))
    if rank == 0:
        out["pp.auto.loss"], out["pp.auto.module"] = float(m["loss"]), step.__module__


def _ring(rank: int, out: dict) -> None:
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh(8, data=1, seq=8, device_type="cpu")
    q, k, v, dout = (torch.from_numpy(a) for a in ring_inputs())
    n, me = 8, mesh.get_local_rank("seq")
    blk = q.shape[1] // n
    piece = [t[:, me * blk:(me + 1) * blk].clone().requires_grad_() for t in (q, k, v)]
    o = ring_attention(*piece, mesh, seq_axis="seq")
    (o * dout[:, me * blk:(me + 1) * blk]).sum().backward()
    out["ring.o"], out["ring.dq"], out["ring.dk"], out["ring.dv"] = (
        o.detach(), *(p.grad for p in piece))
    # the same call on DTensors of the global inputs gives the same blocks
    rep = shd.replicated(mesh)
    dq, dk, dv = (DTensor.from_local(t, mesh, rep, run_check=False) for t in (q, k, v))
    od = ring_attention(dq, dk, dv, mesh, seq_axis="seq")
    out["ring.dtensor_o"] = od.to_local()


def _collectives(rank: int, out: dict) -> None:
    from ray_tpu_torch.parallel.collectives import DeviceCollectiveGroup
    from ray_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(8, data=2, expert=4, device_type="cpu")
    g = DeviceCollectiveGroup(mesh, COLLECTIVE_AXIS)
    x, xi, w = (torch.from_numpy(a) for a in collective_inputs(rank))
    out["coll.rank"], out["coll.size"] = g.rank(), g.size()
    for op in ("sum", "max", "min", "mean"):
        out[f"coll.allreduce_{op}"] = g.allreduce(x, op)
        out[f"coll.allreduce_{op}_int"] = g.allreduce(xi, op)
    fwd = {
        "allgather0": lambda t: g.allgather(t, axis=0),
        "allgather1": lambda t: g.allgather(t, axis=1),
        "allgather_untiled": lambda t: g.allgather(t, axis=0, tiled=False),
        "reducescatter0": lambda t: g.reducescatter(t, axis=0),
        "broadcast2": lambda t: g.broadcast(t, root=2),
        "all_to_all": lambda t: g.all_to_all(t, split_axis=0, concat_axis=1),
        "permute": lambda t: g.permute(t, PERM),
        "ring": lambda t: g.send_recv_ring(t, 1),
        "ring_back": lambda t: g.send_recv_ring(t, -1),
    }
    for name, fn in fwd.items():
        out[f"coll.{name}_int"] = fn(xi)
        xg = x.clone().requires_grad_()
        y = fn(xg)
        out[f"coll.{name}"] = y.detach()
        # the cotangent w, tiled or cut to the output's shape
        wy = torch.from_numpy(np.resize(w.numpy(), tuple(y.shape)))
        (y * wy).sum().backward()
        out[f"coll.{name}_grad"] = xg.grad
    xg = x.clone().requires_grad_()
    (g.allreduce(xg, "sum") * w).sum().backward()
    out["coll.allreduce_sum_grad"] = xg.grad


def world_checks(rank: int, world: int, args: dict) -> dict:
    """Every multi-rank check in one world of 8 CPU ranks."""
    from ray_tpu_torch.parallel.dryrun import _rank as dryrun_rank

    assert world == 8, world
    out: dict = {}
    t0 = time.monotonic()
    _llama_layouts(rank, args, out)
    t1 = time.monotonic()
    _pipeline(rank, args, out)
    out["pipeline_seconds"] = time.monotonic() - t1
    _moe(rank, args, out)
    _ring(rank, out)
    _collectives(rank, out)
    t1 = time.monotonic()
    out["dryrun_lines"] = dryrun_rank(rank, world, {"device_type": "cpu"})["lines"]
    out["dryrun_seconds"] = time.monotonic() - t1
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------- launcher checks
def echo(rank: int, world: int, args: dict) -> dict:
    return {"rank": rank, "world": world, "args": args,
            "threads": torch.get_num_threads(), "omp": os.environ.get("OMP_NUM_THREADS"),
            "square": np.arange(3) * rank, "tensor": torch.full((2,), float(rank))}


def sleep_past_deadline(rank: int, world: int, args: dict) -> dict:
    """Rank 1 starts a child process, writes its pid, and sleeps past any
    deadline; the other ranks return at once."""
    if rank == 1:
        child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(600)"])
        with open(args["child_pid_file"], "w") as f:
            f.write(str(child.pid))
        time.sleep(600)
    return {}


def fail_on_rank(rank: int, world: int, args: dict) -> dict:
    if rank == args["rank"]:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return {}
