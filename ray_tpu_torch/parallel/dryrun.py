"""Multi-rank dry run: the port of ``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n, device_type=None)`` launches ``n`` ranks
(``parallel.launch``) that build an n-rank mesh with real dp/fsdp/tp/sp
dims and run one FULL training step (forward, backward, AdamW; ring
attention on the seq dim) of ``LlamaConfig.tiny()`` over it, with the
reference's layouts table; at 8 ranks a second, dense layout (data, fsdp
and seq all active); at multiples of 4 the MoE forward with its experts
sharded over ``expert``; at multiples of 8 one GPipe step
(``parallel.pipeline``) of 2 microbatches on a data x pipe 2 x fsdp 2 x
tensor 2 mesh. ``device_type=None`` puts each rank on its own card over
NCCL (``n`` cards needed); ``"cpu"`` runs the ranks over gloo.

Returns rank 0's report lines (each also printed).
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

LAYOUTS = {
    1: dict(data=1),
    2: dict(data=1, fsdp=2),
    4: dict(data=1, fsdp=2, tensor=2),
    8: dict(data=1, fsdp=2, tensor=2, seq=2),
    16: dict(data=2, fsdp=2, tensor=2, seq=2),
    32: dict(data=2, fsdp=2, tensor=4, seq=2),
}


def layout_for(n: int) -> dict:
    return LAYOUTS.get(n, dict(data=-1, fsdp=2) if n % 2 == 0 else dict(data=-1))


def _train_one_step(n: int, layout: dict, device_type: str, seed: int) -> tuple[dict, float]:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from ray_tpu_torch.train import spmd

    mesh = make_mesh(n, **layout, device_type=device_type)
    shape = mesh_shape(mesh)
    cfg = llama.LlamaConfig.tiny()
    state = spmd.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = spmd.make_train_step(cfg, mesh)(state)
    batch = shape["data"] * shape["fsdp"]
    seqlen = 16 * max(1, shape["seq"])
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seqlen))
    targets = rng.integers(0, cfg.vocab_size, (batch, seqlen))
    _, metrics = step(state, tokens, targets)
    loss = float(metrics["loss"])
    assert loss == loss and loss > 0, f"bad loss {loss}"
    return shape, loss


def _rank(rank: int, world: int, args: dict) -> dict:
    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel import sharding as shd
    from ray_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from ray_tpu_torch.parallel.model_parallel import moe_forward
    from ray_tpu_torch.train import spmd

    n, device_type = world, args["device_type"]
    lines, losses = [], {}
    shape, losses["main"] = _train_one_step(n, layout_for(n), device_type, 1)
    lines.append(f"dryrun_multichip({n}): mesh={shape} loss={losses['main']:.4f} OK")
    if n == 8:
        shape, losses["dense"] = _train_one_step(8, dict(data=2, fsdp=2, seq=2), device_type, 1)
        lines.append(f"dryrun_multichip({n}): dense mesh={shape} loss={losses['dense']:.4f} OK")
    if n >= 8 and n % 8 == 0:
        pp_mesh = make_mesh(n, data=n // 8, pipe=2, fsdp=2, tensor=2, device_type=device_type)
        cfg = llama.LlamaConfig.tiny()
        pp_state = spmd.init_state(cfg, torch.Generator().manual_seed(3), device="cpu")
        pp_step = pipeline.make_pp_train_step(cfg, pp_mesh, num_microbatches=2)(pp_state)
        shape = mesh_shape(pp_mesh)
        tokens = np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2 * shape["data"] * shape["fsdp"], 16))
        _, metrics = pp_step(pp_state, tokens, tokens)
        losses["pipeline"] = float(metrics["loss"])
        assert losses["pipeline"] == losses["pipeline"] and losses["pipeline"] > 0, (
            f"bad PP loss {losses['pipeline']}")
        lines.append(f"dryrun_multichip({n}): pipeline mesh={shape} microbatches=2 "
                     f"loss={losses['pipeline']:.4f} OK")
    if n >= 4 and n % 4 == 0:
        ep_mesh = make_mesh(n, data=n // 4, expert=4, device_type=device_type)
        mcfg = moe.MoEConfig.tiny()
        params = shd.shard_params(moe.init(mcfg, torch.Generator().manual_seed(2), "cpu"),
                                  moe.logical_axes(mcfg), ep_mesh)
        shape = mesh_shape(ep_mesh)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, mcfg.base.vocab_size, (shape["data"] * shape["fsdp"], 16))
        logits, _ = moe_forward(params, tokens, mcfg, ep_mesh)
        mval = float(logits.to_local().abs().mean())
        assert mval == mval, "MoE EP produced NaN"
        losses["moe_mean_abs_logit_rank0"] = mval
        lines.append(f"dryrun_multichip({n}): MoE expert-parallel mesh={shape} OK")
    return {"lines": lines, "losses": losses}


def dryrun_multichip(n_devices: int, device_type: str | None = None,
                     deadline_s: float = 300.0) -> list[str]:
    from ray_tpu_torch.parallel.launch import launch
    from ray_tpu_torch.parallel.mesh import _device_type

    kind = _device_type(device_type)
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on cards needs {n_devices} of "
                           f"them, this host has {torch.cuda.device_count()}")
    run_dir = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        results = launch("ray_tpu_torch.parallel.dryrun:_rank", n_devices, run_dir,
                         args={"device_type": kind}, deadline_s=deadline_s)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    for line in results[0]["lines"]:
        print(line, flush=True)
    return results[0]["lines"]
