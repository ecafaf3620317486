"""The port's parallel layer in one process: ray_tpu_torch.parallel's mesh
spec, rule table, placements, logical-axis trees, the pipeline step's
placement trees and refusals, ring-attention tile and host collectives
against ray_tpu.parallel on the same inputs (numpy from a
seed), and the rank launcher's deadline and failure handling.

Tolerances: the attention tile in float32 on both sides, atol 1e-6 (the
same einsums and exponentials, summed in other orders); everything else is
exact (specs, trees, placements, values passed through).
"""

import ast
import dataclasses
import signal
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jm
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel import ring_attention as jring
from ray_tpu.parallel import sharding as jshd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.parallel import collectives, launch
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel import ring_attention as tring
from ray_tpu_torch.parallel import sharding as tshd

CHECKS = str(Path(__file__).parent)
DEADLINE_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


# ---------------------------------------------------------------- mesh spec
@pytest.mark.parametrize("spec, n", [
    (dict(data=-1, tensor=2), 8), (dict(data=1, fsdp=2, tensor=2, seq=2), 8),
    (dict(data=2, fsdp=2, tensor=4, seq=2), 32), (dict(data=-1, fsdp=2), 6), (dict(), 1),
    (dict(data=1, pipe=2, fsdp=2, tensor=2), 8), (dict(data=-1, expert=4), 8),
    (dict(data=3, tensor=3), 8), (dict(data=-1, tensor=3), 8), (dict(data=-1, fsdp=-1), 8),
    (dict(data=2, fsdp=2), 8),
])
def test_mesh_spec_resolve_matches_jax(spec, n):
    try:
        want = jmesh.MeshSpec(**spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec(**spec).resolve(n)
        assert str(got.value) == str(e)
        return
    assert tmesh.MeshSpec(**spec).resolve(n) == want
    assert tmesh.AXES == jmesh.AXES


def test_multislice_env_and_slice_info(monkeypatch):
    env = tmesh.multislice_env("10.0.0.1:8080", 4, 2)
    assert env == {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "8080", "NNODES": "4",
                   "NODE_RANK": "2", "GROUP_RANK": "2"}
    for k, v in dict(WORLD_SIZE="16", LOCAL_WORLD_SIZE="8", GROUP_RANK="1",
                     LOCAL_RANK="3").items():
        monkeypatch.setenv(k, v)
    info = tmesh.SliceInfo.detect()
    assert (info.num_nodes, info.node_id, info.local_rank, info.local_world_size) == (2, 1, 3, 8)


def test_mesh_without_a_card_raises(monkeypatch):
    from ray_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmesh.make_mesh(1, data=1), tmesh.single_device_mesh,
                 tmesh.initialize_distributed, lambda: dryrun_multichip(1),
                 lambda: tmesh.dcn_mesh(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="device_type"):
        tmesh.make_mesh(1, device_type="tpu")


# ---------------------------------------------------------------- rule table
def _placements_of(spec: P, ndim: int) -> list:
    """A JAX PartitionSpec as placements, one per mesh axis of AXES."""
    out = [Replicate() for _ in jmesh.AXES]
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    for d, entry in enumerate(entries):
        for axis in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            out[jmesh.AXES.index(axis)] = Shard(d)
    return out


def test_rule_table_matches_jax():
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert tshd.spec_from_logical(("batch", "seq", None)) == _placements_of(
        jshd.spec_from_logical(("batch", "seq", None)), 3)
    assert tshd.spec_from_logical(("batch", "seq", None)) == [
        Shard(0), Replicate(), Shard(0), Replicate(), Shard(1), Replicate()]


def _trees():
    tied = dataclasses.replace(jl.LlamaConfig.tiny(), tie_embeddings=True)
    ttied = dataclasses.replace(tl.LlamaConfig.tiny(), tie_embeddings=True)
    return {
        "llama": (jl.logical_axes(jl.LlamaConfig.tiny()), tl.logical_axes(tl.LlamaConfig.tiny())),
        "llama_tied": (jl.logical_axes(tied), tl.logical_axes(ttied)),
        "llama_8b": (jl.logical_axes(jl.LlamaConfig.llama_8b()),
                     tl.logical_axes(tl.LlamaConfig.llama_8b())),
        "moe": (jm.logical_axes(jm.MoEConfig.tiny()), tm.logical_axes(tm.MoEConfig.tiny())),
    }


@pytest.mark.parametrize("model", ["llama", "llama_tied", "llama_8b", "moe"])
def test_logical_axes_trees_match_jax(model):
    want, got = _trees()[model]
    assert got == want


@pytest.mark.parametrize("model", ["llama", "llama_tied", "moe"])
def test_every_leaf_is_placed_as_jax_partitions_it(model):
    want, got = _trees()[model]
    flat = {f"layers.{k}": v for k, v in got["layers"].items()} | {
        k: v for k, v in got.items() if k != "layers"}
    jflat = {f"layers.{k}": v for k, v in want["layers"].items()} | {
        k: v for k, v in want.items() if k != "layers"}
    for name, axes in flat.items():
        spec = jshd.spec_from_logical(jflat[name])
        assert tshd.spec_from_logical(axes) == _placements_of(spec, len(axes)), name
    assert tshd.spec_from_logical(got["layers"]["wq"]) == [
        Replicate(), Replicate(), Shard(1), Shard(2), Replicate(), Replicate()]
    if model == "moe":
        assert tshd.spec_from_logical(got["layers"]["e_gate"])[5] == Shard(1)


def test_spec_from_logical_refuses_what_a_dtensor_cannot_hold():
    with pytest.raises(ValueError, match="mesh order"):
        tshd.spec_from_logical(("b",), {"b": ("fsdp", "data")})
    with pytest.raises(ValueError, match="two tensor dims"):
        tshd.spec_from_logical(("heads", "mlp"))


# ---------------------------------------------------------------- pipeline
def _pp_trees(tied: bool):
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), tie_embeddings=tied)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), tie_embeddings=tied)
    return jpipe.param_specs(jcfg), tpipe.param_specs(tcfg)


@pytest.mark.parametrize("tied", [False, True])
def test_pp_placement_trees_match_jax_partition_specs(tied):
    want, got = _pp_trees(tied)
    assert list(got) == list(want) and list(got["layers"]) == list(want["layers"])
    for k, spec in want["layers"].items():
        assert got["layers"][k] == _placements_of(spec, len(spec)), k
    for k in (k for k in want if k != "layers"):
        assert got[k] == _placements_of(want[k], len(want[k])), k
    assert tpipe.BATCH_SPEC == _placements_of(jpipe.BATCH_SPEC, 2)
    assert got["layers"]["wo"] == [Replicate(), Shard(0), Replicate(), Shard(1), Replicate(),
                                   Replicate()]


# (mesh dim names, sizes, LlamaConfig overrides): each a ValueError of _check
PP_REFUSALS = {
    "no_pipe_axis": (("data", "fsdp"), (2, 2), {}),
    "seq": (jmesh.AXES, (1, 2, 1, 2, 2, 1), {}),
    "expert": (jmesh.AXES, (1, 2, 1, 1, 1, 2), {}),
    "layers_over_pipe": (jmesh.AXES, (1, 2, 1, 1, 1, 1), {"num_layers": 3}),
    "heads_over_tensor": (jmesh.AXES, (1, 1, 1, 4, 1, 1), {"num_heads": 6}),
    "kv_heads_over_tensor": (jmesh.AXES, (1, 1, 1, 4, 1, 1), {}),
}


@pytest.mark.parametrize("case", list(PP_REFUSALS))
def test_pp_refusals_match_jax(case):
    """The PP step refuses what the reference refuses, with its message,
    before it touches the mesh's groups (a stand-in mesh of names and sizes)."""
    names, sizes, overrides = PP_REFUSALS[case]
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), **overrides)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), **overrides)
    devices = np.array(jax.devices("cpu")[:int(np.prod(sizes))]).reshape(sizes)
    with pytest.raises(ValueError) as want:
        jpipe.make_pp_loss_and_grad(jcfg, jax.sharding.Mesh(devices, names), 2)
    stand_in = SimpleNamespace(mesh_dim_names=names, mesh=np.zeros(sizes))
    for make in (tpipe.make_pp_loss_and_grad, tpipe.make_pp_train_step):
        with pytest.raises(ValueError) as got:
            make(tcfg, stand_in, 2)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- ring attention tile
def test_block_attn_accum_matches_jax_with_fully_masked_rows():
    rng = np.random.default_rng(0)
    B, Sq, Sk, Hq, Hkv, D = 2, 8, 8, 4, 2, 16
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    qpos = np.tile(np.arange(8, 16, dtype=np.int32), (B, 1))
    # three kv blocks: one wholly ahead of every query (all rows masked),
    # one on the diagonal, one behind; queries of the first tile see nothing
    blocks = [np.arange(16, 24), np.arange(8, 16), np.arange(0, 8)]
    o = np.zeros((B, Hkv, Hq // Hkv, Sq, D), np.float32)
    m = np.full((B, Hkv, Hq // Hkv, Sq), tring.NEG_INF, np.float32)
    l = np.zeros_like(m)
    want = (jnp.asarray(o), jnp.asarray(m), jnp.asarray(l))
    got = tuple(torch.from_numpy(a) for a in (o, m, l))
    for i, kpos in enumerate(blocks):
        k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
        kp = np.tile(kpos.astype(np.int32), (B, 1))
        want = jring._block_attn_accum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(qpos), jnp.asarray(kp), *want)
        got = tring._block_attn_accum(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(qpos),
                                      torch.from_numpy(kp), *got)
        if i == 0:  # every row is fully masked: nothing accumulated
            assert float(got[2].abs().max()) == 0.0 and float(got[0].abs().max()) == 0.0
        for label, g, w in zip(("o", "m", "l"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6,
                                       err_msg=f"block {i}: {label}")


# ---------------------------------------------------------------- launcher
def test_launch_returns_each_ranks_results(tmp_path):
    res = launch.launch("torch_parallel_rank_checks:echo", 3, tmp_path, args={"x": [1, 2]},
                        deadline_s=50, pythonpath=[CHECKS])
    assert [r["rank"] for r in res] == [0, 1, 2]
    for r, got in enumerate(res):
        assert got["world"] == 3 and got["args"] == {"x": [1, 2]}
        assert got["threads"] == 1 and got["omp"] == "1"
        np.testing.assert_array_equal(got["square"], np.arange(3) * r)
        np.testing.assert_array_equal(got["tensor"], np.full(2, float(r), np.float32))
    assert len({r["pid"] for r in res}) == 3


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_launch_kills_a_rank_past_its_deadline_and_all_it_started(tmp_path):
    child_pid = tmp_path / "child.pid"
    t0 = time.monotonic()
    with pytest.raises(launch.LaunchError, match=r"deadline of 8 s passed with rank\(s\) \[1\]") as e:
        launch.launch("torch_parallel_rank_checks:sleep_past_deadline", 2, tmp_path / "run",
                      args={"child_pid_file": str(child_pid)}, deadline_s=8, pythonpath=[CHECKS])
    assert time.monotonic() - t0 < 30
    assert "--- rank 1 stderr ---" in str(e.value)
    pids = e.value.pids + [int(child_pid.read_text())]
    deadline = time.monotonic() + 10  # the orphaned child is reaped by init
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not [p for p in pids if _alive(p)]


def test_launch_names_a_failing_rank_with_its_error(tmp_path):
    with pytest.raises(launch.LaunchError, match=r"rank\(s\) \[2\] exited with \[1\]") as e:
        launch.launch("torch_parallel_rank_checks:fail_on_rank", 3, tmp_path, args={"rank": 2},
                      deadline_s=50, pythonpath=[CHECKS])
    assert "rank 2 fails on purpose" in str(e.value)
    assert not [p for p in e.value.pids if _alive(p)]


# ---------------------------------------------------------------- host collectives
def test_host_collective_group():
    """A CPU port of tests/test_parallel.py::test_host_collective_group."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=8)
    try:
        results = {}

        def worker(rank):
            grp = collectives.init_collective_group(world_size=3, rank=rank, group_name="g1")
            val = grp.broadcast_from_rank_zero("init", value=("payload" if rank == 0 else None))
            grp.barrier(timeout=20)
            results[rank] = val

        threads = [threading.Thread(target=worker, args=(r,)) for r in range(3)]
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert results == {0: "payload", 1: "payload", 2: "payload"}
    finally:
        ray_tpu_torch.shutdown()


def test_rank_checks_module_imports_no_jax():
    """The rank processes run torch and the port only."""
    tree = ast.parse((Path(CHECKS) / "torch_parallel_rank_checks.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "ray_tpu", "optax")], names
