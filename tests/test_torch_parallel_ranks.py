"""The port's parallel layer across ranks: ray_tpu_torch.parallel and the
mesh step of ray_tpu_torch.train.spmd on 8 CPU ranks over gloo, each check
held to the JAX package on the same inputs (made with numpy from a seed and
the JAX init's weights).

The ranks run ONCE per test session, whatever xdist does: the
``world`` fixture takes a file lock under the session's shared temp dir
(the pattern pytest-xdist documents for session fixtures); the first worker
to get it launches one world of 8 ranks (``parallel.launch``, deadline
300 s, FileStore rendezvous, no port, nothing in /dev/shm) running
``torch_parallel_rank_checks.world_checks``, which builds a DeviceMesh per
layout over the same 8 ranks; the other workers read its files. Each test
then runs its JAX side in its own process, on the conftest's 8 host
devices, under a 60 s deadline of its own (SIGALRM, started after the
fixture).

Tolerances (float32 everywhere, the same sums in other orders across
shards): loss and grad norm of 3 steps rtol 1e-5 and parameters after them
atol 1e-5, as tests/test_torch_train.py holds the one-device step. The
pipeline step (tests/test_pipeline.py's cases, held to
ray_tpu.parallel.pipeline) the same: its loss rtol 1e-5 and every gradient
leaf atol 1e-5; the losses and grad norms of 6 steps rtol 1e-5 and the
parameters after them atol 1e-5, but lm_head's at 2e-4: at lr 1e-2 an Adam
step of an lm_head entry whose gradient is near zero turns rounding into a
parameter gap (the port read 7.4e-5 at one of 4096 entries; the JAX
package's own pipeline and one-device steps part by 1.6e-4 there, its flat
data 2 x fsdp 2 and one-device steps by 9.1e-5). The pipe mesh's auto step
against the JAX auto step on a flat data 2 x fsdp 2 mesh: rtol 1e-4, the
reference test's limit (the two layouts sum the loss in other orders).
Ring attention output and gradients atol 1e-5; collectives exact for ints
and 1e-6 for floats; the MoE expert-parallel logits atol 1e-4, as
tests/test_models_extra.py holds the JAX EP forward to the unsharded one.
"""

import dataclasses
import functools
import json
import os
import signal
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from filelock import FileLock

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jm
from ray_tpu.parallel import collectives as jcoll
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel._compat import shard_map
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.parallel.ring_attention import make_ring_attn_fn, ring_attention
from ray_tpu.train import spmd as js
from ray_tpu_torch.parallel.launch import launch

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_rank_checks as rc  # noqa: E402

DEADLINE_S = 60
LAUNCH_DEADLINE_S = 300
WORLD = 8
LAYOUT_NAMES = [name for name, *_ in rc.LAYOUTS]
PP_NAMES = [name for name, *_ in rc.PP_CASES]
# the JAX init key of each pipeline check's weights (tests/test_pipeline.py's)
PP_KEYS = {"pp_grad": (4, 1), "pp_train": (2, 2), "pp_auto": (2, 5)}  # (layers, key)


def _save_tree(path, tree):
    flat = {f"layers.{k}": np.asarray(v) for k, v in tree["layers"].items()}
    flat.update({k: np.asarray(v) for k, v in tree.items() if k != "layers"})
    np.savez(path, **flat)


def _launch_world(root: Path) -> None:
    _save_tree(root / "llama.npz", jl.init(jl.LlamaConfig.tiny(), jax.random.PRNGKey(0)))
    _save_tree(root / "moe.npz", jm.init(jm.MoEConfig.tiny(), jax.random.PRNGKey(0)))
    for name, (layers, key) in PP_KEYS.items():
        _save_tree(root / f"{name}.npz", jl.init(_jax_pp_cfg(layers), jax.random.PRNGKey(key)))
    shm_before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    try:
        results = launch("torch_parallel_rank_checks:world_checks", WORLD, root / "run",
                         args={"llama_npz": str(root / "llama.npz"),
                               "moe_npz": str(root / "moe.npz"),
                               **{f"{n}_npz": str(root / f"{n}.npz") for n in PP_KEYS}},
                         deadline_s=LAUNCH_DEADLINE_S, pythonpath=[Path(__file__).parent])
    except Exception as e:  # the other workers re-raise it
        (root / "error.txt").write_text(f"{type(e).__name__}: {e}")
        raise
    shm_after = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    pids = [r["pid"] for r in results]
    for r, res in enumerate(results):
        arrays = {k: v for k, v in res.items() if isinstance(v, np.ndarray)}
        np.savez(root / f"rank{r}.npz", **arrays)
        (root / f"rank{r}.json").write_text(json.dumps(
            {k: v for k, v in res.items() if not isinstance(v, np.ndarray)}))
    (root / "done.json").write_text(json.dumps(
        {"pids": pids, "shm_new": sorted(shm_after - shm_before)}))


@pytest.fixture(scope="session")
def world(tmp_path_factory):
    """Every rank's results (a dict per rank) and the launch's record."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = (base.parent / f"torch_parallel_ranks_{run_id}") if run_id else (
        base / "torch_parallel_ranks")
    root.mkdir(parents=True, exist_ok=True)
    with FileLock(str(root) + ".lock"):
        if (root / "error.txt").exists():
            pytest.fail((root / "error.txt").read_text())
        if not (root / "done.json").exists():
            _launch_world(root)
    ranks = []
    for r in range(WORLD):
        res = json.loads((root / f"rank{r}.json").read_text())
        with np.load(root / f"rank{r}.npz") as f:
            res.update({k: f[k] for k in f.files})
        ranks.append(res)
    record = {"ranks": ranks, **json.loads((root / "done.json").read_text())}
    yield record
    # teardown: every rank process of the launch is gone
    assert not [p for p in record["pids"] if _alive(p)], record["pids"]


@pytest.fixture(autouse=True)
def _deadline(world):
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, DEADLINE_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _mesh(**dims):
    return make_mesh(WORLD, devices=jax.devices("cpu")[:WORLD], **dims)


@functools.lru_cache(maxsize=None)
def _jax_run(name: str):
    """The JAX mesh step of layout ``name``: losses, grad norms and the
    parameters after rc.STEPS steps, from PRNGKey(0)'s init."""
    _, dims, attn, remat = next(layout for layout in rc.LAYOUTS if layout[0] == name)
    cfg = jl.LlamaConfig.tiny()
    if remat:
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat)
    mesh = _mesh(**dims)
    opt = js.make_optimizer(rc.LR, warmup=rc.WARMUP)
    state = js.init_state(cfg, jax.random.PRNGKey(0), opt)
    attn_fn = make_ring_attn_fn(mesh, "seq") if attn == "ring" else None
    step = js.make_train_step(cfg, mesh, optimizer=opt, attn_fn=attn_fn)(state)
    tokens, targets = (jnp.asarray(a) for a in rc.batch())
    losses, norms = [], []
    for _ in range(rc.STEPS):
        state, m = step(state, tokens, targets)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = {f"layers.{k}": np.asarray(v) for k, v in state.params["layers"].items()}
    params.update({k: np.asarray(v) for k, v in state.params.items() if k != "layers"})
    return np.array(losses), np.array(norms), params


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_mesh_step_loss_and_grad_norm_match_jax(world, name):
    got = world["ranks"][0]
    losses, norms, _ = _jax_run(name)
    np.testing.assert_allclose(got[f"{name}.loss"], losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[f"{name}.grad_norm"], norms, rtol=1e-5, atol=0)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_mesh_step_params_after_three_steps_match_jax(world, name):
    got = world["ranks"][0]
    _, _, params = _jax_run(name)
    for k, want in params.items():
        np.testing.assert_allclose(got[f"{name}.param.{k}"], want, atol=1e-5, rtol=0,
                                   err_msg=f"{name}: {k}")


def _jax_pp_cfg(layers: int):
    return jl.LlamaConfig(num_layers=layers, dtype=jnp.float32, **rc.PP_CFG)


def _flat_tree(tree) -> dict:
    out = {f"layers.{k}": np.asarray(v) for k, v in tree["layers"].items()}
    out.update({k: np.asarray(v) for k, v in tree.items() if k != "layers"})
    return out


@functools.lru_cache(maxsize=None)
def _jax_pp_grads(name: str):
    """ray_tpu.parallel.pipeline.make_pp_loss_and_grad's loss and gradients
    on layout ``name``."""
    _, dims, microbatches, n = next(c for c in rc.PP_CASES if c[0] == name)
    layers, key = PP_KEYS["pp_grad"]
    cfg = _jax_pp_cfg(layers)
    params = jl.init(cfg, jax.random.PRNGKey(key))
    lg = jpipe.make_pp_loss_and_grad(cfg, _mesh(**dims), num_microbatches=microbatches)
    loss, grads = jax.jit(lg)(params, *(jnp.asarray(a) for a in rc.pp_batch(n, 1)))
    return float(loss), _flat_tree(grads)


@pytest.mark.parametrize("name", PP_NAMES)
def test_pp_loss_matches_jax_pipeline(world, name):
    want, _ = _jax_pp_grads(name)
    np.testing.assert_allclose(world["ranks"][0][f"pp.{name}.loss"], want, rtol=1e-5, atol=0)
    # every rank holds the same global loss
    for r in range(WORLD):
        np.testing.assert_allclose(world["ranks"][r][f"pp.{name}.loss"], want, rtol=1e-5)


@pytest.mark.parametrize("name", PP_NAMES)
def test_pp_every_gradient_leaf_matches_jax_pipeline(world, name):
    _, grads = _jax_pp_grads(name)
    got = world["ranks"][0]
    assert {k for k in got if k.startswith(f"pp.{name}.grad.")} == {
        f"pp.{name}.grad.{k}" for k in grads}
    for k, want in grads.items():
        np.testing.assert_allclose(got[f"pp.{name}.grad.{k}"], want, atol=1e-5, rtol=0,
                                   err_msg=f"{name}: {k}")


@functools.lru_cache(maxsize=None)
def _jax_pp_train():
    """rc.PP_TRAIN_STEPS steps of the JAX pipeline step: losses, grad norms,
    the parameters after them."""
    layers, key = PP_KEYS["pp_train"]
    cfg = _jax_pp_cfg(layers)
    opt = js.make_optimizer(learning_rate=rc.PP_TRAIN_LR, warmup=1)
    state = js.init_state(cfg, jax.random.PRNGKey(key), optimizer=opt)
    step = jpipe.make_pp_train_step(cfg, _mesh(**rc.PP_TRAIN_DIMS), num_microbatches=2,
                                    optimizer=opt)(state)
    tokens, targets = (jnp.asarray(a) for a in rc.pp_batch(4, 2))
    losses, norms = [], []
    for _ in range(rc.PP_TRAIN_STEPS):
        state, m = step(state, tokens, targets)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms), _flat_tree(state.params)


def test_pp_train_steps_losses_and_grad_norms_match_jax(world):
    losses, norms, _ = _jax_pp_train()
    got = world["ranks"][0]
    np.testing.assert_allclose(got["pp.train.loss"], losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["pp.train.grad_norm"], norms, rtol=1e-5, atol=0)
    assert losses[-1] < losses[0] - 0.5  # learning, as the reference test asks


def test_pp_params_after_train_steps_match_jax(world):
    _, _, params = _jax_pp_train()
    got = world["ranks"][0]
    for k, want in params.items():
        np.testing.assert_allclose(got[f"pp.train.param.{k}"], want, rtol=0, err_msg=k,
                                   atol=2e-4 if k == "lm_head" else 1e-5)


def test_auto_train_step_dispatches_pipe_mesh_to_pipeline(world):
    """The port's make_auto_train_step on the pipe mesh runs the pipeline
    step, whose first loss is the JAX auto step's on a flat data 2 x fsdp 2
    mesh (rtol 1e-4, as tests/test_pipeline.py holds the two) and on the
    pipe mesh (rtol 1e-5)."""
    layers, key = PP_KEYS["pp_auto"]
    cfg = _jax_pp_cfg(layers)
    tokens, targets = (jnp.asarray(a) for a in rc.pp_batch(4, 5))
    want = {}
    for label, mesh in (("flat", make_mesh(4, devices=jax.devices("cpu")[:4], data=2, fsdp=2)),
                        ("pipe", _mesh(**rc.PP_TRAIN_DIMS))):
        state = js.init_state(cfg, jax.random.PRNGKey(key))
        step = js.make_auto_train_step(cfg, mesh, num_microbatches=2)(state)
        want[label] = float(step(state, tokens, targets)[1]["loss"])
    got = world["ranks"][0]
    assert got["pp.auto.module"] == "ray_tpu_torch.parallel.pipeline"
    np.testing.assert_allclose(got["pp.auto.loss"], want["flat"], rtol=1e-4)
    np.testing.assert_allclose(got["pp.auto.loss"], want["pipe"], rtol=1e-5)


def _ring_blocks(world, key):
    return np.concatenate([world["ranks"][r][key] for r in range(WORLD)], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_ring():
    """JAX's ring attention over a seq 8 mesh and its dense attention: the
    output and the gradients of sum(out * dout)."""
    q, k, v, dout = (jnp.asarray(a) for a in rc.ring_inputs())
    mesh = _mesh(data=1, seq=WORLD)

    def loss(fn, q, k, v):
        return (fn(q, k, v) * dout).sum()

    ring = lambda q, k, v: ring_attention(q, k, v, mesh)  # noqa: E731
    dense = lambda q, k, v: jl.attention(q, k, v, causal=True)  # noqa: E731
    grad = functools.partial(jax.grad, argnums=(0, 1, 2))
    return {name: (jax.jit(fn)(q, k, v), jax.jit(grad(functools.partial(loss, fn)))(q, k, v))
            for name, fn in (("ring", ring), ("dense", dense))}


def test_ring_attention_forward_matches_jax_ring_and_dense(world):
    got = _ring_blocks(world, "ring.o")
    for name, (want, _) in _jax_ring().items():
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_array_equal(_ring_blocks(world, "ring.dtensor_o"), got)


def test_ring_attention_gradients_match_jax_ring_and_dense(world):
    got = [_ring_blocks(world, f"ring.{g}") for g in ("dq", "dk", "dv")]
    for name, (_, grads) in _jax_ring().items():
        for label, g, want in zip(("dq", "dk", "dv"), got, grads):
            np.testing.assert_allclose(g, np.asarray(want), atol=1e-5, rtol=0,
                                       err_msg=f"{name} {label}")


def _jax_collective(name: str, dtype):
    """The JAX group's result on every device of a data 2 x expert 4 mesh
    (device i holds rank i's piece), and for floats the gradient of
    sum(out * w) with each rank's cotangent tiled to its output."""
    mesh = _mesh(data=2, expert=4)
    g = jcoll.DeviceCollectiveGroup(rc.COLLECTIVE_AXIS)
    pieces = [rc.collective_inputs(r) for r in range(WORLD)]
    x = np.stack([p[1] if dtype == "int" else p[0] for p in pieces])  # [8, 4, 6]
    w = np.stack([p[2] for p in pieces])
    ops = {
        "allreduce_sum": lambda t: g.allreduce(t, "sum"),
        "allreduce_max": lambda t: g.allreduce(t, "max"),
        "allreduce_min": lambda t: g.allreduce(t, "min"),
        "allreduce_mean": lambda t: g.allreduce(t, "mean"),
        "allgather0": lambda t: g.allgather(t, axis=0),
        "allgather1": lambda t: g.allgather(t, axis=1),
        "allgather_untiled": lambda t: g.allgather(t, axis=0, tiled=False),
        "reducescatter0": lambda t: g.reducescatter(t, axis=0),
        "broadcast2": lambda t: g.broadcast(t, root=2),
        "all_to_all": lambda t: g.all_to_all(t, split_axis=0, concat_axis=1),
        "permute": lambda t: g.permute(t, rc.PERM),
        "ring": lambda t: jax.lax.ppermute(t, rc.COLLECTIVE_AXIS, [(i, (i + 1) % 4)
                                                                   for i in range(4)]),
        "ring_back": lambda t: jax.lax.ppermute(t, rc.COLLECTIVE_AXIS, [(i, (i - 1) % 4)
                                                                        for i in range(4)]),
    }
    spec = jax.sharding.PartitionSpec(("data", "pipe", "fsdp", "tensor", "seq", "expert"))
    f = shard_map(lambda t: ops[name](t[0])[None], mesh=mesh, in_specs=spec, out_specs=spec,
                  check_vma=False)
    out = np.asarray(f(jnp.asarray(x)))
    grad = None
    if dtype == "float" and not name.startswith(("allreduce_max", "allreduce_min",
                                                 "allreduce_mean")):
        wy = np.stack([np.resize(w[r], out.shape[1:]) for r in range(WORLD)])
        grad = np.asarray(jax.grad(lambda t: (f(t) * wy).sum())(jnp.asarray(x)))
    return out, grad


COLLECTIVES = ["allreduce_sum", "allreduce_max", "allreduce_min", "allreduce_mean", "allgather0",
               "allgather1", "allgather_untiled", "reducescatter0", "broadcast2", "all_to_all",
               "permute", "ring", "ring_back"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_jax(world, name):
    for dtype, suffix in (("float", ""), ("int", "_int")):
        want, want_grad = _jax_collective(name, dtype)
        for r in range(WORLD):
            got = world["ranks"][r][f"coll.{name}{suffix}"]
            if dtype == "int" and not name.endswith("mean"):
                assert got.dtype == np.int32, (name, got.dtype)
                np.testing.assert_array_equal(got, want[r], err_msg=f"{name} rank {r}")
            else:
                np.testing.assert_allclose(got, want[r], atol=1e-6, rtol=1e-6,
                                           err_msg=f"{name}{suffix} rank {r}")
            if want_grad is not None:
                np.testing.assert_allclose(world["ranks"][r][f"coll.{name}_grad"],
                                           want_grad[r], atol=1e-6, rtol=1e-6,
                                           err_msg=f"{name} grad rank {r}")


def test_collective_group_rank_and_size(world):
    assert [world["ranks"][r]["coll.rank"] for r in range(WORLD)] == [r % 4 for r in range(WORLD)]
    assert {world["ranks"][r]["coll.size"] for r in range(WORLD)} == {4}


def test_moe_expert_parallel_matches_jax_unsharded(world):
    cfg = jm.MoEConfig.tiny()
    params = jm.init(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.base.vocab_size, (2, 16))
    want, aux = jm.forward(params, jnp.asarray(tokens), cfg)
    got = world["ranks"][0]
    np.testing.assert_allclose(got["moe.logits"], np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["moe.aux"], float(aux), rtol=1e-5)


def test_dryrun_rank_body_runs_every_part(world):
    lines = world["ranks"][0]["dryrun_lines"]
    assert len(lines) == 4, lines
    assert "fsdp': 2, 'tensor': 2, 'seq': 2" in lines[0] and "OK" in lines[0]
    assert "dense" in lines[1] and "OK" in lines[1]
    assert "pipeline mesh=" in lines[2] and "microbatches=2" in lines[2] and "OK" in lines[2]
    assert "'pipe': 2, 'fsdp': 2, 'tensor': 2" in lines[2]
    assert "MoE expert-parallel" in lines[3] and "OK" in lines[3]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_launch_left_no_process_and_no_shared_memory(world):
    assert len(world["pids"]) == WORLD
    assert not [p for p in world["pids"] if _alive(p)]
    # torch.multiprocessing names its segments torch_<pid>_...; the ranks made none
    assert not [n for n in world["shm_new"] if any(str(p) in n for p in world["pids"])]
    assert max(r["seconds"] for r in world["ranks"]) < LAUNCH_DEADLINE_S
