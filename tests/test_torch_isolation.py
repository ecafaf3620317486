"""The port stands alone: no module of ray_tpu_torch imports jax or any part
of ray_tpu, importing it starts no thread, its runtime and serve layer stay
in one process, and its entry points refuse to fall back to the CPU
silently."""

import ast
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import ray_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def test_no_module_imports_jax_or_ray_tpu():
    modules = sorted(m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                                           "ray_tpu_torch."))
    assert "ray_tpu_torch.ops.paged_attention" in modules
    assert "ray_tpu_torch.ops.flash_attention" in modules
    assert "ray_tpu_torch.train.spmd" in modules
    for name in ("models.moe", "models.vit", "serve.spec_decode", "serve.llm_paged",
                 "exceptions", "core.ids", "core.object_ref", "core.runtime", "core.api",
                 "serve.deployment", "serve.controller", "serve.api", "serve.openai_api",
                 "serve.anatomy", "serve.admission", "serve.autoscale", "serve.kv_router",
                 "serve.batching", "serve.multiplex", "util.metrics", "util.flight_recorder",
                 "util.timeline", "core.pubsub", "experimental.pubsub", "serve.front_door",
                 "serve.grpc_ingress", "rllib", "rllib.np_policy", "rllib.connectors",
                 "rllib.replay_buffer", "rllib.env_runner", "rllib.optim", "rllib.learner",
                 "rllib.ppo", "rllib.learner_group", "rllib.impala", "rllib.appo",
                 "rllib.off_policy", "rllib.dqn", "rllib.sac", "rllib.sac_continuous",
                 "rllib.tqc", "parallel", "parallel.mesh", "parallel.sharding",
                 "parallel.collectives", "parallel.ring_attention", "parallel.launch",
                 "parallel.model_parallel", "parallel.dryrun", "rllib.multi_agent",
                 "rllib.dreamerv3", "tune", "tune.search", "tune.schedulers", "tune.tuner",
                 "air", "air.callbacks", "train.context", "train.config",
                 "train.checkpoint"):
        assert f"ray_tpu_torch.{name}" in modules
    script = textwrap.dedent(f"""
        import importlib, sys, threading
        before = threading.active_count()
        import ray_tpu_torch, ray_tpu_torch.core, ray_tpu_torch.serve
        started = threading.active_count() - before
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "ray_tpu", "optax", "gymnasium")
                     or m == "cloudpickle")
        print(bad, "threads started by the import:", started)
        sys.exit(1 if bad or started else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


IN_PROCESS_ONLY = ("multiprocessing", "subprocess", "mmap", "ctypes")


@pytest.mark.parametrize("package, banned", [
    ("core", IN_PROCESS_ONLY + ("socket",)),  # the runtime opens no socket either
    ("serve", IN_PROCESS_ONLY),
    ("util", IN_PROCESS_ONLY + ("socket",)),  # metrics and rings of this process only
    ("experimental", IN_PROCESS_ONLY + ("socket",)),  # pub/sub of this process
    # learners, runners and the replay buffer are thread actors of the runtime
    ("rllib", IN_PROCESS_ONLY + ("jax", "optax", "ray_tpu", "cloudpickle")),
    # Tune's trials are thread actors too, and its callbacks run in-process
    ("tune", IN_PROCESS_ONLY + ("jax", "optax", "ray_tpu", "cloudpickle")),
    ("air", IN_PROCESS_ONLY + ("jax", "optax", "ray_tpu", "cloudpickle")),
])
def test_runtime_and_serve_stay_in_one_process(package, banned):
    """No worker process, shared memory or native library: the runtime, the
    serve layer and the util layer it records into import none of the
    modules that make them, and never name /dev/shm."""
    files = sorted((REPO / "ray_tpu_torch" / package).glob("*.py"))
    assert files
    for path in files:
        source = path.read_text()
        assert "/dev/shm" not in source, path
        for node in ast.walk(ast.parse(source)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path.name, name)


PARALLEL_BANNED = ("jax", "ray_tpu", "optax", "cloudpickle", "multiprocessing", "mmap",
                   "ctypes")


def test_parallel_package_spawns_only_through_its_launcher():
    """The parallel layer starts processes only in ``parallel/launch.py``
    (one subprocess per rank, results through files), imports nothing of
    the JAX side, no shared-memory or native-library module, and never
    names /dev/shm."""
    files = sorted((REPO / "ray_tpu_torch" / "parallel").glob("*.py"))
    assert {p.name for p in files} >= {"mesh.py", "sharding.py", "collectives.py",
                                       "ring_attention.py", "launch.py", "model_parallel.py",
                                       "dryrun.py"}
    spawners = []
    for path in files:
        source = path.read_text()
        assert "/dev/shm" not in source, path
        for name, _ in _imports(ast.parse(source)):
            assert name.split(".")[0] not in PARALLEL_BANNED, (path.name, name)
            if name.split(".")[0] == "subprocess":
                spawners.append(path.name)
    assert spawners == ["launch.py"]


def _imports(tree) -> list:
    """(module name, node) of every import statement in ``tree``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name, node) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", node))
    return out


def test_only_the_grpc_ingress_names_grpc_and_only_when_used():
    """``grpc`` is imported by serve/grpc_ingress.py alone, inside the
    functions that use it: the card machine has no grpc."""
    namers = []
    for path in sorted((REPO / "ray_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(name.split(".")[0] == "grpc" for name, _ in _imports(tree)):
            namers.append(path.relative_to(REPO).as_posix())
        top_level = [name for stmt in tree.body for name, _ in _imports(ast.Module([stmt], []))
                     if not isinstance(stmt, (ast.FunctionDef, ast.ClassDef))]
        assert "grpc" not in [n.split(".")[0] for n in top_level], path
    assert namers == ["ray_tpu_torch/serve/grpc_ingress.py"]


def test_rllib_names_gymnasium_only_inside_a_function():
    """``gymnasium`` is imported only where a named env is made
    (``rllib/ppo.py make_env_creator``), never at a module's top level: the
    card machine has no gymnasium, and a callable env needs none."""
    namers = []
    for path in sorted((REPO / "ray_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        if any(name.split(".")[0] == "gymnasium" for name, _ in _imports(tree)):
            namers.append(path.relative_to(REPO).as_posix())
        top_level = [name for stmt in tree.body for name, _ in _imports(ast.Module([stmt], []))
                     if not isinstance(stmt, (ast.FunctionDef, ast.ClassDef))]
        assert "gymnasium" not in [n.split(".")[0] for n in top_level], path
    assert namers == ["ray_tpu_torch/rllib/ppo.py"]


def test_serve_imports_without_grpc():
    script = textwrap.dedent("""
        import sys
        sys.modules["grpc"] = None  # any import of grpc now raises
        import ray_tpu_torch.serve
        from ray_tpu_torch.serve import grpc_ingress, start_front_door, start_grpc_proxy
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_engine_without_device_raises_when_no_card(monkeypatch):
    from ray_tpu_torch.models import llama, moe, vit
    from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
    from ray_tpu_torch.serve.llm_paged import PagedLLMEngine
    from ray_tpu_torch.serve.spec_decode import SpecDecodeConfig, SpecDecodeLLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(LLMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpecDecodeLLMEngine(SpecDecodeConfig(draft_model_config=llama.LlamaConfig.tiny()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.init(moe.MoEConfig.tiny(), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit.init(vit.ViTConfig.tiny(), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ray_tpu_torch.resolve_device()
