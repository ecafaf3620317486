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
                 "serve.deployment", "serve.controller", "serve.api", "serve.openai_api"):
        assert f"ray_tpu_torch.{name}" in modules
    script = textwrap.dedent(f"""
        import importlib, sys, threading
        before = threading.active_count()
        import ray_tpu_torch, ray_tpu_torch.core, ray_tpu_torch.serve
        started = threading.active_count() - before
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "ray_tpu" or m.startswith("ray_tpu."))
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
])
def test_runtime_and_serve_stay_in_one_process(package, banned):
    """No worker process, shared memory or native library: the runtime and
    the serve layer import none of the modules that make them, and never name
    /dev/shm."""
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
