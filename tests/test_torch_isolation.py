"""The port stands alone: no module of ray_tpu_torch imports jax or any part
of ray_tpu, and its entry points refuse to fall back to the CPU silently."""

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
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "ray_tpu" or m.startswith("ray_tpu."))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_without_device_raises_when_no_card(monkeypatch):
    from ray_tpu_torch.serve.llm import LLMConfig, LLMEngine
    from ray_tpu_torch.serve.llm_paged import PagedLLMEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(LLMConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedLLMEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ray_tpu_torch.resolve_device()
