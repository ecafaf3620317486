"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``ray_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own by ``nvcc`` for ``sm_90a`` into
``build/ray_tpu_torch/<name>-<hash>.so`` at the repository root, where the
hash covers the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. No PyTorch header is included: that keeps a
build to seconds instead of minutes.

``build_all()`` starts one ``nvcc`` per source, all at once, waits for them
and reports each library's build seconds and nvcc's ``-Xptxas -v`` output
(kept beside the library, so a cached one reports its original build);
``load(name)`` builds what is missing and returns the ``ctypes.CDLL``. A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: list[str] | None = None) -> dict[str, dict]:
    """Compile every missing library in parallel (one nvcc per source).
    Returns {name: {"seconds", "ptxas", "cached"}} for every name."""
    names = sources() if names is None else names
    todo = [n for n in names if not _target(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.monotonic()
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failures = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for csrc/{n}.cu (rc {proc.returncode}):\n{log}")
                continue
            report = {"seconds": time.monotonic() - t0, "ptxas": log}
            _target(n).with_suffix(".json").write_text(json.dumps(report))
            os.replace(tmp, _target(n))
        if failures:
            raise RuntimeError("\n".join(failures))
    return {n: {**json.loads(_target(n).with_suffix(".json").read_text()),
                "cached": n not in todo} for n in names}


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
