"""A plain rank launcher: one ``subprocess`` per rank, results through files.

The counterpart of how ray_tpu/train/torch_backend.py spawns its DDP ranks,
without a runtime and without pickling the function: the rank function is
named as ``"module:function"`` and called as ``fn(rank, world_size, args)``
in each rank process, where ``args`` is the JSON value given to ``launch``.

- Each rank runs ``python -m ray_tpu_torch.parallel.launch RUN_DIR RANK`` in
  a session of its own (``start_new_session``), with ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``OMP_NUM_THREADS=1``
  and ``GLOO_SOCKET_IFNAME=lo`` (gloo over loopback) in its environment,
  and calls ``torch.set_num_threads(1)`` before the function.
- The rendezvous is a ``FileStore`` at ``RUN_DIR/store``
  (``$RAY_TPU_TORCH_STORE``, which ``mesh.initialize_distributed`` reads):
  no fixed port, no port to race for.
- The function returns a dict. Its arrays (numpy or torch) come back
  through ``RUN_DIR/rank<r>.npz``, everything else through
  ``RUN_DIR/rank<r>.json``; ``launch`` returns one merged dict per rank,
  with the rank's ``pid`` added.
  Standard output and error go to ``rank<r>.out`` / ``rank<r>.err``. Nothing
  goes through shared memory.
- ``deadline_s`` bounds the whole launch. When it passes, or ``GRACE_S``
  after a rank fails (its peers may wait on it in a collective forever),
  every rank's process group gets SIGKILL, every rank is reaped, and
  ``LaunchError`` is raised naming the ranks and with the last lines of
  every rank's standard error.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
TAIL_LINES = 15
GRACE_S = 5.0  # how long the other ranks may run on after one fails


class LaunchError(RuntimeError):
    """A launch that did not end with every rank exiting 0. ``pids`` are the
    rank processes, all reaped by the time this is raised."""

    def __init__(self, message: str, pids: list[int]):
        super().__init__(message)
        self.pids = pids


def _tail(path: Path, n: int = TAIL_LINES) -> str:
    try:
        lines = path.read_text(errors="replace").splitlines()
    except FileNotFoundError:
        return "(no output)"
    return "\n".join(lines[-n:])


def _kill(procs) -> None:
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)  # the rank and anything it started
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        p.wait()


def launch(target: str, world_size: int, run_dir, *, args=None, deadline_s: float = 300.0,
           pythonpath=()) -> list[dict]:
    """Run ``target`` (``"module:function"``) on ``world_size`` rank
    processes and return each rank's result dict, in rank order."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "launch.json").write_text(json.dumps(
        {"target": target, "world_size": world_size, "args": args}))
    paths = [str(REPO_ROOT), *map(str, pythonpath)]
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    procs = []
    try:
        for rank in range(world_size):
            rank_env = dict(os.environ)
            rank_env.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                            LOCAL_WORLD_SIZE=str(world_size), OMP_NUM_THREADS="1",
                            GLOO_SOCKET_IFNAME="lo", PYTHONPATH=os.pathsep.join(paths),
                            RAY_TPU_TORCH_STORE=str(run_dir / "store"))
            with open(run_dir / f"rank{rank}.out", "wb") as out, \
                    open(run_dir / f"rank{rank}.err", "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch.parallel.launch", str(run_dir),
                     str(rank)], env=rank_env, stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                    start_new_session=True, cwd=run_dir))
        deadline = time.monotonic() + deadline_s
        failed_at = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            now = time.monotonic()
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad and failed_at is None:
                failed_at = now
            if bad and (all(c is not None for c in codes) or now - failed_at > GRACE_S):
                why = f"rank(s) {bad} exited with {[codes[r] for r in bad]}"
            elif now > deadline:
                late = [r for r, c in enumerate(codes) if c is None]
                why = f"deadline of {deadline_s} s passed with rank(s) {late} still running"
            else:
                time.sleep(0.05)
                continue
            _kill(procs)
            tails = "\n".join(f"--- rank {r} stderr ---\n{_tail(run_dir / f'rank{r}.err')}"
                              for r in range(world_size))
            raise LaunchError(f"launch of {target} on {world_size} ranks: {why}\n{tails}",
                              [p.pid for p in procs])
    finally:
        _kill([p for p in procs if p.poll() is None])
    return [_read_result(run_dir, r) for r in range(world_size)]


def _read_result(run_dir: Path, rank: int) -> dict:
    out = json.loads((run_dir / f"rank{rank}.json").read_text())
    npz = run_dir / f"rank{rank}.npz"
    if npz.exists():
        with np.load(npz) as arrays:
            out.update({k: arrays[k] for k in arrays.files})
    return out


def _write_result(run_dir: Path, rank: int, result: dict) -> None:
    import torch

    arrays, plain = {}, {}
    for k, v in result.items():
        if isinstance(v, torch.Tensor):
            arrays[k] = v.detach().cpu().numpy()
        elif isinstance(v, np.ndarray):
            arrays[k] = v
        else:
            plain[k] = v
    if arrays:
        np.savez(run_dir / f"rank{rank}.tmp.npz", **arrays)
        os.replace(run_dir / f"rank{rank}.tmp.npz", run_dir / f"rank{rank}.npz")
    (run_dir / f"rank{rank}.tmp.json").write_text(json.dumps(plain))
    os.replace(run_dir / f"rank{rank}.tmp.json", run_dir / f"rank{rank}.json")


def _rank_main(run_dir: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    run_dir = Path(run_dir)
    spec = json.loads((run_dir / "launch.json").read_text())
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    result = dict(fn(rank, spec["world_size"], spec["args"]) or {}, pid=os.getpid())
    _write_result(run_dir, rank, result)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
