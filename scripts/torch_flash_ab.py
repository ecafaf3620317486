"""A/B of the port's attention kernels on one NVIDIA GPU: this checkout's
``ray_tpu_torch/csrc/flash_attention.cu`` (or, with ``--paged``, its
``paged_attention.cu``) against other sources of the same file (for example
a parent commit's, or edited copies for a tile sweep), in one process on one
card.

    git show <commit>:ray_tpu_torch/csrc/flash_attention.cu > build/flash_parent.cu
    python3 scripts/torch_flash_ab.py build/flash_parent.cu [--loss] [--steps]
    git show <commit>:ray_tpu_torch/csrc/paged_attention.cu > build/paged_parent.cu
    python3 scripts/torch_flash_ab.py --paged build/paged_parent.cu [more sources]

Each other source is built by nvcc with the port's flags into a library
beside it and swapped in for this checkout's behind the same wrappers. A
source whose launchers predate their trailing head-dim argument (the head
dim the scale is taken from) is called without it: the calls here are at
head dims 64 and 128, where that argument equals D. Prints JSON lines:

- each source's flash kernels: registers and spill bytes from ptxas;
- the bf16 forward at the trainer's shapes (B 4, S 2048, Hq 32, Hkv 8,
  D 64; causal and not) for each source in turns (A, B, ..., B, A), CUDA
  events with the L2 flushed before each launch, beside SDPA;
- the bf16 backward kernels, dQ and dK/dV, causal, in the same turns at the
  trainer's shapes and at D 128 (B 1, S 2048, Hq 8, Hkv 2), fed one lse and
  delta from this checkout's forward, beside SDPA's backward (dq, dk and dv
  in one call);
- with ``--loss``: Llama-3.2-1B (bf16, remat "full", random weights from
  seed 0) on chip_smoke's batch, at its initial parameters and after 5
  train steps taken through each source's kernels: the loss and the wq, wk
  and wv gradients through each source's kernels, dense attention and the
  plain float32 attention (``chip_smoke.plain_f32_attention``), and their
  relative gaps (chip_smoke's ``attention_gaps``);
- with ``--steps``: the Llama-3.2-1B train step on chip_smoke's batch
  through each source in turns (A, B, ..., B, A), 6 steps a turn from one
  shared state, host clock around each synchronised step; the median of
  each source's steps, the first step of every turn left out.
- with ``--paged``: each paged source's kernels (registers and spill
  bytes), its output against the plain version, and the bf16 decode call
  at Llama-3-8B's serving shapes (B 8, Hq 32, Hkv 8, D 128, pages of 16
  tokens, a 128-page table) at chip_smoke's main-path lengths and at its
  ``KERNEL_LENGTHS``, and with every row empty (what a call costs with no
  key to read), in turns (A, B, ..., B, A), L2 flushed before each launch,
  beside SDPA over pre-gathered KV and the byte bound. A source
  from before split-K (no workspace, no split count) is called without
  those two arguments, as one split.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.ops import paged_attention as pa  # noqa: E402
from ray_tpu_torch.train import spmd  # noqa: E402

TRAINER_SHAPE = (4, 2048, 32, 8, 64)  # B, S, Hq, Hkv, D
D128_SHAPE = (1, 2048, 8, 2, 128)


class _WithoutScaleDim:
    """A launcher of a source from before the trailing head-dim argument,
    called with this checkout's arguments less that int."""

    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        if self.fn.argtypes is None:
            self.fn.restype = self.restype
            self.fn.argtypes = self.argtypes[:-2] + self.argtypes[-1:]
        return self.fn(*args[:-2], args[-1])


class _OldLauncherLib:
    def __init__(self, lib: ctypes.CDLL):
        self.lib, self.launchers = lib, {}

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            return getattr(self.lib, name)
        return self.launchers.setdefault(name, _WithoutScaleDim(getattr(self.lib, name)))


class _WithoutSplits:
    """The paged launcher of a source from before split-K, called with this
    checkout's arguments less the workspace pointer and the split count."""

    def __init__(self, fn):
        self.fn, self.argtypes, self.restype = fn, None, None

    def __call__(self, *args):
        if self.fn.argtypes is None:
            self.fn.restype = self.restype
            self.fn.argtypes = self.argtypes[:6] + self.argtypes[7:12] + self.argtypes[13:]
        return self.fn(*args[:6], *args[7:12], *args[13:])


class _OneSplit:
    """paged_decode_split_pages for such a source: the whole table is one split."""

    argtypes = restype = None

    def __call__(self, block_size, head_dim, dtype):
        return 1 << 30


class _OldPagedLib:
    def __init__(self, lib: ctypes.CDLL):
        self.paged_decode_attention_launch = _WithoutSplits(lib.paged_decode_attention_launch)
        self.paged_decode_split_pages = _OneSplit()


def build(card: str, sources: list[str], name: str = "flash_attention") -> dict:
    """This checkout's library and one built from each other source, keyed by
    source; each source's registers and spills are logged."""
    report = _build.build_all([name])[name]
    libs = {"this checkout": _build.load(name)}
    ptxas = {"this checkout": report["ptxas"]}
    outs = {src: str(Path(src).resolve().with_suffix(".so")) for src in sources}  # paths
    procs = {src: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, out in outs.items()}  # one nvcc per source, all at once
    for src, proc in procs.items():
        ptxas[src] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{ptxas[src]}")
        lib, text = ctypes.CDLL(outs[src]), Path(src).read_bytes()
        if name == "paged_attention":
            libs[src] = lib if b"paged_decode_split_pages" in text else _OldPagedLib(lib)
        else:
            libs[src] = lib if b"scale_dim" in text else _OldLauncherLib(lib)
    for src, log in ptxas.items():
        cs.log(card, f"ptxas of {src}: registers and spill bytes",
               kernels={k: (v.get("registers"), v.get("spill_stores"))
                        for k, v in cs.ptxas_kernels(log).items()
                        if ("bf16" in k if name == "flash_attention" else "128" in k)})
    return libs


def use(lib: ctypes.CDLL) -> None:
    _build._libs["flash_attention"] = lib


def time_forward(card: str, libs: dict) -> None:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cs.DEVICE)
    q, k, v, _ = cs.flash_inputs(torch.bfloat16, *TRAINER_SHAPE, seed=cs.SEED)
    times: dict[str, list[float]] = {}
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for causal in (True, False):
            times.setdefault(f"{name}, causal={causal}", []).append(
                cs.time_ms(lambda: fa.flash_fwd(q, k, v, causal), flush))
    use(libs["this checkout"])
    with torch.no_grad():
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = cs.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    cs.log(card, "flash_fwd A/B (bf16, trainer shapes; ms per call, in turns)",
           shape=dict(zip("B S Hq Hkv D".split(), TRAINER_SHAPE)), kernel_ms=times,
           sdpa_causal_ms=sdpa)


def time_backward(card: str, libs: dict) -> None:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cs.DEVICE)
    for shape in (TRAINER_SHAPE, D128_SHAPE):
        q, k, v, do = cs.flash_inputs(torch.bfloat16, *shape, seed=cs.SEED)
        use(libs["this checkout"])
        o, lse = fa.flash_fwd(q, k, v, True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        times: dict[str, list[float]] = {}
        for name in list(libs) + list(libs)[::-1]:
            use(libs[name])
            times.setdefault(f"{name}, dq", []).append(
                cs.time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True), flush))
            times.setdefault(f"{name}, dkv", []).append(
                cs.time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True), flush))
        use(libs["this checkout"])
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        sdpa = cs.time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                      retain_graph=True), flush)
        cs.log(card, "flash backward A/B (bf16, causal; ms per call, in turns)",
               shape=dict(zip("B S Hq Hkv D".split(), shape)), kernel_ms=times,
               sdpa_backward_ms=sdpa)
        del q, k, v, do, o, lse, delta, qt, kt, vt, out, dot


def time_paged(card: str, libs: dict) -> None:
    cfg = llama.LlamaConfig.llama_8b()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=cs.DEVICE)
    main_lengths = [len(p) + cs.NEW_TOKENS // 2 for p in cs.prompts(cfg)]
    for label, lengths in (("main path", main_lengths), ("ragged, full table", cs.KERNEL_LENGTHS),
                           ("every row empty: the launch floor", [0] * len(main_lengths))):
        args = cs.paged_inputs(torch.bfloat16, cfg, lengths, cs.SEED)
        ref = pa.paged_decode_attention_ref(*args)
        errs = {}
        for name, lib in libs.items():
            _build._libs["paged_attention"] = lib
            got = pa.paged_decode_attention(*args)
            torch.cuda.synchronize()
            errs[name] = (got.float() - ref.float()).abs().max().item()
            torch.testing.assert_close(got, ref, **cs.TOL[torch.bfloat16])
        times: dict[str, list[float]] = {}
        for name in list(libs) + list(libs)[::-1]:
            _build._libs["paged_attention"] = libs[name]
            times.setdefault(name, []).append(
                cs.time_ms(lambda: pa.paged_decode_attention(*args), flush))
        _build._libs["paged_attention"] = libs["this checkout"]
        bound_ms, bound_by = cs.paged_bound(args)
        cs.log(card, f"paged decode A/B (bf16, {label}; ms per call, in turns)",
               lengths=lengths, kernel_ms=times, max_abs_err=errs,
               sdpa_ms=cs.time_ms(cs.sdpa_call(args), flush), bound_ms=bound_ms,
               bound_by=bound_by)
        del args, ref


def loss_gaps(card: str, libs: dict) -> None:
    cfg = llama.LlamaConfig.llama_1b()
    batch = cs.train_batch(cfg)

    def gaps(params) -> dict:
        fns = {name: None for name in libs}  # None: the kernels, through auto_attention
        fns.update({"dense": llama.attention, "plain float32": cs.plain_f32_attention})
        got = {}
        for name, fn in fns.items():
            use(libs.get(name, libs["this checkout"]))
            got[name] = cs.loss_and_qkv_grads(cfg, params, batch, fn)
        use(libs["this checkout"])
        out = {f"{a} vs {b}": cs.attention_gaps(got[a], got[b])
               for a in libs for b in ("dense", "plain float32")}
        out["dense vs plain float32"] = cs.attention_gaps(got["dense"], got["plain float32"])
        return {"loss": {n: g[0] for n, g in got.items()}, "rel_gap": out}

    for i, name in enumerate(libs):
        opt = spmd.make_optimizer(warmup=1)
        state = spmd.init_state(cfg, torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED),
                                opt, device=cs.DEVICE)
        if i == 0:
            cs.log(card, "loss and gradient gaps at the initial parameters",
                   **gaps(state.params))
        step = spmd.make_train_step(cfg, opt, device=cs.DEVICE)
        use(libs[name])
        train = []
        for _ in range(5):
            state, m = step(state, *batch)
            train.append(m["loss"].item())
        cs.log(card, f"loss and gradient gaps after 5 steps through {name}",
               train_losses=train, **gaps(state.params))
        del state, step, opt
        torch.cuda.empty_cache()


def step_times(card: str, libs: dict, steps: int = 6) -> None:
    cfg = llama.LlamaConfig.llama_1b()
    batch = cs.train_batch(cfg)
    opt = spmd.make_optimizer(warmup=1)
    state = spmd.init_state(cfg, torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED), opt,
                            device=cs.DEVICE)
    step = spmd.make_train_step(cfg, opt, device=cs.DEVICE)
    times: dict[str, list[float]] = {}
    for name in list(libs) + list(libs)[::-1]:
        use(libs[name])
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, _ = step(state, *batch)
            torch.cuda.synchronize()
            if i:
                times.setdefault(name, []).append(1e3 * (time.monotonic() - t0))
    use(libs["this checkout"])
    cs.log(card, "train step A/B (Llama-3.2-1B, B 4 x S 2048; ms, in turns)",
           median_ms={n: statistics.median(t) for n, t in times.items()}, step_ms=times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", help="other flash_attention.cu sources")
    ap.add_argument("--loss", action="store_true", help="also the training-loss gaps")
    ap.add_argument("--steps", action="store_true", help="also the train step's time")
    ap.add_argument("--paged", nargs="+", metavar="SRC", default=[],
                    help="time paged_attention.cu against these sources (flash only if "
                         "flash sources are given too)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _, card = cs.device_phase()
    if args.paged:
        time_paged(card, build(card, args.paged, "paged_attention"))
        if not (args.sources or args.loss or args.steps):
            return 0
    libs = build(card, args.sources)
    time_forward(card, libs)
    time_backward(card, libs)
    if args.loss:
        loss_gaps(card, libs)
    if args.steps:
        step_times(card, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
