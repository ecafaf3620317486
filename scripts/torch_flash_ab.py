"""A/B of the port's flash-attention kernels on one NVIDIA GPU: this
checkout's ``ray_tpu_torch/csrc/flash_attention.cu`` against other sources
of the same file (for example a parent commit's), in one process on one card.

    git show <commit>:ray_tpu_torch/csrc/flash_attention.cu > build/flash_parent.cu
    python3 scripts/torch_flash_ab.py build/flash_parent.cu [--loss]

Each other source is built by nvcc with the port's flags into a library
beside it and swapped in for this checkout's behind the same wrappers (the
C interface is the same). Prints JSON lines:

- the bf16 forward at the trainer's shapes (B 4, S 2048, Hq 32, Hkv 8,
  D 64; causal and not) for each source in turns (A, B, ..., B, A), CUDA
  events with the L2 flushed before each launch, beside SDPA;
- the bf16 backward kernels, dQ and dK/dV, causal, in the same turns at the
  trainer's shapes and at D 128 (B 1, S 2048, Hq 8, Hkv 2), fed one lse and
  delta from this checkout's forward, beside SDPA's backward (dq, dk and dv
  in one call);
- with ``--loss``: Llama-3.2-1B (bf16, remat "full", random weights from
  seed 0) on chip_smoke's batch, at its initial parameters and after 5
  train steps taken through each source's kernels: the loss through each
  source's kernels, dense attention and the plain float32 attention
  (``flash_fwd_ref``), and their relative gaps.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.ops import _build  # noqa: E402
from ray_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_tpu_torch.train import spmd  # noqa: E402

TRAINER_SHAPE = (4, 2048, 32, 8, 64)  # B, S, Hq, Hkv, D
D128_SHAPE = (1, 2048, 8, 2, 128)


def build(sources: list[str]) -> dict[str, ctypes.CDLL]:
    libs = {"this checkout": _build.load("flash_attention")}
    for src in sources:
        out = str(Path(src).with_suffix(".so"))
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src], check=True,
                       capture_output=True, text=True)
        libs[src] = ctypes.CDLL(out)
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


def loss_gaps(card: str, libs: dict) -> None:
    cfg = llama.LlamaConfig.llama_1b()
    batch = cs.train_batch(cfg)

    def plain(q, k, v, causal=True):
        return fa.flash_fwd_ref(q, k, v, causal)[0]

    def losses(params) -> dict:
        got = {}
        with torch.no_grad():
            for name, lib in libs.items():
                use(lib)
                got[name] = llama.loss_fn(params, *batch, cfg).item()
            got["dense"] = llama.loss_fn(params, *batch, cfg, llama.attention).item()
            got["plain float32"] = llama.loss_fn(params, *batch, cfg, plain).item()
        use(libs["this checkout"])
        gaps = {f"{a} vs {b}": abs(got[a] - got[b]) / abs(got[b])
                for a in libs for b in ("dense", "plain float32")}
        gaps["dense vs plain float32"] = (abs(got["dense"] - got["plain float32"])
                                          / abs(got["plain float32"]))
        return {"loss": got, "rel_gap": gaps}

    for i, name in enumerate(libs):
        opt = spmd.make_optimizer(warmup=1)
        state = spmd.init_state(cfg, torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED),
                                opt, device=cs.DEVICE)
        if i == 0:
            cs.log(card, "loss gaps at the initial parameters", **losses(state.params))
        step = spmd.make_train_step(cfg, opt, device=cs.DEVICE)
        use(libs[name])
        train = []
        for _ in range(5):
            state, m = step(state, *batch)
            train.append(m["loss"].item())
        cs.log(card, f"loss gaps after 5 steps through {name}", train_losses=train,
               **losses(state.params))
        del state, step, opt
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", help="other flash_attention.cu sources")
    ap.add_argument("--loss", action="store_true", help="also the training-loss gaps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _, card = cs.device_phase()
    libs = build(args.sources)
    time_forward(card, libs)
    time_backward(card, libs)
    if args.loss:
        loss_gaps(card, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
