"""How far training through the flash kernels is from dense attention and
from float32, on one NVIDIA GPU, at head dims 256 and 64.

    python3 scripts/torch_attention_agreement.py

For Llama-3.2-1B's widths cut to 4 of its 16 layers, once as 8 query and 2
kv heads of 256 and once as its own 32 and 8 heads of 64 (the same q, k and
v widths), with random weights from seed 0: 5 train steps on one [2, 2048]
batch (chip_smoke's D 256 train path), and at the initial parameters and
after the steps the loss and the wq, wk and wv gradients through the flash
kernels, dense attention, plain float32 attention (``chip_smoke``'s
``plain_f32_attention``) and a float32 copy of the whole model. Prints one
JSON line per head dim and point: the losses and the relative gaps between
them (``chip_smoke.attention_gaps``). chip_smoke.py holds the D 256 path's
loss to the float32 copy (``D256_LOSS_RULE``) on what this shows.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ray_tpu_torch.models import llama  # noqa: E402
from ray_tpu_torch.train import spmd  # noqa: E402

LAYERS, BATCH, STEPS = 4, 2, 5
HEADS = ((256, 8, 2), (64, 32, 8))  # head dim, query heads, kv heads
PAIRS = (("flash", "dense"), ("flash", "f32"), ("dense", "f32"), ("flash", "f32 model"),
         ("dense", "f32 model"))


def readings(cfg, params, batch) -> tuple[dict, dict]:
    got = {name: cs.loss_and_qkv_grads(cfg, params, batch, fn)
           for name, fn in (("flash", None), ("dense", llama.attention),
                            ("f32", cs.plain_f32_attention))}
    p32 = cs.tree_map(lambda t: t.detach().float(), params)
    got["f32 model"] = cs.loss_and_qkv_grads(dataclasses.replace(cfg, dtype=torch.float32),
                                             p32, batch, cs.plain_f32_attention)
    return ({k: v[0] for k, v in got.items()},
            {f"{a} vs {b}": cs.attention_gaps(got[a], got[b]) for a, b in PAIRS})


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_attention_agreement: no CUDA device", file=sys.stderr)
        return 1
    _, card = cs.device_phase()
    rng = np.random.default_rng(cs.SEED + 4)
    tokens = rng.integers(0, llama.LlamaConfig.llama_1b().vocab_size, (BATCH, cs.TRAIN_SEQ))
    targets = np.concatenate([tokens[:, 1:], np.full((BATCH, 1), -100)], axis=1)
    batch = (torch.from_numpy(tokens).to(cs.DEVICE), torch.from_numpy(targets).to(cs.DEVICE))
    for hd, nh, nkv in HEADS:
        cfg = dataclasses.replace(llama.LlamaConfig.llama_1b(), num_heads=nh, num_kv_heads=nkv,
                                  head_dim=hd, num_layers=LAYERS)
        opt = spmd.make_optimizer(warmup=1)
        state = spmd.init_state(cfg, torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED),
                                opt, device=cs.DEVICE)
        initial = cs.tree_map(lambda t: t.detach().clone(), state.params)
        step = spmd.make_train_step(cfg, opt, device=cs.DEVICE)
        for _ in range(STEPS):
            state, _ = step(state, *batch)
        for point, params in (("initial", initial), (f"after {STEPS} steps", state.params)):
            losses, gaps = readings(cfg, params, batch)
            cs.log(card, "training through flash vs dense and float32", head_dim=hd,
                   heads=[nh, nkv], layers=LAYERS, point=point, losses=losses, gaps=gaps)
        del state, step, initial
        torch.cuda.empty_cache()
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
