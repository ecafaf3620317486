"""Port parity of the training path: ray_tpu_torch.models.llama forward /
loss_fn and ray_tpu_torch.train.spmd against ray_tpu.models.llama and
ray_tpu.train.spmd, on the tiny config in float32 with the JAX init's
weights converted by ``from_jax``. Inputs are made with numpy from a seed.

Tolerances (float32 on both sides, sums in another order): logits atol
2e-4, as tests/test_torch_llama.py holds the serving path; loss and grad
norm rtol 1e-5; gradients atol 1e-5; the lr schedule rtol 1e-5 (optax
evaluates it in float32, where the warmup's (0 - lr) * (1 - c / W) + lr
cancels to a few float32 ulps of lr); parameters after each train step atol 1e-5
(AdamW moves each element by at most about lr = 1e-3 per step, and the
gradients agree to ~1e-6 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.train import spmd as js
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.flash_attention import flash_attention as torch_flash
from ray_tpu_torch.train import spmd as ts

B, S = 2, 64


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny()
    tcfg = tl.LlamaConfig.tiny()
    jparams = jl.init(jcfg, jax.random.PRNGKey(0))
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], np.full((B, 1), -100, np.int32)], axis=1)
    if ignore:  # a scatter of ignored targets besides the last column
        targets[rng.random((B, S)) < 0.1] = -100
    return tokens, targets


def _flat_torch(tree):
    return {f"layers.{k}": v for k, v in tree["layers"].items()} | {
        k: v for k, v in tree.items() if k != "layers"}


def _flat_jax(tree):
    return {f"layers.{k}": np.asarray(v) for k, v in tree["layers"].items()} | {
        k: np.asarray(v) for k, v in tree.items() if k != "layers"}


def test_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    tokens, _ = _batch()
    want = jl.forward(jparams, jnp.asarray(tokens), jcfg)
    got = tl.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_tied_head_forward_and_loss_match_jax():
    """The gpt2_124m-style tied head: logits through embed^T, no lm_head."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), tie_embeddings=True)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), tie_embeddings=True)
    jparams = jl.init(jcfg, jax.random.PRNGKey(1))
    tparams = tl.from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert "lm_head" not in tparams
    assert tl.param_count(tparams) == jl.param_count(jparams)
    tokens, targets = _batch(6)
    want = jl.forward(jparams, jnp.asarray(tokens), jcfg)
    got = tl.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    want = jl.loss_fn(jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    got = tl.loss_fn(tparams, torch.from_numpy(tokens), torch.from_numpy(targets), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_forward_with_flash_attn_fn_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    tokens, _ = _batch(1)
    want = jl.forward(jparams, jnp.asarray(tokens), jcfg,
                      attn_fn=lambda q, k, v: jax_flash(q, k, v, block_q=32, block_k=32))
    got = tl.forward(tparams, torch.from_numpy(tokens), tcfg, attn_fn=torch_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_loss_with_ignored_targets_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    tokens, targets = _batch(2)
    assert (targets == -100).sum() > B
    want = jl.loss_fn(jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    got = tl.loss_fn(tparams, torch.from_numpy(tokens), torch.from_numpy(targets), tcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # every target ignored: the mean is over max(count, 1), so the loss is 0
    none = torch.full((B, S), -100)
    assert tl.loss_fn(tparams, torch.from_numpy(tokens), none, tcfg).item() == 0.0


def test_forward_is_causal(models):
    _, _, tcfg, tparams = models
    tokens, _ = _batch(3)
    base = tl.forward(tparams, torch.from_numpy(tokens), tcfg)
    t = 40
    changed = tokens.copy()
    changed[:, t] = (changed[:, t] + 1) % tcfg.vocab_size
    out = tl.forward(tparams, torch.from_numpy(changed), tcfg)
    torch.testing.assert_close(out[:, :t], base[:, :t], atol=1e-6, rtol=0.0)
    assert (out[:, t] - base[:, t]).abs().max() > 1e-3


def _loss_and_grads(params, cfg, tokens, targets):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in _flat_torch(params).items()}
    tree = {k: v for k, v in leaves.items() if not k.startswith("layers.")}
    tree["layers"] = {k[len("layers."):]: v for k, v in leaves.items() if k.startswith("layers.")}
    loss = tl.loss_fn(tree, torch.from_numpy(tokens), torch.from_numpy(targets), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_remat_policies_give_the_same_loss_and_grads(models):
    _, _, tcfg, tparams = models
    tokens, targets = _batch(4)
    base_loss, base_grads = _loss_and_grads(tparams, tcfg, tokens, targets)
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
        loss, grads = _loss_and_grads(tparams, cfg, tokens, targets)
        torch.testing.assert_close(loss, base_loss)
        for name, g in grads.items():
            torch.testing.assert_close(g, base_grads[name], msg=f"{policy}: {name}")
    with pytest.raises(ValueError, match="remat_policy"):
        tl.forward(tparams, torch.from_numpy(tokens),
                   dataclasses.replace(tcfg, remat=True, remat_policy="none"))


def test_grads_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    tokens, targets = _batch(5)
    want = jax.grad(jl.loss_fn)(jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    _, got = _loss_and_grads(tparams, tcfg, tokens, targets)
    want = _flat_jax(want)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5, err_msg=name)


@pytest.mark.parametrize("preset", ["tiny", "gpt2_124m", "llama_1b", "llama_8b"])
def test_flops_and_param_counts_match_jax(preset):
    tcfg, jcfg = getattr(tl.LlamaConfig, preset)(), getattr(jl.LlamaConfig, preset)()
    assert tl.flops_per_token(tcfg) == jl.flops_per_token(jcfg)
    assert tl.param_count_analytic(tcfg) == jl.param_count_analytic(jcfg)


@pytest.mark.parametrize("count", [0, 1, 100, 5000, 10000, 12000])
def test_lr_schedule_matches_optax(count):
    lr, warmup = 3e-4, 100
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, 10000, 0.1 * lr)(count)
    got = ts.make_optimizer(lr, warmup=warmup).schedule(count)
    np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=0.0)
    if count == 0:
        assert got == 0.0


def test_train_steps_match_jax(models):
    jcfg, jparams, tcfg, _ = models
    lr, warmup = 1e-3, 1
    jstate = js.init_state(jcfg, jax.random.PRNGKey(7), js.make_optimizer(lr, warmup=warmup))
    params_np = jax.tree.map(np.asarray, jstate.params)  # before the donating step
    mesh = make_mesh(1, devices=jax.devices("cpu")[:1])
    jstep = js.make_train_step(jcfg, mesh, optimizer=js.make_optimizer(lr, warmup=warmup))(jstate)

    opt = ts.make_optimizer(lr, warmup=warmup)
    tparams = tl.from_jax(params_np, tcfg, device="cpu")
    tstate = ts.TrainState(tparams, opt.init(tparams), 0)
    tstep = ts.make_train_step(tcfg, opt, device="cpu")
    for i in range(3):
        tokens, targets = _batch(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tm = tstep(tstate, tokens, targets)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert tm["step"] == int(jm["step"]) == tstate.step == i + 1
        want = _flat_jax(jstate.params)
        for name, p in _flat_torch(tstate.params).items():
            np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-5,
                                       err_msg=f"step {i + 1}: {name}")
    # the clip was active (grad norm above 1) and the parameters moved
    assert float(jm["grad_norm"]) > 1.0
    assert not np.allclose(_flat_jax(jstate.params)["layers.wq"], params_np["layers"]["wq"])


def test_init_state_and_step_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.init_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.make_train_step(cfg)
