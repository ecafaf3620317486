"""Port parity of the MoE and ViT families and of attention(mask=):
ray_tpu_torch.models.{moe,vit,llama} against ray_tpu.models.{moe,vit,llama}
on the tiny configs in float32, with the JAX init's weights converted by
``from_jax``. Inputs are made with numpy from a seed.

Tolerances (float32 on both sides, sums in another order): logits atol
2e-4, as tests/test_torch_llama.py holds the Llama forward; the MoE aux
loss rtol 1e-5; loss rtol 1e-5 and gradients atol 1e-5, as
tests/test_torch_train.py holds the Llama train step; attention atol 1e-5
(one op). The routing is compared exactly where it is discrete: the
dispatch tensor and which entries of combine are nonzero; combine's values
(the router's float32 probabilities) to rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import moe as jmoe
from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import vit as tvit


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{"layers.name": leaf} | {name: leaf}, as numpy arrays."""
    def arr(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {f"layers.{k}": arr(v) for k, v in tree["layers"].items()} | {
        k: arr(v) for k, v in tree.items() if k != "layers"}


def _assert_grads_close(tgrads: dict, jgrads: dict):
    want = _flat(jgrads)
    assert set(tgrads) == set(want)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=1e-5, err_msg=name)


def _torch_value_and_grad(loss_fn, params, *args):
    leaves = {f"layers.{k}": v for k, v in params["layers"].items()} | {
        k: v for k, v in params.items() if k != "layers"}
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    return loss.item(), dict(zip(leaves, grads))


# ---------------------------------------------------------------- attention(mask=)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_key_mask_matches_jax(causal):
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 3, 12, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, D), np.float32) for h in (Hq, Hkv, Hkv))
    # ragged key padding: row 0 keeps 12 keys, row 1 keeps 7, row 2 keeps 1
    mask = np.arange(S)[None, :] < np.asarray([12, 7, 1])[:, None]
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        mask=jnp.asarray(mask))
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       causal=causal, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a masked key changes nothing: drop row 1's keys past 7 outright
    if not causal:
        short = tl.attention(*(torch.from_numpy(a[1:2, :7]) for a in (q, k, v)), causal=False)
        np.testing.assert_allclose(got[1:2, :7].numpy(), short.numpy(), atol=1e-5)


# ---------------------------------------------------------------- MoE
@pytest.fixture(scope="module")
def moe_models():
    jcfg = jmoe.MoEConfig.tiny()
    tcfg = tmoe.MoEConfig.tiny()
    jparams = jmoe.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, tmoe.from_jax(_np_tree(jparams), tcfg, "cpu")


def _tokens(seed, B=2, S=16, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def test_moe_init_layout_matches_jax_and_is_seeded(moe_models):
    _, jparams, tcfg, tparams = moe_models
    a = tmoe.init(tcfg, torch.Generator().manual_seed(3), "cpu")
    b = tmoe.init(tcfg, torch.Generator().manual_seed(3), "cpu")
    assert set(a["layers"]) == set(jparams["layers"]) == set(tparams["layers"])
    assert "w_gate" not in a["layers"]
    for name, leaf in jparams["layers"].items():
        assert tuple(a["layers"][name].shape) == leaf.shape, name
        assert a["layers"][name].dtype == tparams["layers"][name].dtype, name
        torch.testing.assert_close(a["layers"][name], b["layers"][name])


def test_moe_forward_matches_jax(moe_models):
    jcfg, jparams, tcfg, tparams = moe_models
    tokens, _ = _tokens(1)
    jlogits, jaux = jmoe.forward(jparams, jnp.asarray(tokens), jcfg)
    tlogits, taux = tmoe.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, 16, tcfg.base.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=2e-4)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


class _EinsumSpy:
    """Stands in for ``jax.numpy`` inside ray_tpu.models.moe and records each
    einsum's operands by its spec."""

    def __init__(self):
        self.operands = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands):
        self.operands[spec] = operands
        return jnp.einsum(spec, *operands)


def test_moe_routing_identical_where_capacity_drops(moe_models, monkeypatch):
    """At capacity factor 0.5 each expert takes int(0.5 * 2 * 32 / 4) = 8 of
    the 64 (token, choice) pairs, so pairs are dropped; the dispatch and
    combine tensors must be the JAX layer's, entry for entry."""
    jcfg, jparams, tcfg, tparams = moe_models
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 64), np.float32)
    layer = 1
    jl_w = [np.asarray(jparams["layers"][n][layer])
            for n in ("router", "e_gate", "e_up", "e_down")]
    spy = _EinsumSpy()
    monkeypatch.setattr(jmoe, "jnp", spy)
    jout, jaux = jmoe.moe_mlp(jnp.asarray(x), *map(jnp.asarray, jl_w), jcfg)
    monkeypatch.undo()
    jdispatch = np.asarray(spy.operands["tec,th->ech"][0])
    jcombine = np.asarray(spy.operands["tec,ech->th"][0])

    C = max(1, int(0.5 * 2 * 32 / 4))
    xt = torch.from_numpy(x.reshape(32, 64))
    dispatch, combine, aux = tmoe.route(xt, tparams["layers"]["router"][layer], tcfg, C)
    assert dispatch.shape == jdispatch.shape == (32, 4, C)
    assert 0 < dispatch.sum().item() < 32 * 2  # some pairs were dropped
    np.testing.assert_array_equal(dispatch.numpy(), jdispatch)
    # combine is dispatch times the router's float32 probabilities, which a
    # matmul summed in another order moves by an ulp or two
    np.testing.assert_array_equal(combine.numpy() != 0, jcombine != 0)
    np.testing.assert_allclose(combine.numpy(), jcombine, rtol=1e-6, atol=0)
    tout, taux = tmoe.moe_mlp(torch.from_numpy(x),
                              *(tparams["layers"][n][layer]
                                for n in ("router", "e_gate", "e_up", "e_down")), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)


def test_moe_routing_breaks_ties_to_the_lower_expert():
    """Equal router probabilities: the top-k order is that of jax.lax.top_k
    (descending, ties to the lower index)."""
    cfg = tmoe.MoEConfig.tiny()
    xt = torch.ones(3, 64)
    router = torch.zeros(64, 4)
    router[:, 3] = 1.0  # expert 3 first, then experts 0, 1, 2 tied
    dispatch, _, _ = tmoe.route(xt, router, cfg, 8)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray((xt @ router).numpy()), -1), 2)
    assert np.asarray(want).tolist() == [[3, 0]] * 3
    assert dispatch.sum(dim=2).tolist() == [[1.0, 0.0, 0.0, 1.0]] * 3


@pytest.fixture(scope="module")
def moe_loss_batch(moe_models):
    """A batch with ignored targets, and the JAX loss and gradients on it."""
    jcfg, jparams, _, _ = moe_models
    tokens, targets = _tokens(2)
    targets[0, :3] = -100
    jloss, jgrads = jax.jit(jax.value_and_grad(jmoe.loss_fn), static_argnums=3)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg)
    return tokens, targets, float(jloss), jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(moe_models, moe_loss_batch, remat):
    _, _, tcfg, tparams = moe_models
    tokens, targets, jloss, jgrads = moe_loss_batch
    tcfg = dataclasses.replace(tcfg, base=dataclasses.replace(tcfg.base, remat=remat))
    tloss, tgrads = _torch_value_and_grad(tmoe.loss_fn, tparams, torch.from_numpy(tokens),
                                          torch.from_numpy(targets), tcfg)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_grads_close(tgrads, jgrads)


# ---------------------------------------------------------------- ViT
@pytest.fixture(scope="module")
def vit_models():
    jcfg = jvit.ViTConfig.tiny()
    tcfg = tvit.ViTConfig.tiny()
    jparams = jvit.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, tcfg, tvit.from_jax(_np_tree(jparams), tcfg, "cpu")


def _images(seed, B=4):
    rng = np.random.default_rng(seed)
    return rng.random((B, 32, 32, 3), np.float32), rng.integers(0, 10, B).astype(np.int32)


def test_vit_patchify_matches_jax():
    x = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    got = tvit.patchify(torch.from_numpy(x), 8)
    assert got.shape == (2, 16, 192)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvit.patchify(jnp.asarray(x), 8)))


def test_vit_init_layout_and_from_jax_dtypes():
    """from_jax keeps the reference's dtypes leaf by leaf: on a bf16 tree the
    LayerNorm leaves stay float32 and the rest stay bf16."""
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), dtype=jnp.bfloat16)
    jparams = jvit.init(jcfg, jax.random.PRNGKey(1))
    tcfg = dataclasses.replace(tvit.ViTConfig.tiny(), dtype=torch.bfloat16)
    tparams = tvit.from_jax(_np_tree(jparams), tcfg, "cpu")
    mine = tvit.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    for name, leaf in jparams["layers"].items():
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert tparams["layers"][name].dtype == mine["layers"][name].dtype == want, name
        assert tuple(mine["layers"][name].shape) == leaf.shape, name
    assert tparams["final_ln_scale"].dtype == torch.float32
    assert tparams["head"].dtype == mine["head"].dtype == torch.bfloat16


def test_vit_forward_matches_jax(vit_models):
    jcfg, jparams, tcfg, tparams = vit_models
    images, _ = _images(1)
    want = jvit.forward(jparams, jnp.asarray(images), jcfg)
    got = tvit.forward(tparams, torch.from_numpy(images), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.fixture(scope="module")
def vit_loss_batch(vit_models):
    """A batch, and the JAX loss and gradients on it."""
    jcfg, jparams, _, _ = vit_models
    images, labels = _images(2)
    jloss, jgrads = jax.jit(jax.value_and_grad(jvit.loss_fn), static_argnums=3)(
        jparams, jnp.asarray(images), jnp.asarray(labels), jcfg)
    return images, labels, float(jloss), jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_vit_loss_and_grads_match_jax(vit_models, vit_loss_batch, remat):
    _, _, tcfg, tparams = vit_models
    images, labels, jloss, jgrads = vit_loss_batch
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tloss, tgrads = _torch_value_and_grad(tvit.loss_fn, tparams, torch.from_numpy(images),
                                          torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_grads_close(tgrads, jgrads)
