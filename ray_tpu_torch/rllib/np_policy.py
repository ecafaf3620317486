"""Numpy-side actor-critic policy for env runners (a copy of
ray_tpu/rllib/np_policy.py).

Shared by PPO/IMPALA: env-runner actors evaluate the tiny MLP in numpy, on
the host, so thread actors share no torch module and launch nothing on the
card per env step (reference: env runners hold plain RLModule forward
passes)."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy_params(params):
    """Host-side numpy copy of a parameter tree (dicts, lists, torch tensors
    on any device, or arrays): the one form env runners receive weights in."""
    if isinstance(params, dict):
        return {k: to_numpy_params(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_numpy_params(v) for v in params]
    if isinstance(params, torch.Tensor):
        return params.detach().to("cpu", copy=True).numpy()  # never aliases the leaf
    return np.asarray(params)


def np_mlp(layers, x: np.ndarray) -> np.ndarray:
    """Forward the _mlp_init layer list in numpy (tanh hidden activations)."""
    for i, layer in enumerate(layers):
        x = x @ np.asarray(layer["w"]) + np.asarray(layer["b"])
        if i < len(layers) - 1:
            x = np.tanh(x)
    return x


def log_softmax(logits: np.ndarray) -> np.ndarray:
    z = logits - logits.max(axis=-1, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))


def actor_critic_policy_fn(params, obs, rng):
    """(action, logprob, value) from {"pi": layers, "vf": layers} params."""
    logits = np_mlp(params["pi"], obs.astype(np.float64))
    z = logits - logits.max()
    p = np.exp(z)
    p /= p.sum()
    action = int(rng.choice(len(p), p=p))
    v = np_mlp(params["vf"], obs.astype(np.float64))
    return action, float(np.log(p[action] + 1e-12)), float(v[0])
