"""DreamerV3 in PyTorch: RSSM world model + imagination actor-critic (the port
of ray_tpu/rllib/dreamerv3.py).

Parity: rllib/algorithms/dreamerv3/ (DreamerV3Config, the RSSM world model
and the imagined-rollout actor/critic losses). Vector observations, symlog
targets, KL balancing with free bits, straight-through categorical latents,
lambda-returns over imagined trajectories, and three independent optimizers
(world model with a global-norm clip of 100, actor, critic).

The programs are the reference's, term for term, run eagerly on the
algorithm's device (``device=None`` is ``cuda:0``): the RSSM's ``lax.scan``
over time is a Python loop here (``observe``, ``imagine``, the reverse
``lambda_returns``). Every categorical draw of the reference is
``argmax(logits + g)`` with ``g`` Gumbel noise (``jax.random.categorical``),
so each function that samples takes its ``g`` as an input, shaped like the
logits it perturbs; the algorithm draws it from its own ``torch.Generator``
on its device, where the reference splits a ``jax.random`` key. As in the
reference, an imagined action is a plain one-hot of a sampled index: nothing
else in the rollout depends on the actor, so the actor's gradient is its
entropy term's alone.

Initial weights are ``normal * sqrt(scale / fan_in)`` (scale 2 in the MLPs,
1 in the GRU's two projections) with zero biases, drawn from a CPU generator
seeded by ``cfg.seed`` and moved to the device; ``from_jax`` takes the
reference's trees. ``gymnasium`` is imported only to make a named env.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch.rllib import optim
from ray_tpu_torch.rllib.env_runner import Episode  # noqa: F401 (public surface)
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.ppo import _mlp_apply, make_env_creator


@dataclasses.dataclass
class DreamerV3Config:
    """Reference: dreamerv3/dreamerv3.py DreamerV3Config."""

    env: str | Callable = "CartPole-v1"
    seed: int = 0
    # world model
    deter_dim: int = 64          # GRU / deterministic state
    stoch_classes: int = 8       # categorical latent: classes per group
    stoch_groups: int = 4        # ... and groups
    hidden: int = 64
    free_bits: float = 1.0
    kl_dyn_scale: float = 0.5
    kl_rep_scale: float = 0.1
    wm_lr: float = 3e-4
    # actor critic (imagination)
    horizon: int = 8
    gamma: float = 0.985
    lambda_: float = 0.95
    entropy_coeff: float = 3e-3
    actor_lr: float = 1e-4
    critic_lr: float = 1e-4
    # replay / batching
    batch_size: int = 8
    batch_length: int = 16
    buffer_capacity: int = 200   # episodes
    collect_episodes: int = 4
    max_episode_len: int = 200

    def environment(self, env) -> "DreamerV3Config":
        self.env = env
        return self

    def training(self, **kw) -> "DreamerV3Config":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown training option {k}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "DreamerV3":
        return DreamerV3(self, device=device)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _linear(generator: torch.Generator, m: int, n: int, device, scale: float = 1.0) -> dict:
    w = torch.randn((m, n), generator=generator) * math.sqrt(scale / m)
    return {"w": w.to(device), "b": torch.zeros(n, device=device)}


def _mlp(generator: torch.Generator, sizes, device) -> list:
    return [_linear(generator, m, n, device, 2.0) for m, n in zip(sizes[:-1], sizes[1:])]


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """jax.random.gumbel's "low" mode: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


# ------------------------------------------------------------------ programs
def categorical(logits: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical over the last axis with its Gumbel noise given:
    argmax(g + logits)."""
    return torch.argmax(g + logits, dim=-1)


def gru(wm: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The fused-gate GRU of the reference (candidate tanh(r * c))."""
    gates = x @ wm["gru_x"]["w"] + wm["gru_x"]["b"] + h @ wm["gru_h"]["w"] + wm["gru_h"]["b"]
    r, u, c = torch.chunk(gates, 3, dim=-1)
    r, u = torch.sigmoid(r), torch.sigmoid(u)
    cand = torch.tanh(r * c)
    return u * h + (1 - u) * cand


def sample_st(cfg: DreamerV3Config, logits: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Straight-through categorical sample per latent group; ``g`` is the
    Gumbel noise, shaped [..., groups, classes]."""
    G, C = cfg.stoch_groups, cfg.stoch_classes
    lg = logits.reshape(logits.shape[:-1] + (G, C))
    onehot = F.one_hot(categorical(lg, g), C).to(lg.dtype)
    probs = torch.softmax(lg, dim=-1)
    st = onehot + probs - probs.detach()
    return st.reshape(st.shape[:-2] + (G * C,))


def kl_cat(cfg: DreamerV3Config, lhs_logits: torch.Tensor,
           rhs_logits: torch.Tensor) -> torch.Tensor:
    """KL(lhs || rhs) summed over groups, free-bits clipped."""
    G, C = cfg.stoch_groups, cfg.stoch_classes
    lp = torch.log_softmax(lhs_logits.reshape(lhs_logits.shape[:-1] + (G, C)), dim=-1)
    rp = torch.log_softmax(rhs_logits.reshape(rhs_logits.shape[:-1] + (G, C)), dim=-1)
    kl = (torch.exp(lp) * (lp - rp)).sum(-1).sum(-1)
    return torch.clamp_min(kl, cfg.free_bits)


def observe(cfg: DreamerV3Config, wm: dict, obs_seq: torch.Tensor, act_seq: torch.Tensor,
            g: torch.Tensor) -> tuple:
    """Filter a [B, T, ...] batch through the RSSM (posterior); ``g`` is
    [T, B, groups, classes]. Returns hs, zs, prior and posterior logits,
    each [B, T, ...]."""
    B, T = obs_seq.shape[:2]
    embed = _mlp_apply(wm["enc"], obs_seq)  # [B, T, H]
    h = obs_seq.new_zeros((B, cfg.deter_dim))
    z = obs_seq.new_zeros((B, cfg.stoch_classes * cfg.stoch_groups))
    hs, zs, priors, posts = [], [], [], []
    for t in range(T):
        h = gru(wm, h, torch.cat([z, act_seq[:, t]], -1))
        prior_logits = _mlp_apply(wm["prior"], h)
        post_logits = _mlp_apply(wm["post"], torch.cat([h, embed[:, t]], -1))
        z = sample_st(cfg, post_logits, g[t])
        hs.append(h)
        zs.append(z)
        priors.append(prior_logits)
        posts.append(post_logits)
    return tuple(torch.stack(x, 1) for x in (hs, zs, priors, posts))


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def wm_loss(cfg: DreamerV3Config, wm: dict, batch: dict, g: torch.Tensor) -> tuple:
    obs, acts = batch["obs"], batch["actions"]
    # PREVIOUS action drives the transition into step t (the collector's
    # h_{t+1} = gru(h_t, [z_t, a_t]) with a_t sampled after observing o_t)
    prev_acts = torch.cat([torch.zeros_like(acts[:, :1]), acts[:, :-1]], dim=1)
    hs, zs, priors, posts = observe(cfg, wm, obs, prev_acts, g)
    feat = torch.cat([hs, zs], -1)
    recon = _mlp_apply(wm["dec"], feat)
    rew_hat = _mlp_apply(wm["rew"], feat)[..., 0]
    cont_hat = _mlp_apply(wm["cont"], feat)[..., 0]
    recon_l = ((recon - symlog(obs)) ** 2).sum(-1).mean()
    rew_l = ((rew_hat - symlog(batch["rewards"])) ** 2).mean()
    cont_t = 1.0 - batch["dones"]
    cont_l = sigmoid_bce(cont_hat, cont_t).mean()
    dyn = kl_cat(cfg, posts.detach(), priors).mean()
    rep = kl_cat(cfg, posts, priors.detach()).mean()
    loss = (recon_l + rew_l + cont_l
            + cfg.kl_dyn_scale * dyn + cfg.kl_rep_scale * rep)
    return loss, {"wm_loss": loss, "recon": recon_l, "reward": rew_l,
                  "continue": cont_l, "kl_dyn": dyn, "kl_rep": rep,
                  "hs": hs, "zs": zs}


def imagine(cfg: DreamerV3Config, wm: dict, actor: list, h: torch.Tensor, z: torch.Tensor,
            g_a: torch.Tensor, g_z: torch.Tensor) -> tuple:
    """Roll the PRIOR forward under the actor for ``horizon`` steps; ``g_a``
    is [horizon, N, actions], ``g_z`` [horizon, N, groups, classes].
    Returns hs, zs, entropies, each [horizon, N, ...]."""
    A = g_a.shape[-1]
    hs, zs, ents = [], [], []
    for t in range(cfg.horizon):
        feat = torch.cat([h, z], -1)
        logits = _mlp_apply(actor, feat)
        a = F.one_hot(categorical(logits, g_a[t]), A).to(logits.dtype)
        h = gru(wm, h, torch.cat([z, a], -1))
        z = sample_st(cfg, _mlp_apply(wm["prior"], h), g_z[t])
        logp = torch.log_softmax(logits, dim=-1)
        ents.append(-(torch.exp(logp) * logp).sum(-1))
        hs.append(h)
        zs.append(z)
    return torch.stack(hs), torch.stack(zs), torch.stack(ents)


def lambda_returns(cfg: DreamerV3Config, rews: torch.Tensor, conts: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """[T - 1, N] lambda-returns, a reverse loop bootstrapped from values[-1]."""
    nxt = values[-1]
    rets = [None] * (len(values) - 1)
    for t in reversed(range(len(values) - 1)):
        nxt = rews[t] + cfg.gamma * conts[t] * (
            (1 - cfg.lambda_) * values[t + 1] + cfg.lambda_ * nxt)
        rets[t] = nxt
    return torch.stack(rets)


def _live(tree):
    """Detached aliases of a tree's leaves that require grad."""
    return optim.tree_map(lambda p: p.detach().requires_grad_(), tree)


def _grads(loss: torch.Tensor, tree) -> list[torch.Tensor]:
    leaves = optim.tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def wm_grads(cfg: DreamerV3Config, wm: dict, batch: dict, g: torch.Tensor) -> tuple:
    """(gradient of wm_loss per leaf of ``wm`` in tree_leaves order, aux)."""
    live = _live(wm)
    loss, aux = wm_loss(cfg, live, batch, g)
    return _grads(loss, live), {k: v.detach() for k, v in aux.items()}


def ac_grads(cfg: DreamerV3Config, actor: list, critic: list, wm: dict, sh: torch.Tensor,
             sz: torch.Tensor, g_a: torch.Tensor, g_z: torch.Tensor) -> tuple:
    """(actor gradients, critic gradients, metrics) of one imagined rollout
    from the posterior states (sh, sz): the actor's loss over the rollout,
    the critic regressed on its stop-gradient features."""
    live_a, live_c = _live(actor), _live(critic)
    hs, zs, ents = imagine(cfg, wm, live_a, sh, sz, g_a, g_z)
    feat = torch.cat([hs, zs], -1).detach()
    rews = symexp(_mlp_apply(wm["rew"], feat)[..., 0])
    conts = torch.sigmoid(_mlp_apply(wm["cont"], feat)[..., 0])
    # the critic before its step: the actor's bootstrap and its own regression
    values = _mlp_apply(live_c, feat)[..., 0]
    rets = lambda_returns(cfg, rews, conts, values.detach())
    actor_l = -(rets.mean() + cfg.entropy_coeff * ents.mean())
    critic_l = ((values[:-1] - rets) ** 2).mean()
    metrics = {"actor_loss": actor_l.detach(), "critic_loss": critic_l.detach(),
               "imagined_return": rets.mean()}
    return _grads(actor_l, live_a), _grads(critic_l, live_c), metrics


@torch.no_grad()
def policy_step(cfg: DreamerV3Config, wm: dict, actor: list, h: torch.Tensor, z: torch.Tensor,
                obs: torch.Tensor, g_z: torch.Tensor, g_a: torch.Tensor) -> tuple:
    """One filtering + acting step for the collector: (h_next, z, action)."""
    emb = _mlp_apply(wm["enc"], obs)
    post = _mlp_apply(wm["post"], torch.cat([h, emb], -1))
    z = sample_st(cfg, post, g_z)
    logits = _mlp_apply(actor, torch.cat([h, z], -1))
    a = categorical(logits, g_a)
    h_next = gru(wm, h, torch.cat([z, F.one_hot(a, logits.shape[-1]).to(h.dtype)], -1))
    return h_next, z, a


class DreamerV3:
    """The Algorithm (reference: dreamerv3.py training_step): collect with
    the filtering policy, train the world model on replayed sequences, train
    actor+critic on imagined rollouts from posterior states."""

    def __init__(self, cfg: DreamerV3Config, device=None):
        self.device = ray_tpu_torch.resolve_device(device)
        self.cfg = cfg
        self._env_creator = make_env_creator(cfg.env)
        probe = self._env_creator()
        self.obs_dim = int(np.prod(probe.observation_space.shape))
        self.num_actions = int(probe.action_space.n)
        probe.close()

        Z = cfg.stoch_classes * cfg.stoch_groups
        D, H, A = cfg.deter_dim, cfg.hidden, self.num_actions
        gen, dev = torch.Generator().manual_seed(cfg.seed), self.device
        self.wm = {
            "enc": _mlp(gen, (self.obs_dim, H, H), dev),
            # GRU over [z, a] with hidden D (fused gates)
            "gru_x": _linear(gen, Z + A, 3 * D, dev),
            "gru_h": _linear(gen, D, 3 * D, dev),
            "prior": _mlp(gen, (D, H, Z), dev),
            "post": _mlp(gen, (D + H, H, Z), dev),
            "dec": _mlp(gen, (D + Z, H, self.obs_dim), dev),
            "rew": _mlp(gen, (D + Z, H, 1), dev),
            "cont": _mlp(gen, (D + Z, H, 1), dev),
        }
        self.actor = _mlp(gen, (D + Z, H, A), dev)
        self.critic = _mlp(gen, (D + Z, H, 1), dev)
        self._reset_optimizers()
        # the sampling noise: its own generator on the device
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed + 1)
        self._np_rng = np.random.default_rng(cfg.seed)
        self._buffer: list[dict] = []  # episodes of {obs, actions, rewards, dones}
        self._iteration = 0

    def _reset_optimizers(self) -> None:
        cfg = self.cfg
        self.wm_opt = optim.Adam(optim.tree_leaves(self.wm), cfg.wm_lr, max_norm=100.0)
        self.actor_opt = optim.Adam(optim.tree_leaves(self.actor), cfg.actor_lr)
        self.critic_opt = optim.Adam(optim.tree_leaves(self.critic), cfg.critic_lr)

    def _on_device(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(device=self.device, dtype=torch.float32)

    def from_jax(self, wm, actor, critic) -> "DreamerV3":
        """Take the reference's world-model, actor and critic trees (numpy,
        the same nesting), with fresh optimizer state as its init makes it."""
        self.wm, self.actor, self.critic = (optim.tree_map(self._on_device, t)
                                            for t in (wm, actor, critic))
        self._reset_optimizers()
        return self

    def gumbel(self, shape) -> torch.Tensor:
        return gumbel(shape, self.generator, self.device)

    # ------------------------------------------------------------ updates
    def wm_update(self, batch: dict, g) -> dict:
        """One world-model step on a [B, T] batch with observe's noise ``g``
        [T, B, groups, classes]; returns the aux tensors (metrics, hs, zs)."""
        b = {k: self._on_device(v) for k, v in batch.items()}
        grads, aux = wm_grads(self.cfg, self.wm, b, self._on_device(g))
        with torch.no_grad():
            self.wm_opt.step(optim.tree_leaves(self.wm), grads)
        return aux

    def ac_update(self, sh, sz, g_a, g_z) -> dict:
        """One actor and one critic step from the flattened posterior states."""
        a_grads, c_grads, metrics = ac_grads(
            self.cfg, self.actor, self.critic, self.wm, self._on_device(sh),
            self._on_device(sz), self._on_device(g_a), self._on_device(g_z))
        with torch.no_grad():
            self.actor_opt.step(optim.tree_leaves(self.actor), a_grads)
            self.critic_opt.step(optim.tree_leaves(self.critic), c_grads)
        return metrics

    # ------------------------------------------------------------ data
    def _collect(self) -> float:
        cfg = self.cfg
        G, C, A = cfg.stoch_groups, cfg.stoch_classes, self.num_actions
        total = 0.0
        for _ in range(cfg.collect_episodes):
            env = self._env_creator()
            obs, _ = env.reset(seed=int(self._np_rng.integers(1 << 30)))
            h = torch.zeros((1, cfg.deter_dim), device=self.device)
            z = torch.zeros((1, G * C), device=self.device)
            ep = {"obs": [], "actions": [], "rewards": [], "dones": []}
            for _t in range(cfg.max_episode_len):
                noise = self.gumbel((1, G * C + A))
                o = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)[None]
                h, z, a = policy_step(cfg, self.wm, self.actor, h, z, o,
                                      noise[:, :G * C].reshape(1, G, C), noise[:, G * C:])
                act = int(a[0])
                nxt, rew, term, trunc, _ = env.step(act)
                ep["obs"].append(np.asarray(obs, np.float32))
                ep["actions"].append(act)
                ep["rewards"].append(float(rew))
                ep["dones"].append(bool(term))
                total += float(rew)
                obs = nxt
                if term or trunc:
                    break
            env.close()
            self._buffer.append({k2: np.asarray(v) for k2, v in ep.items()})
            if len(self._buffer) > cfg.buffer_capacity:
                self._buffer.pop(0)
        return total / cfg.collect_episodes

    def _sample_batch(self) -> dict:
        cfg = self.cfg
        B, T = cfg.batch_size, cfg.batch_length
        obs = np.zeros((B, T, self.obs_dim), np.float32)
        acts = np.zeros((B, T, self.num_actions), np.float32)
        rews = np.zeros((B, T), np.float32)
        dones = np.zeros((B, T), np.float32)
        for b in range(B):
            ep = self._buffer[self._np_rng.integers(len(self._buffer))]
            L = len(ep["rewards"])
            lo = self._np_rng.integers(max(1, L - T + 1))
            sl = slice(lo, lo + T)
            n = len(ep["rewards"][sl])
            obs[b, :n] = ep["obs"][sl]
            onehot = np.eye(self.num_actions, dtype=np.float32)[ep["actions"][sl]]
            acts[b, :n] = onehot
            rews[b, :n] = ep["rewards"][sl]
            dones[b, :n] = ep["dones"][sl]
        return {"obs": obs, "actions": acts, "rewards": rews, "dones": dones}

    # ------------------------------------------------------------ train
    def train(self) -> dict:
        cfg = self.cfg
        G, C = cfg.stoch_groups, cfg.stoch_classes
        mean_reward = self._collect()
        batch = self._sample_batch()
        aux = self.wm_update(batch, self.gumbel((cfg.batch_length, cfg.batch_size, G, C)))
        # imagination starts: flatten the posterior states
        hs, zs = aux.pop("hs"), aux.pop("zs")
        sh = hs.reshape(-1, hs.shape[-1])
        sz = zs.reshape(-1, zs.shape[-1])
        n = sh.shape[0]
        ac_metrics = self.ac_update(sh, sz, self.gumbel((cfg.horizon, n, self.num_actions)),
                                    self.gumbel((cfg.horizon, n, G, C)))
        self._iteration += 1
        out = Learner._floats({**aux, **ac_metrics})  # one device-to-host copy
        out["episode_reward_mean"] = mean_reward
        out["training_iteration"] = self._iteration
        out["buffer_episodes"] = len(self._buffer)
        return out
