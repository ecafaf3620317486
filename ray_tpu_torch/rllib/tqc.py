"""TQC in PyTorch: Truncated Quantile Critics (Kuznetsov et al. 2020), the
port of ray_tpu/rllib/tqc.py.

SAC's actor/temperature machinery (sac_continuous.py) with the twin scalar
critics replaced by M quantile critics of K atoms each; the Bellman target
pools all M*K next-state atoms, sorts, and DROPS the top d-per-net atoms,
truncating the overestimation tail that max-entropy bootstrapping amplifies.
The reference vmaps its M critic trees; here the critics are one tree of
stacked weights ([M, m, n] and [M, n] per layer, the reference's stacked
layout) run by batched matmuls.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.rllib.ppo import _mlp_apply, _mlp_init
from ray_tpu_torch.rllib.sac import SoftTargetLearner
from ray_tpu_torch.rllib.sac_continuous import (ContinuousSAC, ContinuousSACConfig,
                                                ContinuousSACLearner, _squashed_gaussian)


@dataclasses.dataclass
class TQCConfig(ContinuousSACConfig):
    num_critics: int = 5                 # M
    num_quantiles: int = 25              # K atoms per critic
    top_quantiles_to_drop_per_net: int = 2  # d: the truncation knob

    def build(self, device=None) -> "TQC":
        return TQC(self, device=device)


class TQCLearner(SoftTargetLearner):
    """M stacked quantile critics + SAC actor/alpha in one update."""

    int_keys = ()
    _noise = ContinuousSACLearner._noise  # the same two [B, A] normals an update
    labels = {"pi": "actor", "qs": "critic", "log_alpha": "alpha"}
    target_keys = ("qs",)

    def __init__(self, cfg: TQCConfig, obs_dim: int, act_dim: int, device=None):
        M, K = cfg.num_critics, cfg.num_quantiles
        if not 0 <= cfg.top_quantiles_to_drop_per_net < K:
            raise ValueError(
                f"top_quantiles_to_drop_per_net={cfg.top_quantiles_to_drop_per_net}"
                f" must be in [0, num_quantiles={K}): dropping every atom"
                " leaves an empty target (NaN losses)")
        self.n_keep = M * K - cfg.top_quantiles_to_drop_per_net * M
        super().__init__(cfg, device)
        pi = _mlp_init(self.generator, (obs_dim, *cfg.hidden, 2 * act_dim), self.device)
        critics = [_mlp_init(self.generator, (obs_dim + act_dim, *cfg.hidden, K), self.device)
                   for _ in range(M)]
        self.params = {
            "pi": pi,
            "qs": [{k: torch.stack([c[i][k] for c in critics]) for k in ("w", "b")}
                   for i in range(len(critics[0]))],
            "log_alpha": torch.zeros((), device=self.device),
        }
        self.target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                               else -float(act_dim))
        # quantile midpoints
        self.taus = (torch.arange(K, dtype=torch.float32, device=self.device) + 0.5) / K
        self._reset()

    @staticmethod
    def _z(qs, obs, act) -> torch.Tensor:
        """[M, B, K] atoms from the stacked critics."""
        return _mlp_apply(qs, torch.cat([obs, act], dim=-1))

    def loss(self, params, b: dict):
        cfg, z_all = self.cfg, self._z
        obs, next_obs = b["obs"], b["next_obs"]
        alpha = torch.exp(params["log_alpha"])
        # --- truncated distributional target ---
        next_a, next_logp = _squashed_gaussian(_mlp_apply(params["pi"], next_obs),
                                               b["eps_next"])
        nz = z_all(self.target["qs"], next_obs, next_a)            # [M, B, K]
        M, B, K = nz.shape
        pooled = torch.sort(nz.permute(1, 0, 2).reshape(B, M * K), dim=1).values
        kept = pooled[:, :self.n_keep]                              # drop the top tail
        y = (b["rewards"][:, None] + cfg.gamma * (1.0 - b["dones"][:, None])
             * (kept - alpha.detach() * next_logp[:, None])).detach()  # [B, n_keep]
        # --- quantile Huber regression, every critic against every kept atom ---
        z = z_all(params["qs"], obs, b["actions"])                  # [M, B, K]
        delta = y[None, :, None, :] - z[:, :, :, None]              # [M, B, K, n_keep]
        ad = delta.abs()
        huber = torch.where(ad <= 1.0, 0.5 * delta ** 2, ad - 0.5)
        w = torch.abs(self.taus[None, None, :, None] - (delta < 0.0).float())
        critic_loss = (w * huber).mean()
        # --- actor: maximize the UNtruncated mean of all atoms ---
        a_pi, logp_pi = _squashed_gaussian(_mlp_apply(params["pi"], obs), b["eps_pi"])
        qs_frozen = [{k: v.detach() for k, v in layer.items()} for layer in params["qs"]]
        q_pi = z_all(qs_frozen, obs, a_pi).mean(dim=(0, 2))        # [B]
        actor_loss = (alpha.detach() * logp_pi - q_pi).mean()
        alpha_loss = (-params["log_alpha"] * (logp_pi + self.target_entropy).detach()).mean()
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -logp_pi.mean()}


class TQC(ContinuousSAC):
    """SAC shell + TQC learner (same runners/buffer/off-policy loop)."""

    learner_cls = TQCLearner
