"""ray_tpu_torch.rllib: ray_tpu/rllib in PyTorch.

Algorithms: PPO, IMPALA and APPO (on-policy / V-trace), DQN, discrete SAC,
continuous SAC and TQC (off-policy over a replay-buffer actor), the
LearnerGroup (data-parallel learners with example-weighted gradient
averaging), and the offline family: BC, MARWIL, CQL and IQL over a fixed
dataset (``load_offline_data``, ``write_offline_json``). Env runners, the
replay buffer and the learner group are thread actors of the port's
in-process runtime, so ``ray_tpu_torch.init()`` comes first; the offline
algorithms need no runtime. Multi-agent PPO (``MultiAgentEnv``, one
``PPOLearner`` per policy over a fleet of ``MultiAgentEnvRunner`` thread
actors) and model-based DreamerV3 (an RSSM world model and an actor-critic
trained on imagined rollouts; it collects in-process, no runtime) complete
the reference's set. The learners keep their parameters and optimizer
state on the card (``device=None`` is ``cuda:0``; pass ``device="cpu"`` for
the CPU); the env runners' policies stay numpy on the host, as the
reference's do, while DreamerV3's filtering policy runs on its device, as
the reference's runs on its default one.

``gymnasium`` is imported only where a string ``cfg.env`` is turned into an
env; a callable env needs none (the reference imports it in every
``__init__``). Each learner's ``from_jax(params_np)`` takes a JAX learner's
parameter tree (DreamerV3's ``from_jax(wm, actor, critic)`` its three).
"""

from ray_tpu_torch.rllib.appo import APPO, APPOConfig, APPOLearner
from ray_tpu_torch.rllib.connectors import (ClipActions, ClipObs, Connector, ConnectorPipeline,
                                            FlattenObs, FrameStack, NormalizeObs,
                                            UnsquashActions, pipeline)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner
from ray_tpu_torch.rllib.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, Episode, SingleAgentEnvRunner
from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, IMPALALearner
from ray_tpu_torch.rllib.iql import IQL, IQLConfig
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.multi_agent import (MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO,
                                             MultiAgentPPOConfig)
from ray_tpu_torch.rllib.offline import (BC, CQL, MARWIL, BCConfig, CQLConfig, MARWILConfig,
                                         OfflineConfig, load_offline_data, write_offline_json)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACLearner
from ray_tpu_torch.rllib.sac_continuous import (ContinuousSAC, ContinuousSACConfig,
                                                ContinuousSACLearner)
from ray_tpu_torch.rllib.tqc import TQC, TQCConfig, TQCLearner

__all__ = ["PPO", "PPOConfig", "PPOLearner", "DQN", "DQNConfig", "DQNLearner",
           "ReplayBuffer", "SAC", "SACConfig", "SACLearner",
           "IMPALA", "IMPALAConfig", "IMPALALearner",
           "DreamerV3", "DreamerV3Config", "LearnerGroup",
           "APPO", "APPOConfig", "APPOLearner",
           "EnvRunnerGroup", "Episode", "SingleAgentEnvRunner",
           "ContinuousSAC", "ContinuousSACConfig", "ContinuousSACLearner",
           "TQC", "TQCConfig", "TQCLearner",
           "BC", "BCConfig", "MARWIL", "MARWILConfig", "CQL", "CQLConfig", "IQL", "IQLConfig",
           "OfflineConfig", "load_offline_data", "write_offline_json",
           "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO", "MultiAgentPPOConfig",
           "Connector", "ConnectorPipeline", "FlattenObs", "ClipObs",
           "NormalizeObs", "FrameStack", "ClipActions", "UnsquashActions",
           "pipeline"]
