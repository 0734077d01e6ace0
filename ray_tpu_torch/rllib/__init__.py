"""ray_tpu_torch.rllib — RL on the port's runtime, learners on the card.

Counterpart of ``ray_tpu/rllib/`` (reference surface: RLlib, ray:
rllib/ — Algorithm/AlgorithmConfig, EnvRunnerGroup sampling actors,
Learner). Semantics kept: config -> build -> algo.train() iterations;
env-runner ACTORS collect rollouts with the current policy and feed
sample batches through the object store to the learner; runner death
is survived (respawn + resample).

The learner runs in PyTorch on ``config.device`` (None means the card,
and raises without one; ``"cpu"`` runs it on the host). Runners step
their envs and run their policy forward on the host in CPU torch, with
a CPU copy of the learner's params sent once a round.

    from ray_tpu_torch.rllib import PPOConfig

    algo = PPOConfig(num_env_runners=2, num_envs_per_runner=4).build()
    algo.train()["episode_return_mean"]
"""

from ray_tpu_torch.rllib.connectors import (  # noqa: F401
    ActionClip, ActionConnector, ActionLambda, ActionPipeline, ActionRescale,
    Connector, ConnectorPipeline, Lambda, ObsNormalizer)
from ray_tpu_torch.rllib.core import (  # noqa: F401
    Algorithm, AlgorithmConfig, DiscreteMLP, GaussianMLP, RLModule,
    module_for_env)
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.env import CartPoleEnv, PendulumEnv  # noqa: F401
from ray_tpu_torch.rllib.impala import (  # noqa: F401
    APPO, APPOConfig, IMPALA, IMPALAConfig)
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    IndependentCartPoles, MultiAgentEnv, MultiAgentPPO, MultiAgentPPOConfig,
    TwoStepGame)
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    BC, BCConfig, collect_episodes)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.sac import SAC, SACConfig  # noqa: F401

__all__ = ["Algorithm", "AlgorithmConfig", "RLModule", "DiscreteMLP",
           "GaussianMLP", "module_for_env",
           "PPOConfig", "PPO", "DQNConfig", "DQN", "IMPALAConfig",
           "IMPALA", "APPOConfig", "APPO", "SACConfig", "SAC",
           "BCConfig", "BC",
           "collect_episodes", "CartPoleEnv", "PendulumEnv",
           "MultiAgentEnv", "MultiAgentPPOConfig", "MultiAgentPPO",
           "IndependentCartPoles", "TwoStepGame",
           "Connector", "ConnectorPipeline",
           "Lambda", "ObsNormalizer", "ActionConnector", "ActionClip",
           "ActionRescale", "ActionLambda", "ActionPipeline"]
