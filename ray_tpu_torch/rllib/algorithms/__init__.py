"""The algorithms: PPO, IMPALA and APPO; DQN and SAC; BC, MARWIL and CQL
from offline data; multi-agent PPO; DreamerV3."""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.multi_agent_ppo import (
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig

__all__ = ["Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "APPO",
           "APPOConfig", "IMPALA", "IMPALAConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "BC", "BCConfig", "MARWIL", "MARWILConfig",
           "CQL", "CQLConfig", "MultiAgentPPO", "MultiAgentPPOConfig",
           "DreamerV3", "DreamerV3Config"]
