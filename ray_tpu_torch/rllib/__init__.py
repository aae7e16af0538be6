"""ray_tpu_torch.rllib: reinforcement learning on the port, counterpart of
the JAX package's `rllib` (the reference's new API stack: RLModule,
Learner / LearnerGroup, EnvRunner / EnvRunnerGroup, AlgorithmConfig /
Algorithm).

The on-policy half: PPO, IMPALA and APPO over host env runners (built-in
MinAtar and AtariClass games, or gymnasium ids where gymnasium is
installed) and over on-card vector envs (`env/device_env.py`, ids
JaxMinAtarBreakout-v0 and JaxAtariClassBreakout-v0). The off-policy,
offline, multi-agent and model-based half: DQN and SAC over a replay
buffer (`utils/replay_buffer.py`), offline data (`offline.py`) for BC,
MARWIL and CQL, the multi-agent env and multi-agent PPO, and DreamerV3.
Learners run on the card unless the config asks for the CPU
(`learners(device="cpu")`); checkpoints cross with the JAX package's.
"""

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
from ray_tpu_torch.rllib.env.multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
)
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "APPO", "APPOConfig",
    "BC", "BCConfig", "DQN", "DQNConfig", "IMPALA", "IMPALAConfig",
    "MARWIL", "MARWILConfig", "SAC", "SACConfig", "CQL", "CQLConfig",
    "DreamerV3", "DreamerV3Config",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiAgentEnv",
    "MultiAgentEnvRunner", "ReplayBuffer",
]
