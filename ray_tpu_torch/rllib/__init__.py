"""ray_tpu_torch.rllib: reinforcement learning on the port, counterpart of
the JAX package's `rllib` (the reference's new API stack: RLModule,
Learner / LearnerGroup, EnvRunner / EnvRunnerGroup, AlgorithmConfig /
Algorithm).

Ported: the on-policy half, PPO, IMPALA and APPO, over host env runners
(built-in MinAtar and AtariClass games, or gymnasium ids where gymnasium
is installed) and over on-card vector envs (`env/device_env.py`, ids
JaxMinAtarBreakout-v0 and JaxAtariClassBreakout-v0), with the learner on
the card (or in learner actors) and checkpoints that cross with the JAX
package's. DQN, SAC, CQL, BC, MARWIL, DreamerV3, the multi-agent env and
multi-agent PPO, offline data and the replay buffer are ROADMAP item 10
(b): asking for one raises NotImplementedError.
"""

from ray_tpu_torch.rllib._unported import ITEM_10B, module_getattr
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig

__all__ = ["Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "APPO",
           "APPOConfig", "IMPALA", "IMPALAConfig"]

__getattr__ = module_getattr(__name__, ITEM_10B)
