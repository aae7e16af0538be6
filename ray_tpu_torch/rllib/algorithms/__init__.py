"""The ported algorithms: PPO, IMPALA and APPO (the others raise
NotImplementedError, ROADMAP item 10 (b))."""

from ray_tpu_torch.rllib._unported import ITEM_10B, module_getattr
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig

__all__ = ["Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "APPO",
           "APPOConfig", "IMPALA", "IMPALAConfig"]

__getattr__ = module_getattr(__name__, ITEM_10B)
