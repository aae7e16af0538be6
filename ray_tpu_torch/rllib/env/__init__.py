"""Envs: the port's env base and built-in games (no gymnasium needed),
the env runners, and the on-card vector envs. The multi-agent env raises
NotImplementedError (ROADMAP item 10 (b))."""

from ray_tpu_torch.rllib._unported import ITEM_10B, module_getattr
from ray_tpu_torch.rllib.env.base import Box, Discrete, make, make_vec
from ray_tpu_torch.rllib.env.device_env import make_device_env
from ray_tpu_torch.rllib.env.env_runner import (
    EnvRunnerGroup,
    SingleAgentEnvRunner,
)

__all__ = ["Box", "Discrete", "make", "make_vec", "make_device_env",
           "EnvRunnerGroup", "SingleAgentEnvRunner"]

__getattr__ = module_getattr(__name__, ITEM_10B)
