"""Envs: the port's env base and built-in games (no gymnasium needed),
the env runners, the multi-agent env and its runner, and the on-card
vector envs."""

from ray_tpu_torch.rllib.env.base import Box, Discrete, make, make_vec
from ray_tpu_torch.rllib.env.device_env import make_device_env
from ray_tpu_torch.rllib.env.env_runner import (
    EnvRunnerGroup,
    SingleAgentEnvRunner,
)
from ray_tpu_torch.rllib.env.multi_agent import (
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentEnvRunnerGroup,
)

__all__ = ["Box", "Discrete", "make", "make_vec", "make_device_env",
           "EnvRunnerGroup", "SingleAgentEnvRunner", "MultiAgentEnv",
           "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup"]
