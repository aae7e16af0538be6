"""Utilities: the replay buffer."""

from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer

__all__ = ["ReplayBuffer"]
