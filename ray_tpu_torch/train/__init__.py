"""Training (counterpart of `ray_tpu.train`): the one-device train step,
AdamW as optax defines it, and state save/restore. The trainer, its
worker group and session, the sharded step and the checkpoint manifest
protocol belong to later slices of the port."""

from ray_tpu_torch.train.checkpoint import restore_state, save_state
from ray_tpu_torch.train.optim import AdamW, adamw
from ray_tpu_torch.train.step import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step", "AdamW", "adamw", "save_state",
           "restore_state"]
