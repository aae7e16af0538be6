"""Training (counterpart of `ray_tpu.train`): the train step, one-device
or sharded over a mesh, AdamW as optax defines it, and checkpoints (the
two-phase manifest protocol and train-state save/restore, sharded states
through torch.distributed.checkpoint). The trainer, its worker group and
session belong to a later slice of the port."""

from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                            commit_manifest, gc_uncommitted,
                                            latest_committed, load_manifest,
                                            restore_state, save_checkpoint,
                                            save_state)
from ray_tpu_torch.train.optim import AdamW, adamw
from ray_tpu_torch.train.step import TrainState, make_train_step

__all__ = ["TrainState", "make_train_step", "AdamW", "adamw", "save_state",
           "restore_state", "save_checkpoint", "Checkpoint",
           "CheckpointManager", "commit_manifest", "load_manifest",
           "latest_committed", "gc_uncommitted"]
