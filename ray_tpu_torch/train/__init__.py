"""Training (counterpart of `ray_tpu.train`): the train step, one-device
or sharded over a mesh, AdamW as optax defines it, checkpoints (the
two-phase manifest protocol and train-state save/restore, sharded states
through torch.distributed.checkpoint), and the Trainer: a controller and
worker-group actors on the port's runtime, with failure restarts from the
last committed manifest and one torch.distributed group over the workers
(`TorchDistributedConfig`)."""

from ray_tpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                            commit_manifest, gc_uncommitted,
                                            latest_committed, load_manifest,
                                            restore_state, save_checkpoint,
                                            save_state)
from ray_tpu_torch.train.optim import AdamW, adamw
from ray_tpu_torch.train.step import TrainState, make_train_step
from ray_tpu_torch.train.backend import Backend, TorchDistributedConfig
from ray_tpu_torch.train.trainer import (FailureConfig, RunConfig,
                                         ScalingConfig, Trainer,
                                         list_train_runs)
from ray_tpu_torch.train import session
from ray_tpu_torch.train.session import (get_checkpoint, get_context,
                                         get_dataset_shard, report)

__all__ = ["TrainState", "make_train_step", "AdamW", "adamw", "save_state",
           "restore_state", "save_checkpoint", "Checkpoint",
           "CheckpointManager", "commit_manifest", "load_manifest",
           "latest_committed", "gc_uncommitted", "Trainer", "ScalingConfig",
           "RunConfig", "FailureConfig", "Backend", "TorchDistributedConfig",
           "session", "report", "get_checkpoint", "get_context",
           "get_dataset_shard", "list_train_runs"]
