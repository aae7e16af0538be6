"""Modules, learners and the on-card training iterations."""

from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup
from ray_tpu_torch.rllib.core.ondevice import (
    OnDeviceSamplerGroup,
    build_impala_train_iter,
    build_ppo_train_iter,
)
from ray_tpu_torch.rllib.core.rl_module import (
    ActorCriticModule,
    CNNActorCriticModule,
    QModule,
    SquashedGaussianModule,
    module_for_env,
)

__all__ = ["Learner", "LearnerGroup", "OnDeviceSamplerGroup",
           "build_ppo_train_iter", "build_impala_train_iter",
           "ActorCriticModule", "CNNActorCriticModule", "QModule",
           "SquashedGaussianModule", "module_for_env"]
