"""Model family: Llama-style decoder transformers, dense and MoE
(counterpart of `ray_tpu.models`)."""

from ray_tpu_torch.models.transformer import (
    ModelConfig,
    forward,
    hidden_states,
    init_params,
    loss_fn,
    param_logical_axes,
)
from ray_tpu_torch.models import configs
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

__all__ = ["ModelConfig", "init_params", "forward", "hidden_states",
           "loss_fn", "param_logical_axes", "configs", "params_from_numpy",
           "params_to_numpy"]
