"""MARWIL, monotonic advantage re-weighted imitation learning,
counterpart of the JAX package's `rllib/algorithms/marwil.py` (parity:
the reference's `rllib/algorithms/marwil/marwil.py`: clone actions weighted
by exp(beta * advantage), the advantage being the observed return minus a
learned value baseline; beta = 0 is BC).

It shares BC's offline data; rows also carry "returns" (rewards-to-go).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = MARWIL
        self.beta = 1.0
        self.vf_coeff = 1.0

    def training(self, *, beta=None, vf_coeff=None, **kw):
        super().training(**kw)
        if beta is not None:
            self.beta = beta
        if vf_coeff is not None:
            self.vf_coeff = vf_coeff
        return self


def marwil_loss(params, batch, *, module, beta, vf_coeff):
    logits, value = module.forward_train(params, batch["obs"])
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"].long()[..., None])[..., 0]
    adv = batch["returns"] - value
    # Scale-normalized before the exponential (parity: the reference
    # divides by a running sqrt(E[adv^2]); raw returns in the hundreds
    # would overflow fp32 exp), clipped against the symmetric underflow.
    adv_sg = adv.detach()
    rms = torch.sqrt(torch.mean(torch.square(adv_sg)) + 1e-8)
    w = torch.exp(torch.clamp(beta * adv_sg / rms, -10.0, 10.0))
    w = w / torch.clamp(w.mean(), min=1e-8)
    pi_loss = -(w * logp).mean()
    vf_loss = torch.square(adv).mean()
    return pi_loss + vf_coeff * vf_loss, {
        "policy_loss": pi_loss, "vf_loss": vf_loss,
        "mean_advantage": adv.mean()}


class MARWIL(BC):
    def __init__(self, config):
        super().__init__(config)
        # self._rows is BC's one materialization: reading a Dataset again
        # could reorder the rows and misalign the returns.
        if "returns" not in self._rows[0]:
            self.stop()
            raise ValueError(
                "MARWIL offline rows need 'returns' (rewards-to-go)")
        self._returns = np.asarray([r["returns"] for r in self._rows],
                                   np.float32)

    def _loss_fn(self):
        return functools.partial(
            marwil_loss, module=self.module, beta=self.config.beta,
            vf_coeff=self.config.vf_coeff)

    def _batch(self, sel) -> dict:
        return {"obs": self._obs[sel], "actions": self._actions[sel],
                "returns": self._returns[sel]}
