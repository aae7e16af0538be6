"""APPO, asynchronous PPO (IMPALA's actor-learner loop with the clipped
loss), counterpart of the JAX package's `rllib/algorithms/appo.py`
(parity: the reference's `rllib/algorithms/appo/appo.py`: async sampling,
V-trace correction and the PPO clipped surrogate on the corrected
advantages).
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import _entropy, _logp_of


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.clip_param = 0.2

    def training(self, *, clip_param=None, **kw):
        super().training(**kw)
        if clip_param is not None:
            self.clip_param = clip_param
        return self


def appo_loss(params, batch, *, module, clip, vf_coef, ent_coef):
    logits, value = module.forward_train(params, batch["obs"])
    logp_all, logp = _logp_of(logits, batch["actions"])
    ratio = torch.exp(logp - batch["behavior_logp"])
    adv = batch["pg_advantages"]
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    pi_loss = -surr.mean()
    vf_loss = torch.square(value - batch["vs"]).mean()
    entropy = _entropy(logp_all)
    total = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


class APPO(IMPALA):
    """IMPALA's async machinery; the learner applies the clipped surrogate
    against the behavior policy's log-probs."""

    def _loss_fn(self):
        return functools.partial(appo_loss, module=self.module)

    def _loss_cfg(self):
        c = self.config
        return {"clip": c.clip_param, "vf_coef": c.vf_loss_coeff,
                "ent_coef": c.entropy_coeff}

    def _make_batch(self, f, vs, pg_adv):
        T, B = f["rewards"].shape
        return {
            "obs": f["obs"].reshape(T * B, -1),
            "actions": f["actions"].reshape(-1),
            "behavior_logp": f["logp"].reshape(-1),
            "vs": vs.reshape(-1),
            "pg_advantages": pg_adv.reshape(-1),
        }
