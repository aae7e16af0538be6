"""PPO, the clipped-surrogate policy optimization, counterpart of the JAX
package's `rllib/algorithms/ppo.py` (parity: the reference's
`rllib/algorithms/ppo/ppo.py:388` training_step: sample -> GAE ->
LearnerGroup update with minibatch epochs).

GAE is an eager loop over the time axis on the learner's device, where
the reference runs a `lax.scan`; the loss is the reference's in torch.
With an on-card env (`env/device_env.py`) a whole iteration runs on the
card (`core/ondevice.py`) with one metrics read.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import as_tensor


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.lambda_ = 0.95

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, lambda_=None, **kw):
        super().training(**kw)
        if clip_param is not None:
            self.clip_param = clip_param
        if vf_loss_coeff is not None:
            self.vf_loss_coeff = vf_loss_coeff
        if entropy_coeff is not None:
            self.entropy_coeff = entropy_coeff
        if lambda_ is not None:
            self.lambda_ = lambda_
        return self


def _gae(rewards, values, dones, last_values, *, gamma, lam,
         bootstrap=None):
    """Generalized advantage estimation over [T, B], time-reversed, on the
    tensors' device -> (advantages, returns).

    `dones` marks episode boundaries (terminated OR truncated): the lambda
    chain always cuts there. `bootstrap`, when given, holds the value of the
    post-step state at boundary rows (zero for true terminations, V(s_next)
    for truncations), so truncated episodes are bootstrapped instead of
    treated as if the return were zero."""
    if bootstrap is None:
        bootstrap = torch.zeros_like(rewards)
    v_next = torch.cat([values[1:], last_values[None]], dim=0)
    advs = torch.empty_like(rewards)
    carry = torch.zeros_like(last_values)
    for t in range(rewards.shape[0] - 1, -1, -1):
        d = dones[t]
        v_eff = (1.0 - d) * v_next[t] + d * bootstrap[t]
        delta = rewards[t] + gamma * v_eff - values[t]
        carry = delta + gamma * lam * (1.0 - d) * carry
        advs[t] = carry
    return advs, advs + values


def _logp_of(logits, actions):
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions.long()[..., None])[..., 0]
    return logp_all, logp


def _entropy(logp_all):
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


def ppo_loss(params, batch, *, module, clip, vf_coef, ent_coef):
    logits, value = module.forward_train(params, batch["obs"])
    logp_all, logp = _logp_of(logits, batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["advantages"]
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    pi_loss = -surr.mean()
    vf_loss = torch.square(value - batch["returns"]).mean()
    entropy = _entropy(logp_all)
    total = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy,
                   "kl": (batch["logp"] - logp).mean()}


class PPO(Algorithm):
    supports_ondevice_env = True  # on-card envs (env/device_env.py)

    def _loss_fn(self):
        return functools.partial(ppo_loss, module=self.module)

    def _loss_cfg(self):
        c = self.config
        return {"clip": c.clip_param, "vf_coef": c.vf_loss_coeff,
                "ent_coef": c.entropy_coeff}

    def training_step(self) -> dict:
        if self._device_vec_env is not None:
            return self._training_step_ondevice()
        c = self.config
        dev = self._gae_device()
        t0 = time.perf_counter()
        params = self.learner_group.get_weights()
        batches = []
        steps = 0
        while steps < c.train_batch_size:
            frags = self.env_runner_group.sample(
                params, c.rollout_fragment_length)
            for f in frags:
                adv, ret = _gae(
                    *(as_tensor(f[k], dev) for k in
                      ("rewards", "values", "dones", "last_values")),
                    gamma=c.gamma, lam=c.lambda_)
                # one host read for both outputs
                f["advantages"], f["returns"] = (
                    torch.stack([adv, ret]).cpu().numpy())
                steps += f["rewards"].size
            batches.extend(frags)
        self._timesteps += steps
        batch = self._concat_fragments(batches)
        adv = batch["advantages"]
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        batch = {k: batch[k] for k in
                 ("obs", "actions", "logp", "advantages", "returns")}
        n = batch["obs"].shape[0]
        sample_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        # local learner: the epochs x minibatches sweep, one metrics read
        metrics = self.learner_group.update_epochs(
            batch, num_epochs=c.num_epochs,
            minibatch_size=c.minibatch_size, seed=self.iteration)
        if metrics is not None:
            metrics["sample_ms"] = round(sample_ms, 1)
            metrics["learner_update_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 1)
            return metrics
        metrics = {}
        rng = np.random.default_rng(self.iteration)
        for _ in range(c.num_epochs):
            perm = rng.permutation(n)
            for s in range(0, n, c.minibatch_size):
                idx = perm[s:s + c.minibatch_size]
                if len(idx) < 2:
                    continue
                metrics = self.learner_group.update(
                    {k: v[idx] for k, v in batch.items()})
        return metrics

    def _training_step_ondevice(self) -> dict:
        """On-card env: rollout, GAE and the epochs on the card
        (core/ondevice.py), one host read of the metrics."""
        c = self.config
        learner = self._ondevice_learner()
        if self._ondev_iter is None:
            from ray_tpu_torch.rllib.core.ondevice import build_ppo_train_iter
            B = self._device_vec_env.num_envs
            T = max(1, c.train_batch_size // B)
            self._ondev_iter = build_ppo_train_iter(
                self._device_vec_env, self.module, T=T,
                num_epochs=c.num_epochs,
                minibatch_size=min(c.minibatch_size, T * B),
                gamma=c.gamma, lam=c.lambda_, clip=c.clip_param,
                vf_coef=c.vf_loss_coeff, ent_coef=c.entropy_coeff,
                learner=learner)
            self._ondev_T = T
        t0 = time.perf_counter()
        self._ondev_vs, m = self._ondev_iter(self._ondev_vs, self._ondev_gen)
        return self._ondevice_result(m, t0)
