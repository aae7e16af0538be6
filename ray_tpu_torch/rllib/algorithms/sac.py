"""SAC, soft actor-critic for continuous control, counterpart of the JAX
package's `rllib/algorithms/sac.py` (parity: the reference's
`rllib/algorithms/sac/sac.py`: twin Q critics with a soft TD target, a
reparameterized actor and an auto-tuned temperature).

As there, one update covers the critic, the actor and the temperature,
then the polyak target: the critic's and the actor's gradients (they touch
disjoint leaves) take one Adam step over the whole tree, log alpha its own
(`train/optim.py`'s AdamW at weight decay 0 is optax's `adam`). The module
is `SquashedGaussianModule`; its standard normals come from a
`torch.Generator` on the learner's device (the JAX package's PRNG key), or
are fed (`noise=`) so a test can hold an update against the JAX one.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import read_metrics, to_device
from ray_tpu_torch.rllib.core.rl_module import (
    fp32_products,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer
from ray_tpu_torch.train.optim import adamw


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 500
        self.tau = 0.005               # polyak target update
        self.initial_alpha = 0.2
        self.target_entropy = None     # None -> -action_dim
        self.lr = 3e-4
        self.train_batch_size = 64
        self.num_updates_per_iter = 32
        self.rollout_fragment_length = 16

    def training(self, *, replay_buffer_capacity=None, tau=None,
                 initial_alpha=None, target_entropy=None,
                 num_steps_sampled_before_learning_starts=None,
                 num_updates_per_iter=None, **kw):
        super().training(**kw)
        for k, v in (("replay_buffer_capacity", replay_buffer_capacity),
                     ("tau", tau), ("initial_alpha", initial_alpha),
                     ("target_entropy", target_entropy),
                     ("num_steps_sampled_before_learning_starts",
                      num_steps_sampled_before_learning_starts),
                     ("num_updates_per_iter", num_updates_per_iter)):
            if v is not None:
                setattr(self, k, v)
        return self


def _opt_to_numpy(opt: torch.optim.Optimizer) -> dict:
    """An Adam state as numpy lists in leaf order (step, m, v)."""
    leaves = opt.param_groups[0]["params"]
    st = [opt.state[p] for p in leaves]
    return {k: [s[k].detach().cpu().numpy() for s in st]
            for k in ("step", "exp_avg", "exp_avg_sq")}


def _opt_from_numpy(opt: torch.optim.Optimizer, state: dict) -> None:
    with torch.no_grad():
        for i, p in enumerate(opt.param_groups[0]["params"]):
            s = opt.state[p]
            for k in ("step", "exp_avg", "exp_avg_sq"):
                s[k].copy_(torch.as_tensor(state[k][i]))


class SAC(Algorithm):
    """Owns its update (critic, actor and alpha in one step) instead of
    the generic single-loss learner path; the learner group holds the
    params, which `self.params` shares."""

    module_kind = "sac"

    def __init__(self, config):
        config.num_learners = 0  # the fused update is the learner
        super().__init__(config)
        c = config
        m = self.module
        if getattr(m, "action_kind", "discrete") != "continuous":
            raise ValueError("SAC needs a continuous (Box) action space")
        self.buffer = ReplayBuffer(c.replay_buffer_capacity, seed=c.seed)
        learner = self.learner_group.local
        self.device = learner.device
        self.params = learner.params
        self._leaves = tree_leaves(self.params)
        self.target_params = tree_map(lambda t: t.detach().clone(),
                                      self.params)
        self.log_alpha = torch.tensor(
            float(np.log(c.initial_alpha)), dtype=torch.float32,
            device=self.device, requires_grad=True)
        self.target_entropy = (c.target_entropy
                               if c.target_entropy is not None
                               else -float(m.action_dim))
        self.opt = adamw(c.lr, weight_decay=0.0).init(
            dict(enumerate(self._leaves)))
        self.alpha_opt = adamw(c.lr, weight_decay=0.0).init(
            {"log_alpha": self.log_alpha})
        self._gen = torch.Generator(device=self.device).manual_seed(
            c.seed + 7)

    def _loss_fn(self):
        # The generic learner is only a parameter container for SAC.
        return lambda params, batch: (torch.zeros(()), {})

    # ---- the update ----

    def _draw_noise(self, B: int) -> dict:
        A = self.module.action_dim
        return {k: torch.randn((B, A), generator=self._gen,
                               device=self.device)
                for k in ("next", "actor")}

    def _soft_target(self, batch, alpha, noise):
        """The soft TD target from the target critics, without a graph."""
        m, c = self.module, self.config
        with torch.no_grad():
            next_a, next_logp = m.sample(self.params, batch["next_obs"],
                                         eps=noise["next"])
            tq1, tq2 = m.q_values(self.target_params, batch["next_obs"],
                                  next_a)
            tq = torch.minimum(tq1, tq2) - alpha * next_logp
            return batch["rewards"] + c.gamma * (1 - batch["dones"]) * tq

    def _critic_loss(self, batch, target, noise):
        """-> (critic loss, aux)."""
        q1, q2 = self.module.q_values(self.params, batch["obs"],
                                      batch["actions"])
        return (torch.square(q1 - target).mean()
                + torch.square(q2 - target).mean()), {}

    def _actor_loss(self, batch, alpha, noise, bc_mode=False):
        """-> (actor loss, logp of the sampled actions). The critics are
        read through detached params (the JAX package's stop_gradient)."""
        m = self.module
        a, logp = m.sample(self.params, batch["obs"], eps=noise["actor"])
        q1, q2 = m.q_values(tree_map(torch.Tensor.detach, self.params),
                            batch["obs"], a)
        return (alpha * logp - torch.minimum(q1, q2)).mean(), logp

    def _update(self, batch: dict, noise: dict | None = None,
                bc_mode: bool = False) -> dict:
        """One step on a batch of device tensors -> its metrics, on the
        device. `noise` feeds the standard normals (and CQL's uniforms);
        drawn from the generator when None."""
        if noise is None:
            noise = self._draw_noise(batch["obs"].shape[0])
        tau = self.config.tau
        with fp32_products():
            alpha = torch.exp(self.log_alpha.detach())
            target = self._soft_target(batch, alpha, noise)
            closs, caux = self._critic_loss(batch, target, noise)
            aloss, logp = self._actor_loss(batch, alpha, noise, bc_mode)
            grads = torch.autograd.grad(closs + aloss, self._leaves,
                                        allow_unused=True)
            for p, g in zip(self._leaves, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            alpha_loss = (-torch.exp(self.log_alpha)
                          * (logp.detach() + self.target_entropy)).mean()
            (self.log_alpha.grad,) = torch.autograd.grad(alpha_loss,
                                                         [self.log_alpha])
            self.alpha_opt.step()
            self.alpha_opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                for t, p in zip(tree_leaves(self.target_params),
                                self._leaves):
                    t.copy_((1 - tau) * t + tau * p)
        return {"critic_loss": closs.detach(), **caux,
                "actor_loss": aloss.detach(),
                "alpha": torch.exp(self.log_alpha.detach()),
                "entropy": -logp.detach().mean()}

    def training_step(self) -> dict:
        c = self.config
        frags = self.env_runner_group.sample(self.get_weights(),
                                             c.rollout_fragment_length)
        for f in frags:
            self.buffer.add_batch(self._replay_rows(f, actions_2d=True))
            self._timesteps += f["rewards"].size
        metrics = {}
        if (c.num_updates_per_iter and self._timesteps
                >= c.num_steps_sampled_before_learning_starts):
            # the iteration's minibatches drawn in the buffer's order and
            # copied to the device at once: a copy a minibatch would wait
            # for the device's queue before every update
            n = c.num_updates_per_iter
            draws = [self.buffer.sample(c.train_batch_size)
                     for _ in range(n)]
            stacked = to_device({k: np.stack([d[k] for d in draws])
                                 for k in draws[0]}, self.device)
            for i in range(n):
                metrics = self._update({k: v[i] for k, v in stacked.items()})
            metrics = read_metrics(metrics)
        return metrics

    def get_weights(self):
        return params_to_numpy(self.params)

    def _extra_state(self) -> dict:
        return {
            "format": "ray_tpu_torch",
            "target_params": params_to_numpy(self.target_params),
            "log_alpha": float(self.log_alpha.detach()),
            "opt_state": _opt_to_numpy(self.opt),
            "alpha_opt_state": _opt_to_numpy(self.alpha_opt),
            "generator": self._gen.get_state().numpy(),
            "generator_device": self._gen.device.type,
        }

    def _load_extra_state(self, extra: dict, weights) -> None:
        """The weights are in by then (the learner group shares
        `self.params`). A checkpoint of the JAX package holds optax states
        and a JAX key, which this package cannot take: from one, SAC
        restores the weights only, the target params, alpha and the
        optimizer states keep their values. The generator's state is
        taken where it was saved from a generator on the same kind of
        device (a CUDA generator's state does not fit a CPU one)."""
        if extra.get("format") != "ray_tpu_torch":
            return
        with torch.no_grad():
            for t, w in zip(tree_leaves(self.target_params), tree_leaves(
                    params_from_numpy(extra["target_params"], "cpu"))):
                t.copy_(w)
            self.log_alpha.fill_(float(extra["log_alpha"]))
        _opt_from_numpy(self.opt, extra["opt_state"])
        _opt_from_numpy(self.alpha_opt, extra["alpha_opt_state"])
        if extra.get("generator_device") == self._gen.device.type:
            self._gen.set_state(torch.from_numpy(extra["generator"]))
