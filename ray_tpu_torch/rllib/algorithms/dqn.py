"""DQN, double and dueling deep Q-learning over a replay buffer,
counterpart of the JAX package's `rllib/algorithms/dqn.py` (parity: the
reference's `rllib/algorithms/dqn/dqn.py`: sample -> replay buffer -> TD
update -> periodic target sync).

The target tree rides the batch under "target_params", as in the JAX
package, so the loss keeps the learner's (params, batch) signature. It is
kept on the learner's device between syncs, so an update copies only the
sampled rows. Exploration is Boltzmann over Q (`QModule`).
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import tree_map
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # env steps
        self.double_q = True
        self.lr = 1e-3
        self.train_batch_size = 32
        self.num_updates_per_iter = 32

    def training(self, *, replay_buffer_capacity=None,
                 num_steps_sampled_before_learning_starts=None,
                 target_network_update_freq=None, double_q=None,
                 num_updates_per_iter=None, **kw):
        super().training(**kw)
        for k, v in (("replay_buffer_capacity", replay_buffer_capacity),
                     ("num_steps_sampled_before_learning_starts",
                      num_steps_sampled_before_learning_starts),
                     ("target_network_update_freq",
                      target_network_update_freq),
                     ("double_q", double_q),
                     ("num_updates_per_iter", num_updates_per_iter)):
            if v is not None:
                setattr(self, k, v)
        return self


def dqn_loss(params, batch, *, module, gamma, double_q):
    """TD loss; the batch carries the target tree under 'target_params'.
    The target is computed without a graph (the JAX package's
    stop_gradient)."""
    q = module.forward_train(params, batch["obs"])
    q_a = q.gather(-1, batch["actions"].long()[..., None])[..., 0]
    with torch.no_grad():
        q_next_target = module.forward_train(batch["target_params"],
                                             batch["next_obs"])
        if double_q:
            q_next_online = module.forward_train(params, batch["next_obs"])
            best = torch.argmax(q_next_online, dim=-1)
            q_next = q_next_target.gather(-1, best[..., None])[..., 0]
        else:
            q_next = q_next_target.max(dim=-1).values
        target = (batch["rewards"]
                  + gamma * (1.0 - batch["dones"]) * q_next)
    td = q_a - target
    loss = torch.square(td).mean()
    return loss, {"td_error_mean": td.abs().mean(), "q_mean": q_a.mean()}


class DQN(Algorithm):
    module_kind = "q"

    def __init__(self, config):
        if config.num_learners:
            raise ValueError(
                "DQN runs a single learner: the target tree rides the batch "
                "and cannot be row-sharded across learner actors")
        super().__init__(config)
        self.buffer = ReplayBuffer(config.replay_buffer_capacity,
                                   seed=config.seed)
        self.target_params = self._snapshot()
        self._last_target_sync = 0

    def _snapshot(self):
        """A copy of the online params on the learner's device."""
        return tree_map(lambda t: t.detach().clone(),
                        self.learner_group.local.params)

    def _loss_fn(self):
        return functools.partial(dqn_loss, module=self.module)

    def _loss_cfg(self):
        return {"gamma": self.config.gamma,
                "double_q": self.config.double_q}

    def training_step(self) -> dict:
        c = self.config
        params = self.learner_group.get_weights()
        frags = self.env_runner_group.sample(params,
                                             c.rollout_fragment_length)
        for f in frags:
            self.buffer.add_batch(self._replay_rows(f, actions_2d=False))
            self._timesteps += f["rewards"].size
        metrics = {}
        if self._timesteps >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.num_updates_per_iter):
                batch = self.buffer.sample(c.train_batch_size)
                batch["target_params"] = self.target_params
                metrics = self.learner_group.update(batch)
        if (self._timesteps - self._last_target_sync
                >= c.target_network_update_freq):
            self.target_params = self._snapshot()
            self._last_target_sync = self._timesteps
        return metrics
