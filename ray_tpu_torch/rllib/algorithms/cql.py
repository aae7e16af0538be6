"""CQL, conservative Q-learning for offline continuous control,
counterpart of the JAX package's `rllib/algorithms/cql.py` (parity: the
reference's `rllib/algorithms/cql/cql.py`: SAC trained only from a
recorded dataset, with the CQL(H) regularizer pushing Q down on
out-of-distribution actions).

SAC's update with a conservative critic: `num_ood_actions` uniform
actions (importance-weighted by the action box's volume) and as many
current-policy actions per state, their Q values batched over a leading
axis where the JAX package vmaps. The optional BC warm-up (`bc_iters`)
trains the actor to clone the dataset's actions first. The uniforms and
normals come from the SAC generator, or are fed (`noise=`).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.core.learner import read_metrics, to_device
from ray_tpu_torch.rllib.core.rl_module import tree_map
from ray_tpu_torch.rllib.offline import load_offline, rows_to_arrays


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.input_ = None            # rows | Dataset | path/glob
        self.cql_alpha = 1.0          # conservative penalty weight
        self.num_ood_actions = 4      # sampled actions per state
        self.bc_iters = 0             # optional BC warm-up iterations

    def offline_data(self, *, input_=None, **_compat):
        if input_ is not None:
            self.input_ = input_
        return self

    def training(self, *, cql_alpha=None, num_ood_actions=None,
                 bc_iters=None, **kw):
        super().training(**kw)
        if cql_alpha is not None:
            self.cql_alpha = cql_alpha
        if num_ood_actions is not None:
            self.num_ood_actions = num_ood_actions
        if bc_iters is not None:
            self.bc_iters = bc_iters
        return self


class CQL(SAC):
    """SAC's machinery and a conservative critic, trained from offline
    data only (no env sampling; the env serves evaluation rollouts)."""

    def __init__(self, config):
        if config.input_ is None:
            raise ValueError("CQLConfig.offline_data(input_=...) is required")
        super().__init__(config)
        rows = load_offline(config.input_)
        if not rows:
            self.stop()
            raise ValueError("offline input is empty")
        self._data = rows_to_arrays(rows, continuous=True)
        if "next_obs" not in self._data:
            self.stop()
            raise ValueError("CQL needs next_obs in the offline data")
        m = self.module
        self._low = torch.tensor(m.low, dtype=torch.float32,
                                 device=self.device)
        self._high = torch.tensor(m.high, dtype=torch.float32,
                                  device=self.device)

    def _draw_noise(self, B: int) -> dict:
        """SAC's normals, then [n_ood, B, A] uniforms in the action box and
        [n_ood, B, A] normals for the policy's out-of-distribution
        actions."""
        noise = super()._draw_noise(B)
        shape = (int(self.config.num_ood_actions), B, self.module.action_dim)
        u = torch.rand(shape, generator=self._gen, device=self.device)
        noise["rand"] = self._low + u * (self._high - self._low)
        noise["pol"] = torch.randn(shape, generator=self._gen,
                                   device=self.device)
        return noise

    def _critic_loss(self, batch, target, noise):
        """Bellman error plus cql_alpha times the CQL(H) gap: logsumexp of
        Q over the sampled actions less Q on the dataset's."""
        m = self.module
        obs = batch["obs"]
        q1, q2 = m.q_values(self.params, obs, batch["actions"])
        bellman = (torch.square(q1 - target).mean()
                   + torch.square(q2 - target).mean())
        n_ood = noise["rand"].shape[0]
        with torch.no_grad():
            pol_a, pol_logp = m.sample(
                tree_map(torch.Tensor.detach, self.params),
                obs.expand(n_ood, *obs.shape), eps=noise["pol"])
        obs_n = obs.expand(n_ood, *obs.shape)
        r1, r2 = m.q_values(self.params, obs_n, noise["rand"])
        p1, p2 = m.q_values(self.params, obs_n, pol_a)
        log_vol = torch.log(self._high - self._low).sum()
        cat1 = torch.cat([r1 + log_vol, p1 - pol_logp], 0)
        cat2 = torch.cat([r2 + log_vol, p2 - pol_logp], 0)
        cql1 = (torch.logsumexp(cat1, dim=0) - q1).mean()
        cql2 = (torch.logsumexp(cat2, dim=0) - q2).mean()
        loss = bellman + float(self.config.cql_alpha) * (cql1 + cql2)
        return loss, {"bellman_loss": bellman.detach()}

    def _actor_loss(self, batch, alpha, noise, bc_mode=False):
        if not bc_mode:
            return super()._actor_loss(batch, alpha, noise)
        # BC warm-up: clone the dataset's actions before trusting the
        # conservative critic
        m = self.module
        _a, logp = m.sample(self.params, batch["obs"], eps=noise["actor"])
        lp_data = m.log_prob(self.params, batch["obs"], batch["actions"])
        return (alpha * logp - lp_data).mean(), logp

    def training_step(self) -> dict:
        c = self.config
        n = len(self._data["obs"])
        rng = np.random.default_rng(c.seed + self.iteration)
        # train() counts the iteration before calling this: 1-based
        bc_mode = bool(c.bc_iters) and self.iteration <= c.bc_iters
        metrics = {}
        for _ in range(c.num_updates_per_iter):
            sel = rng.integers(0, n, size=c.train_batch_size)
            batch = to_device({k: v[sel] for k, v in self._data.items()},
                              self.device)
            metrics = self._update(batch, bc_mode=bc_mode)
        self._timesteps += c.num_updates_per_iter * c.train_batch_size
        return read_metrics(metrics)

    def evaluate(self, num_steps: int = 500) -> dict:
        self.env_runner_group.sample(self.get_weights(), num_steps)
        return self.env_runner_group.aggregate_metrics()
