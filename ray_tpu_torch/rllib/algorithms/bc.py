"""BC, behavior cloning from offline (obs, action) data, counterpart of
the JAX package's `rllib/algorithms/bc.py` (parity: the reference's
`rllib/algorithms/bc/bc.py`, supervised policy learning over recorded
episodes and the base of MARWIL).

Offline data arrives as a `ray_tpu_torch.data` Dataset, a list of dicts
or a path or glob of files (`offline.load_offline`) with "obs" and
"actions" columns, the shape the reference reads from its offline JSON
and Parquet files.
"""

from __future__ import annotations

import functools

import numpy as np
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.input_ = None  # Dataset | list[dict] | path/glob

    def offline_data(self, *, input_=None, **_compat):
        if input_ is not None:
            self.input_ = input_
        return self


def bc_loss(params, batch, *, module):
    logits, _ = module.forward_train(params, batch["obs"])
    logp = F.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, batch["actions"].long()[..., None])[..., 0]
    loss = -ll.mean()
    return loss, {"neg_logp": loss}


class BC(Algorithm):
    """Supervised: no env sampling; evaluation uses a local env runner."""

    def __init__(self, config):
        if config.input_ is None:
            raise ValueError("BCConfig.offline_data(input_=...) is required")
        config.num_env_runners = 0  # an evaluation-only local runner
        super().__init__(config)
        from ray_tpu_torch.rllib.offline import load_offline
        rows = load_offline(config.input_)
        if not rows:
            self.stop()  # the groups exist already: leak no actors
            raise ValueError("offline input is empty")
        self._rows = rows  # materialized once; subclasses read from here
        self._obs = np.asarray([r["obs"] for r in rows], np.float32)
        self._actions = np.asarray([r["actions"] for r in rows], np.int64)
        self._rng = np.random.default_rng(config.seed)

    def _loss_fn(self):
        return functools.partial(bc_loss, module=self.module)

    def _batch(self, sel) -> dict:
        """A minibatch for the learner; subclasses (MARWIL) add columns."""
        return {"obs": self._obs[sel], "actions": self._actions[sel]}

    def training_step(self) -> dict:
        c = self.config
        n = len(self._obs)
        metrics = {}
        for _ in range(c.num_epochs):
            idx = self._rng.permutation(n)
            floor = max(2, c.num_learners or 1)  # every learner needs rows
            for s in range(0, n, c.minibatch_size):
                sel = idx[s:s + c.minibatch_size]
                if len(sel) < floor:
                    continue
                metrics = self.learner_group.update(self._batch(sel))
        self._timesteps += n * c.num_epochs
        return metrics

    def evaluate(self, num_steps: int = 500) -> dict:
        """Roll the cloned policy (sampling its actions) for a return
        estimate."""
        self.env_runner_group.sample(self.learner_group.get_weights(),
                                     num_steps)
        return self.env_runner_group.aggregate_metrics()
