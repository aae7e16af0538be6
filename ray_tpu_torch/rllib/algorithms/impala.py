"""IMPALA: the asynchronous actor-learner with V-trace off-policy
correction, counterpart of the JAX package's `rllib/algorithms/impala.py`
(parity: the reference's `rllib/algorithms/impala/impala.py:599`).

Each env runner keeps one sample request in flight (the queue is the
object plane itself: refs are futures); the learner takes fragments as
they land, and V-trace (Espeholt et al. 2018) is an eager loop over the
time axis on the learner's device. A runner that dies is replaced and
sent a new request. With an on-card env the Anakin path runs instead
(`core/ondevice.py` `build_impala_train_iter`).
"""

from __future__ import annotations

import functools
import time

import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import _entropy, _logp_of
from ray_tpu_torch.rllib.core.learner import as_tensor
from ray_tpu_torch.rllib.core.rl_module import (
    fp32_products,
    params_from_numpy,
    tree_map,
)


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_pg_rho_threshold = 1.0
        self.num_env_runners = 2  # async needs remote runners
        self.broadcast_interval = 1  # updates between weight broadcasts

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 clip_rho_threshold=None, clip_pg_rho_threshold=None,
                 broadcast_interval=None, **kw):
        super().training(**kw)
        for k, v in (("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("clip_rho_threshold", clip_rho_threshold),
                     ("clip_pg_rho_threshold", clip_pg_rho_threshold),
                     ("broadcast_interval", broadcast_interval)):
            if v is not None:
                setattr(self, k, v)
        return self


def _vtrace_core(behavior_logp, target_logp, rewards, values, dones,
                 last_values, *, gamma, rho_bar=1.0, c_bar=1.0):
    """V-trace targets and policy-gradient advantages over [T, B],
    time-reversed, on the tensors' device -> (vs, pg_adv)."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_c = torch.clamp(rho, max=rho_bar)
    c = torch.clamp(rho, max=c_bar)
    v_next = torch.cat([values[1:], last_values[None]], dim=0)
    deltas = rho_c * (rewards + gamma * v_next * (1.0 - dones) - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(last_values)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * (1.0 - dones[t]) * c[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_next = torch.cat([vs[1:], last_values[None]], dim=0)
    pg_adv = rho_c * (rewards + gamma * vs_next * (1.0 - dones) - values)
    return vs, pg_adv


def _copy(p):
    return p.detach().clone()


def target_logp(module, params, obs, actions):
    """The learner's log-prob of `actions` and its value estimates."""
    logits, values = module.forward(params, obs)
    return _logp_of(logits, actions)[1], values


def impala_loss(params, batch, *, module, vf_coef, ent_coef):
    logits, value = module.forward_train(params, batch["obs"])
    logp_all, logp = _logp_of(logits, batch["actions"])
    pi_loss = -(batch["pg_advantages"] * logp).mean()
    vf_loss = torch.square(value - batch["vs"]).mean()
    entropy = _entropy(logp_all)
    total = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": entropy}


class IMPALA(Algorithm):
    supports_ondevice_env = True  # Anakin-style (core/ondevice.py)

    def __init__(self, config):
        from ray_tpu_torch.rllib.env.device_env import is_device_env
        if config.num_env_runners < 1 and not is_device_env(config.env):
            raise ValueError("IMPALA needs remote env runners (async) "
                             "or an on-card env (Anakin)")
        super().__init__(config)
        self._inflight: dict = {}  # ref -> runner index
        self._updates_since_broadcast = 0
        self._params_ref = None
        self._behavior_params = None  # on-card path: the stale actor tree

    def _loss_fn(self):
        return functools.partial(impala_loss, module=self.module)

    def _loss_cfg(self):
        c = self.config
        return {"vf_coef": c.vf_loss_coeff, "ent_coef": c.entropy_coeff}

    def _make_batch(self, f, vs, pg_adv) -> dict:
        T, B = f["rewards"].shape
        return {
            "obs": f["obs"].reshape(T * B, -1),
            "actions": f["actions"].reshape(-1),
            "vs": vs.reshape(-1),
            "pg_advantages": pg_adv.reshape(-1),
        }

    def _broadcast(self):
        self._params_ref = rt.put(self.learner_group.get_weights())

    def _launch(self, idx: int):
        runner = self.env_runner_group.remotes[idx]
        ref = runner.sample.remote(self._params_ref,
                                   self.config.rollout_fragment_length)
        self._inflight[ref] = idx

    def _training_step_ondevice(self) -> dict:
        """Anakin IMPALA: the on-card envs act with a behavior tree the host
        refreshes every broadcast_interval iterations; rollout, the
        learner's forward, V-trace and the minibatch pass run on the card
        with one host read."""
        c = self.config
        learner = self._ondevice_learner()
        if self._ondev_iter is None:
            from ray_tpu_torch.rllib.core.ondevice import (
                build_impala_train_iter,
            )
            B = self._device_vec_env.num_envs
            T = max(1, c.train_batch_size // B)
            self._ondev_iter = build_impala_train_iter(
                self._device_vec_env, self.module, T=T,
                minibatch_size=min(c.minibatch_size, T * B),
                gamma=c.gamma, rho_bar=c.clip_rho_threshold,
                c_bar=c.clip_pg_rho_threshold, vf_coef=c.vf_loss_coeff,
                ent_coef=c.entropy_coeff, learner=learner)
            self._ondev_T = T
            self._behavior_params = tree_map(_copy, learner.params)
        t0 = time.perf_counter()
        self._ondev_vs, m = self._ondev_iter(
            self._behavior_params, self._ondev_vs, self._ondev_gen)
        self._updates_since_broadcast += 1
        if self._updates_since_broadcast >= c.broadcast_interval:
            # the learner's params change in place: the behavior tree is a
            # copy taken now
            self._behavior_params = tree_map(_copy, learner.params)
            self._updates_since_broadcast = 0
        return self._ondevice_result(m, t0)

    def training_step(self) -> dict:
        if self._device_vec_env is not None:
            return self._training_step_ondevice()
        c = self.config
        dev = self._gae_device()
        if self._params_ref is None:
            self._broadcast()
            for i in range(len(self.env_runner_group.remotes)):
                self._launch(i)
        metrics = {}
        steps = 0
        while steps < c.train_batch_size:
            ready, _ = rt.wait(list(self._inflight), num_returns=1,
                               timeout=120)
            if not ready:
                raise TimeoutError("no sample fragment arrived in 120s")
            ref = ready[0]
            idx = self._inflight.pop(ref)
            try:
                f = rt.get(ref, timeout=60)
            except rt.RayTpuError:
                self.env_runner_group._replace(idx)
                self._launch(idx)
                continue
            # relaunch at once: the runner never waits on the learner
            self._launch(idx)
            # the freshest params: the local learner's own tree, else the
            # group's weights
            params = (self.learner_group.local.params
                      if self.learner_group.local is not None else
                      params_from_numpy(self.learner_group.get_weights(),
                                        dev))
            T, B = f["rewards"].shape

            def on(k):
                return as_tensor(f[k], dev)
            with fp32_products(), torch.no_grad():
                t_logp, _ = target_logp(
                    self.module, params,
                    on("obs").reshape(T * B, -1), on("actions").reshape(-1))
                vs, pg_adv = _vtrace_core(
                    on("logp"), t_logp.reshape(T, B), on("rewards"),
                    on("values"), on("dones"), on("last_values"),
                    gamma=c.gamma, rho_bar=c.clip_rho_threshold,
                    c_bar=c.clip_pg_rho_threshold)
            metrics = self.learner_group.update(
                self._make_batch(f, vs, pg_adv))
            steps += T * B
            self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= c.broadcast_interval:
                self._broadcast()
                self._updates_since_broadcast = 0
        self._timesteps += steps
        return metrics
