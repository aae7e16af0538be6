"""On-card training iterations: rollout, advantages and the update with
the env on the card, counterpart of the JAX package's
`rllib/core/ondevice.py`.

There, with a jax env, a whole iteration (T env steps x B envs of policy
forwards, dynamics and frame rendering, GAE or V-trace, advantage
normalization and the minibatch update) is one `jax.jit` program and the
host fetches a few scalars. Here the same iteration runs as eager torch
loops on the card (`env/device_env.py`): observations never leave it, the
loops read nothing from the device, and the metrics come back as 0-d
device tensors for the caller's one host read. The update steps share the
learner's optimizer and clipping (`Learner.step`), as the reference's
share its `tx`.
"""

from __future__ import annotations

import functools

import torch

from ray_tpu_torch.rllib.core.rl_module import fp32_products
from ray_tpu_torch.rllib.env.device_env import DeviceVecEnv, build_rollout


def _minibatches(n: int, minibatch_size: int) -> int:
    if n % minibatch_size:
        raise ValueError(f"T*B={n} must tile into minibatches "
                         f"of {minibatch_size}")
    return n // minibatch_size


def _flat(traj: dict, n: int) -> dict:
    return {k: v.reshape((n,) + tuple(v.shape[2:])) for k, v in traj.items()}


def _sweep(learner, loss_fn, flat: dict, perm, n_mb: int) -> tuple:
    """SGD over the rows of `flat` in `perm`'s order, n_mb minibatches ->
    the last (loss, aux) on the device."""
    loss = aux = None
    for idx in perm.view(n_mb, -1):
        mb = {k: v.index_select(0, idx) for k, v in flat.items()}
        loss, aux = learner.step(mb, loss_fn)
    return loss, aux


def _metrics(loss, aux, vs) -> dict:
    return {**aux, "total_loss": loss, "ep_ret_sum": vs.done_ret_sum,
            "ep_len_sum": vs.done_len_sum, "ep_count": vs.done_count}


def build_ppo_train_iter(vec_env: DeviceVecEnv, module, *, T: int,
                         num_epochs: int, minibatch_size: int,
                         gamma: float, lam: float, clip: float,
                         vf_coef: float, ent_coef: float, learner):
    """-> train_iter(vs, generator) -> (vs, metrics): one PPO iteration on
    the card, `learner.params` updated in place by its optimizer."""
    from ray_tpu_torch.rllib.algorithms.ppo import _gae, ppo_loss

    rollout = build_rollout(vec_env, module, T)
    n = T * vec_env.num_envs
    n_mb = _minibatches(n, minibatch_size)
    loss_fn = functools.partial(ppo_loss, module=module, clip=clip,
                                vf_coef=vf_coef, ent_coef=ent_coef)

    def train_iter(vs, generator):
        with fp32_products():
            vs, traj = rollout(learner.params, vs, generator)
        adv, ret = _gae(traj["rewards"], traj["values"], traj["dones"],
                        traj["last_values"], gamma=gamma, lam=lam)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        flat = _flat({"obs": traj["obs"], "actions": traj["actions"],
                      "logp": traj["logp"], "advantages": adv,
                      "returns": ret}, n)
        loss = aux = None
        for _ in range(num_epochs):
            perm = torch.randperm(n, generator=generator,
                                  device=vec_env.device)
            loss, aux = _sweep(learner, loss_fn, flat, perm, n_mb)
        return vs, _metrics(loss, aux, vs)

    return train_iter


def build_impala_train_iter(vec_env: DeviceVecEnv, module, *, T: int,
                            minibatch_size: int, gamma: float,
                            rho_bar: float, c_bar: float, vf_coef: float,
                            ent_coef: float, learner):
    """On-card IMPALA (the Anakin / Podracer formulation, Hessel et al.
    2021): the envs act with a stale behavior tree that the caller
    refreshes every broadcast_interval iterations, V-trace corrects the
    off-policy gap, and one minibatch pass updates the learner.

    -> train_iter(behavior_params, vs, generator) -> (vs, metrics)."""
    from ray_tpu_torch.rllib.algorithms.impala import (
        _vtrace_core,
        impala_loss,
        target_logp,
    )

    rollout = build_rollout(vec_env, module, T)
    B = vec_env.num_envs
    n = T * B
    n_mb = _minibatches(n, minibatch_size)
    loss_fn = functools.partial(impala_loss, module=module,
                                vf_coef=vf_coef, ent_coef=ent_coef)

    def train_iter(behavior_params, vs, generator):
        with fp32_products(), torch.no_grad():
            # act with the behavior tree: traj's logp / values are its
            vs, traj = rollout(behavior_params, vs, generator)
            flat_obs = traj["obs"].reshape((n,) + tuple(vec_env.obs_shape))
            acts = traj["actions"].reshape(n)
            # the learner's forward: target logp and value estimates
            t_logp, values_l = target_logp(module, learner.params, flat_obs,
                                           acts)
            vs_t, pg_adv = _vtrace_core(
                traj["logp"], t_logp.reshape(T, B), traj["rewards"],
                values_l.reshape(T, B), traj["dones"],
                traj["last_values"], gamma=gamma, rho_bar=rho_bar,
                c_bar=c_bar)
        flat = {"obs": flat_obs, "actions": acts, "vs": vs_t.reshape(n),
                "pg_advantages": pg_adv.reshape(n)}
        perm = torch.randperm(n, generator=generator, device=vec_env.device)
        loss, aux = _sweep(learner, loss_fn, flat, perm, n_mb)
        return vs, _metrics(loss, aux, vs)

    return train_iter


class OnDeviceSamplerGroup:
    """Stands in for EnvRunnerGroup when the env is on the card: episode
    statistics live on the device (banked by DeviceVecEnv.step) and surface
    through the same aggregate_metrics() interface."""

    def __init__(self):
        self._ret_sum = 0.0
        self._len_sum = 0.0
        self._count = 0
        self._window = []  # recent completed-episode means per iteration

    def record(self, ret_sum: float, len_sum: float, count: float):
        d_ret = ret_sum - self._ret_sum
        d_len = len_sum - self._len_sum
        d_n = count - self._count
        self._ret_sum, self._len_sum, self._count = ret_sum, len_sum, count
        if d_n > 0:
            self._window.append((d_ret / d_n, d_len / d_n, d_n))
            self._window = self._window[-100:]

    def aggregate_metrics(self) -> dict:
        if not self._window:
            return {"episode_return_mean": float("nan"),
                    "episode_len_mean": float("nan"), "num_episodes": 0}
        rets = [r for r, _, _ in self._window]
        lens = [ln for _, ln, _ in self._window]
        return {"episode_return_mean": float(sum(rets) / len(rets)),
                "episode_len_mean": float(sum(lens) / len(lens)),
                "num_episodes": int(self._count)}

    def stop(self):
        pass
