"""Algorithm: the trainable driver of the RL stack, counterpart of the JAX
package's `rllib/algorithms/algorithm.py` (parity: the reference's
`rllib/algorithms/algorithm.py:198`, whose `train()` runs one
`training_step` over an EnvRunnerGroup and a LearnerGroup).

Checkpoints follow the reference's shape, `algorithm_state.pkl` holding
the weights as numpy (nested dicts and lists, the reference's layouts),
the iteration, the timesteps and the config dict, so a state written by
either package restores in the other.

An env id with the `Jax` prefix is an on-card env (`env/device_env.py`);
every other id runs on env runners (built-in ids without gymnasium, the
rest through it).
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from ray_tpu_torch.rllib.core.learner import LearnerGroup, read_metrics
from ray_tpu_torch.rllib.core.rl_module import module_for_env
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup


class Algorithm:
    """Subclasses define `_loss_fn`, `_loss_cfg`, `module_kind` and
    `training_step()`."""

    module_kind = "actor_critic"

    def __init__(self, config):
        self.config = config
        if config.env is None:
            raise ValueError("config.environment(env=...) is required")
        from ray_tpu_torch.rllib.env.device_env import (
            is_device_env,
            make_device_env,
        )
        self._device_vec_env = None
        self._ondev_iter = None  # built on first use by the on-card path
        if is_device_env(config.env):
            # On-card env: the training iteration runs on the card with
            # the env (core/ondevice.py); no host env runners.
            from ray_tpu_torch.rllib.core.ondevice import OnDeviceSamplerGroup
            from ray_tpu_torch.rllib.core.rl_module import (
                MINATAR_FILTERS,
                NATURE_FILTERS,
                CNNActorCriticModule,
            )
            if not getattr(self, "supports_ondevice_env", False):
                raise ValueError(
                    "on-card envs need an algorithm with an on-card "
                    f"training path (PPO, IMPALA); {type(self).__name__} "
                    "uses env runners")
            venv = make_device_env(config.env,
                                   config.num_envs_per_env_runner,
                                   config.device)
            filters, dense = ((NATURE_FILTERS, 512)
                              if venv.obs_shape[0] >= 64
                              else (MINATAR_FILTERS, 128))
            self.module = CNNActorCriticModule(
                venv.obs_shape, venv.num_actions, filters=filters,
                dense=dense)
            self._device_vec_env = venv
            self.env_runner_group = OnDeviceSamplerGroup()
        else:
            from ray_tpu_torch.rllib.env.base import make
            probe = make(config.env, **config.env_config)
            self.module = module_for_env(
                probe, hidden=tuple(config.model.get("hidden", (64, 64))),
                kind=self.module_kind)
            probe.close()
            self.env_runner_group = EnvRunnerGroup(
                config.env, self.module,
                num_env_runners=config.num_env_runners,
                num_envs_per_env_runner=config.num_envs_per_env_runner,
                seed=config.seed, env_config=config.env_config,
                restart_failed=config.restart_failed_env_runners)
        self.learner_group = LearnerGroup(
            self.module, self._loss_fn(),
            num_learners=config.num_learners, device=config.device,
            config={"lr": config.lr, "grad_clip": config.grad_clip,
                    "seed": config.seed, "loss_cfg": self._loss_cfg()})
        self.iteration = 0
        self._timesteps = 0

    # ---- subclass hooks ----

    def _loss_fn(self):
        raise NotImplementedError

    def _loss_cfg(self) -> dict:
        return {}

    def training_step(self) -> dict:
        raise NotImplementedError

    # ---- Trainable surface ----

    def train(self) -> dict:
        t0 = time.perf_counter()
        self.iteration += 1
        result = self.training_step()
        result.update(self.env_runner_group.aggregate_metrics())
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "time_this_iter_s": time.perf_counter() - t0,
        })
        return result

    def get_weights(self):
        return self.learner_group.get_weights()

    def _extra_state(self) -> dict:
        """Algorithm-specific checkpoint payload, as numpy (SAC: target
        params, alpha, optimizer and generator states). Base: nothing."""
        return {}

    def _load_extra_state(self, extra: dict, weights) -> None:
        pass

    def save_to_path(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump({"weights": self.get_weights(),
                         "iteration": self.iteration,
                         "timesteps": self._timesteps,
                         "extra": self._extra_state(),
                         "config": self.config.to_dict()}, f)
        return path

    def restore_from_path(self, path: str):
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = _LenientUnpickler(f).load()
        self.learner_group.set_weights(state["weights"])
        self._load_extra_state(state.get("extra", {}), state["weights"])
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]

    @staticmethod
    def _replay_rows(f, *, actions_2d: bool) -> dict:
        """Fragment -> flat replay transitions, bootstrapping through time
        limits: rows truncated but not terminated are dropped (their
        next_obs is the auto-reset observation) and dones carry the
        terminated flags only."""
        T, B = f["rewards"].shape
        next_obs = np.concatenate([f["obs"][1:], f["final_obs"][None]],
                                  axis=0)
        dones = f["dones"].reshape(-1)
        terms = f["terminateds"].reshape(-1)
        keep = ~((dones > 0) & (terms == 0))
        actions = (f["actions"].reshape(T * B, -1) if actions_2d
                   else f["actions"].reshape(-1))
        return {
            "obs": f["obs"].reshape(T * B, -1)[keep],
            "actions": actions[keep],
            "rewards": f["rewards"].reshape(-1).astype(np.float32)[keep],
            "dones": terms.astype(np.float32)[keep],
            "next_obs": next_obs.reshape(T * B, -1)[keep],
        }

    def stop(self):
        self.env_runner_group.stop()
        self.learner_group.stop()

    # ---- shared helpers ----

    def _gae_device(self) -> torch.device:
        """Where per-fragment GAE / V-trace run: the local learner's device
        (the reference runs them on its default device), the CPU for actor
        groups."""
        local = self.learner_group.local
        return local.device if local is not None else torch.device("cpu")

    def _ondevice_learner(self):
        """The local learner of the on-card path, with the env's state and
        generator made on first use."""
        learner = self.learner_group.local
        if learner is None:
            raise ValueError(f"on-card {type(self).__name__} uses a local "
                             f"learner (num_learners=0)")
        if self._ondev_iter is None:
            venv = self._device_vec_env
            seed = self.config.seed or 0
            self._ondev_vs = venv.reset(
                torch.Generator(device=venv.device).manual_seed(seed))
            self._ondev_gen = torch.Generator(
                device=venv.device).manual_seed(seed + 1)
        return learner

    def _ondevice_result(self, m: dict, t0: float) -> dict:
        """One host read of an on-card iteration's metrics, its episode
        statistics banked, its time and steps counted."""
        m = read_metrics(m)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._timesteps += self._ondev_T * self._device_vec_env.num_envs
        self.env_runner_group.record(
            m.pop("ep_ret_sum"), m.pop("ep_len_sum"), m.pop("ep_count"))
        m["learner_update_ms"] = round(dt_ms, 1)
        m["sample_ms"] = 0.0  # sampling is inside the iteration
        return m

    def _concat_fragments(self, fragments: list[dict]) -> dict:
        """[T, B, ...] fragments from every runner -> flat [N, ...] batch,
        after per-fragment advantage computation by the subclass."""
        out = {}
        for k in fragments[0]:
            if k == "last_values":
                continue
            out[k] = np.concatenate(
                [f[k].reshape(-1, *f[k].shape[2:]) for f in fragments])
        return out


class _Unreadable:
    """Stands in for a pickled object whose class cannot be imported here
    (a JAX checkpoint's optax states where optax is not installed)."""

    def __new__(cls, *_a, **_k):
        return object.__new__(cls)

    def __init__(self, *_a, **_k):
        pass

    def __setstate__(self, _state):
        pass


class _LenientUnpickler(pickle.Unpickler):
    """Reads a checkpoint whose extra state holds classes this process
    cannot import: those load as `_Unreadable`, and the algorithm's
    `_load_extra_state` keeps only what it can read."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _Unreadable
