"""EnvRunner: vectorized-environment sampling, counterpart of the JAX
package's `rllib/env/env_runner.py` (parity: the reference's
`single_agent_env_runner.py:68` inside `env_runner_group.py:71`).

The split is the reference's own: env stepping is host work, one host
round trip a step, so the runner acts on the CPU, with a CPU copy of the
params it is handed (numpy, as weights travel), while the learner holds
the card. That is the design, not a fallback: paying a card dispatch and
a device-to-host copy a step would cap env-steps/s below the CPU forward
itself. Remote runners are actors on the port's runtime reserving no GPU;
a dead one is replaced on the next sample round.
"""

from __future__ import annotations

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.core.rl_module import params_from_numpy, tree_map
from ray_tpu_torch.rllib.env.base import make_vec


def _flat(obs):
    return np.asarray(obs, dtype=np.float32).reshape(len(obs), -1)


def _cpu_params(params):
    """A CPU copy of a weights tree (numpy, or tensors on any device)."""
    return params_from_numpy(
        tree_map(lambda v: v.detach().cpu().numpy()
                 if isinstance(v, torch.Tensor) else np.asarray(v), params),
        "cpu")


class SingleAgentEnvRunner:
    """Steps `num_envs` copies of an env (a built-in id, or any gymnasium
    id where gymnasium is installed) with same-step autoreset, collecting
    fixed-length rollout fragments."""

    def __init__(self, env_name: str, module, num_envs: int = 1,
                 seed: int = 0, env_config: dict | None = None):
        self.env = make_vec(env_name, num_envs, **(env_config or {}))
        self.num_envs = num_envs
        self.module = module
        self.acting_params = None
        # acting draws from its own CPU generator
        self._gen = torch.Generator().manual_seed(int(seed))
        obs, _ = self.env.reset(seed=seed)
        self.obs = _flat(obs)
        # per-env accumulators for completed-episode returns
        self._ep_ret = np.zeros(num_envs, dtype=np.float64)
        self._ep_len = np.zeros(num_envs, dtype=np.int64)
        self.completed_returns: list[float] = []
        self.completed_lengths: list[int] = []

    @torch.no_grad()
    def sample(self, params, num_steps: int, explore: bool = True) -> dict:
        """Collect a [T, B, ...] fragment as numpy arrays (they ride the
        object plane zero-copy), acting with a CPU copy of `params` (kept as
        `acting_params`): sampled actions, or with `explore=False` the
        greedy ones (logp and values zero)."""
        params = self.acting_params = _cpu_params(params)
        T, B = num_steps, self.num_envs
        obs_buf = np.empty((T, B, self.obs.shape[-1]), np.float32)
        if getattr(self.module, "action_kind", "discrete") == "continuous":
            act_buf = np.empty((T, B, self.module.action_dim), np.float32)
        else:
            act_buf = np.empty((T, B), np.int64)
        logp_buf = np.empty((T, B), np.float32)
        val_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        done_buf = np.empty((T, B), np.float32)
        term_buf = np.empty((T, B), np.float32)
        for t in range(T):
            if explore:
                action, logp, value = self.module.forward_exploration(
                    params, torch.from_numpy(self.obs), self._gen)
                logp_buf[t] = logp.numpy()
                val_buf[t] = value.numpy()
            else:
                action = self.module.forward_inference(
                    params, torch.from_numpy(self.obs))
                logp_buf[t] = val_buf[t] = 0.0
            action = action.numpy()
            obs_buf[t] = self.obs
            act_buf[t] = action
            nxt, rew, term, trunc, _ = self.env.step(action)
            done = np.logical_or(term, trunc)
            rew_buf[t] = rew
            done_buf[t] = done
            term_buf[t] = term  # truncation is NOT termination: TD targets
            # bootstrap through time limits (dones only cut episodes)
            self._ep_ret += rew
            self._ep_len += 1
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_ret[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
                self._ep_ret[i] = 0.0
                self._ep_len[i] = 0
            self.obs = _flat(nxt)
        # bootstrap value of the final obs (used by GAE / V-trace)
        _, _, last_val = self.module.forward_exploration(
            params, torch.from_numpy(self.obs), self._gen)
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "terminateds": term_buf,
            "last_values": last_val.numpy(),
            "final_obs": self.obs.copy(),  # next_obs tail for TD targets
        }

    def get_metrics(self) -> dict:
        rets, lens = self.completed_returns, self.completed_lengths
        return {
            "episode_return_mean": (float(np.mean(rets[-100:]))
                                    if rets else float("nan")),
            "episode_len_mean": (float(np.mean(lens[-100:]))
                                 if lens else float("nan")),
            "num_episodes": len(rets),
        }

    def ping(self):
        return "ok"


class RunnerGroupBase:
    """Local or remote runners with fault handling (parity:
    env_runner_group.py:71 local-worker mode; restart_failed_env_runners /
    FaultAwareApply, env_runner.py:32). Subclasses set `runner_cls` and
    call `_init_runners(args, kw, ...)`; dead remote runners are replaced
    on the next sample round."""

    runner_cls: type = None

    def _init_runners(self, args: tuple, kw: dict, *, num_env_runners: int,
                      seed: int, restart_failed: bool):
        self._args = args
        self._kw = kw
        self.restart_failed = restart_failed
        self.num_env_runners = num_env_runners
        self._seed = seed
        if num_env_runners == 0:
            self.local = self.runner_cls(*args, seed=seed, **kw)
            self.remotes = []
        else:
            self.local = None
            self._cls = rt.remote(num_cpus=1)(self.runner_cls)
            self.remotes = [
                self._cls.remote(*args, seed=seed + i, **kw)
                for i in range(num_env_runners)]

    def _replace(self, idx: int):
        self.remotes[idx] = self._cls.remote(
            *self._args, seed=self._seed + 1000 + idx, **self._kw)

    def sample(self, params, num_steps: int) -> list[dict]:
        if self.local is not None:
            return [self.local.sample(params, num_steps)]
        params_ref = rt.put(params)
        refs = [(i, r.sample.remote(params_ref, num_steps))
                for i, r in enumerate(self.remotes)]
        out = []
        for i, ref in refs:
            try:
                out.append(rt.get(ref, timeout=120))
            except rt.RayTpuError:
                if not self.restart_failed:
                    raise
                self._replace(i)
        return out

    def aggregate_metrics(self) -> dict:
        if self.local is not None:
            return self.local.get_metrics()
        rets, lens, n = [], [], 0
        for i, r in enumerate(self.remotes):
            try:
                m = rt.get(r.get_metrics.remote(), timeout=60)
            except rt.RayTpuError:
                if self.restart_failed:
                    self._replace(i)
                continue
            if m["num_episodes"]:
                rets.append(m["episode_return_mean"])
                lens.append(m["episode_len_mean"])
                n += m["num_episodes"]
        return {
            "episode_return_mean": (float(np.mean(rets)) if rets
                                    else float("nan")),
            "episode_len_mean": float(np.mean(lens)) if lens else float("nan"),
            "num_episodes": n,
        }

    def stop(self):
        for r in self.remotes:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001 - best effort at teardown
                pass


class EnvRunnerGroup(RunnerGroupBase):
    runner_cls = SingleAgentEnvRunner

    def __init__(self, env_name: str, module, *, num_env_runners: int = 0,
                 num_envs_per_env_runner: int = 1, seed: int = 0,
                 env_config: dict | None = None, restart_failed: bool = True):
        self._init_runners(
            (env_name, module),
            dict(num_envs=num_envs_per_env_runner, env_config=env_config),
            num_env_runners=num_env_runners, seed=seed,
            restart_failed=restart_failed)
