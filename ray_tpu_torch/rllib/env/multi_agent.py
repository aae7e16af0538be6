"""Multi-agent environments and the multi-agent env runner, counterpart
of the JAX package's `rllib/env/multi_agent.py` (parity: the reference's
`rllib/env/multi_agent_env.py`, dict-keyed observations, actions and
rewards with an "__all__" done flag, and the multi-agent half of
`rllib/env/multi_agent_env_runner.py`).

As in the single-agent runner, env stepping is host work and the runner
acts on the CPU with a CPU copy of each policy's params, drawing from its
own CPU `torch.Generator`; per-policy batches go to the learners.

Scope, as in the JAX package: every agent in `possible_agents` is present
at every step (no agents appearing or leaving mid-episode).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.env.env_runner import RunnerGroupBase, _cpu_params


class MultiAgentEnv:
    """Dict-keyed multi-agent env interface (parity: multi_agent_env.py).

    Subclasses define:
      possible_agents: list[str]
      observation_spaces / action_spaces: {agent_id: space}
      reset(seed) -> (obs_dict, info_dict)
      step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)
        where terminateds/truncateds carry an "__all__" key.
    """

    possible_agents: list[str] = []
    observation_spaces: dict = {}
    action_spaces: dict = {}

    def reset(self, *, seed=None, options=None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    def close(self):
        pass


class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv, batching the policy forwards per policy id.

    `modules` maps policy id -> module spec; `policy_mapping_fn` (agent id
    -> policy id) routes agents onto policies, several agents sharing one
    policy where it maps them so (the reference's
    `config.multi_agent(policies=..., policy_mapping_fn=...)`). The
    mapping function travels to runner actors by pickle: a module-level
    function, not a lambda, where the runtime lacks cloudpickle.
    """

    def __init__(self, env_maker, modules: dict, policy_mapping_fn,
                 seed: int = 0, env_config: dict | None = None):
        self.env = env_maker(**(env_config or {}))
        self.agents = list(self.env.possible_agents)
        self.modules = modules
        self.mapping = {aid: policy_mapping_fn(aid) for aid in self.agents}
        # policy id -> its agents, in a stable order
        self.policy_agents: dict[str, list[str]] = {}
        for aid in self.agents:
            self.policy_agents.setdefault(self.mapping[aid], []).append(aid)
        unknown = set(self.mapping.values()) - set(modules)
        if unknown:
            raise ValueError(f"policy_mapping_fn routed to unknown "
                             f"policies {sorted(unknown)}")
        self._gen = torch.Generator().manual_seed(int(seed))
        obs, _ = self.env.reset(seed=seed)
        self._obs = obs
        self._ep_ret = 0.0
        self._ep_len = 0
        self.completed_returns: list[float] = []
        self.completed_lengths: list[int] = []

    def _stack(self, pid: str) -> np.ndarray:
        return np.stack([np.asarray(self._obs[a], np.float32).ravel()
                         for a in self.policy_agents[pid]])

    def _explore(self, pid, params, obs):
        """-> (actions, logp, values) as numpy."""
        a, logp, v = self.modules[pid].forward_exploration(
            params[pid], torch.from_numpy(obs), self._gen)
        return a.numpy(), logp.numpy(), v.numpy()

    @torch.no_grad()
    def sample(self, params: dict, num_steps: int) -> dict:
        """Collect per-policy [T, n_agents, ...] fragments: {policy_id:
        fragment} with the keys PPO's GAE reads (obs, actions, logp,
        values, rewards, dones, bootstrap, last_values)."""
        params = {pid: _cpu_params(p) for pid, p in params.items()}
        T = num_steps
        bufs = {}
        for pid, agents in self.policy_agents.items():
            n = len(agents)
            d = self._stack(pid).shape[-1]
            bufs[pid] = {
                "obs": np.empty((T, n, d), np.float32),
                "actions": np.empty((T, n), np.int64),
                "logp": np.empty((T, n), np.float32),
                "values": np.empty((T, n), np.float32),
                "rewards": np.empty((T, n), np.float32),
                "dones": np.empty((T, n), np.float32),
                # the post-step state's value at episode boundaries: zero
                # for terminations, V(final next obs) for truncations (the
                # GAE bootstrap: a truncated episode is not cut to zero)
                "bootstrap": np.zeros((T, n), np.float32),
            }
        for t in range(T):
            action_dict = {}
            for pid, agents in self.policy_agents.items():
                obs_b = self._stack(pid)
                act, logp, val = self._explore(pid, params, obs_b)
                b = bufs[pid]
                b["obs"][t] = obs_b
                b["actions"][t] = act
                b["logp"][t] = logp
                b["values"][t] = val
                for i, aid in enumerate(agents):
                    action_dict[aid] = act[i]
            nxt, rew, term, trunc, _ = self.env.step(action_dict)
            done_all = bool(term.get("__all__")) or bool(trunc.get("__all__"))
            term_all = bool(term.get("__all__"))
            for pid, agents in self.policy_agents.items():
                b = bufs[pid]
                for i, aid in enumerate(agents):
                    b["rewards"][t, i] = rew.get(aid, 0.0)
                    b["dones"][t, i] = float(done_all)
            self._ep_ret += sum(rew.values())
            self._ep_len += 1
            if done_all:
                if not term_all:
                    # truncated, not terminated: bootstrap with the value
                    # of the final next obs, read before the reset
                    self._obs = nxt
                    for pid in self.policy_agents:
                        bufs[pid]["bootstrap"][t] = self._explore(
                            pid, params, self._stack(pid))[2]
                self.completed_returns.append(self._ep_ret)
                self.completed_lengths.append(self._ep_len)
                self._ep_ret, self._ep_len = 0.0, 0
                nxt, _ = self.env.reset()
            self._obs = nxt
        for pid in self.policy_agents:
            bufs[pid]["last_values"] = self._explore(
                pid, params, self._stack(pid))[2]
        return bufs

    def get_metrics(self) -> dict:
        return {
            "episode_return_mean": (
                float(np.mean(self.completed_returns[-100:]))
                if self.completed_returns else float("nan")),
            "episode_len_mean": (
                float(np.mean(self.completed_lengths[-100:]))
                if self.completed_lengths else float("nan")),
            "num_episodes": len(self.completed_returns),
        }

    def ping(self):
        return "ok"


class MultiAgentEnvRunnerGroup(RunnerGroupBase):
    """Local (num_env_runners == 0) or remote multi-agent runners; dispatch,
    fault replacement, metric aggregation and stop come from
    RunnerGroupBase."""

    runner_cls = MultiAgentEnvRunner

    def __init__(self, env_maker, modules, policy_mapping_fn, *,
                 num_env_runners: int = 0, seed: int = 0,
                 env_config: dict | None = None,
                 restart_failed: bool = True):
        self._init_runners(
            (env_maker, modules, policy_mapping_fn),
            dict(env_config=env_config),
            num_env_runners=num_env_runners, seed=seed,
            restart_failed=restart_failed)
