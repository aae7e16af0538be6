"""Multi-agent PPO: per-policy modules and learners over a MultiAgentEnv,
counterpart of the JAX package's `rllib/algorithms/multi_agent_ppo.py`
(parity: the reference's multi-agent training, `config.multi_agent(
policies=..., policy_mapping_fn=...)` with one RLModule per policy and
per-module losses in the learner).

Each policy has its own `Learner` on `config.device`; GAE and the loss are
`ppo.py`'s. Several agents mapped onto one policy share its parameters.
"""

from __future__ import annotations

import functools
import os
import pickle
import time

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.ppo import _gae, ppo_loss
from ray_tpu_torch.rllib.core.learner import Learner, as_tensor
from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunnerGroup


def agent_as_policy(agent_id):
    """The default policy mapping: each agent its own policy. A
    module-level function, so runner actors unpickle it by name."""
    return agent_id


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=MultiAgentPPO)
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.lambda_ = 0.95
        self.policies: list[str] | None = None
        self.policy_mapping_fn = None

    def multi_agent(self, *, policies=None, policy_mapping_fn=None):
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, lambda_=None, **kw):
        super().training(**kw)
        for k, v in (("clip_param", clip_param),
                     ("vf_loss_coeff", vf_loss_coeff),
                     ("entropy_coeff", entropy_coeff),
                     ("lambda_", lambda_)):
            if v is not None:
                setattr(self, k, v)
        return self


class MultiAgentPPO:
    """Trainable over {policy_id: module and learner}; config.env is a
    MultiAgentEnv class or factory."""

    def __init__(self, config: MultiAgentPPOConfig):
        c = self.config = config
        if c.env is None or not callable(c.env):
            raise ValueError("config.environment(env=...) must be a "
                             "MultiAgentEnv class/factory for MultiAgentPPO")
        probe = c.env(**c.env_config)
        mapping = c.policy_mapping_fn or agent_as_policy
        policies = c.policies or sorted(
            {mapping(a) for a in probe.possible_agents})
        self.policies = policies
        hidden = tuple(c.model.get("hidden", (64, 64)))
        self.modules = {}
        for pid in policies:
            # the module's shapes come from any agent mapped onto it
            aid = next((a for a in probe.possible_agents
                        if mapping(a) == pid), None)
            if aid is None:
                raise ValueError(
                    f"policy {pid!r} is listed in config.policies but "
                    f"policy_mapping_fn routes no agent to it "
                    f"(agents: {probe.possible_agents})")
            obs_dim = int(np.prod(probe.observation_spaces[aid].shape))
            n_act = int(probe.action_spaces[aid].n)
            self.modules[pid] = ActorCriticModule(obs_dim, n_act, hidden)
        probe.close()
        loss_cfg = {"clip": c.clip_param, "vf_coef": c.vf_loss_coeff,
                    "ent_coef": c.entropy_coeff}
        self.learners = {
            pid: Learner(m, functools.partial(ppo_loss, module=m),
                         lr=c.lr, grad_clip=c.grad_clip,
                         seed=c.seed + i, loss_cfg=loss_cfg,
                         device=c.device)
            for i, (pid, m) in enumerate(self.modules.items())}
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            c.env, self.modules, mapping,
            num_env_runners=c.num_env_runners, seed=c.seed,
            env_config=c.env_config,
            restart_failed=c.restart_failed_env_runners)
        self.iteration = 0
        self._timesteps = 0

    def get_weights(self) -> dict:
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def _advantages(self, f: dict, device) -> None:
        """GAE of one policy's [T, n] fragment, in place (numpy)."""
        c = self.config
        adv, ret = _gae(
            *(as_tensor(f[k], device) for k in
              ("rewards", "values", "dones", "last_values")),
            gamma=c.gamma, lam=c.lambda_,
            bootstrap=as_tensor(f["bootstrap"], device))
        f["advantages"], f["returns"] = torch.stack([adv, ret]).cpu().numpy()

    def training_step(self) -> dict:
        c = self.config
        params = self.get_weights()
        frag_lists = []
        for _attempt in range(10):
            # a round comes back empty when every remote runner died and
            # was replaced: sample again from the new ones
            frag_lists = self.env_runner_group.sample(
                params, c.rollout_fragment_length)
            if frag_lists:
                break
        if not frag_lists:
            raise RuntimeError(
                "multi-agent sample returned no fragments after 10 rounds "
                "of env-runner replacement")
        metrics = {}
        rng = np.random.default_rng(self.iteration)
        for pid in self.policies:
            learner = self.learners[pid]
            parts = [fl[pid] for fl in frag_lists]
            for f in parts:
                self._advantages(f, learner.device)
                self._timesteps += f["rewards"].size
            batch = {k: np.concatenate(
                [p[k].reshape(-1, *p[k].shape[2:]) for p in parts])
                for k in ("obs", "actions", "logp", "advantages",
                          "returns")}
            adv = batch["advantages"]
            batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
            n = batch["obs"].shape[0]
            for _ in range(c.num_epochs):
                perm = rng.permutation(n)
                for s in range(0, n, c.minibatch_size):
                    idx = perm[s:s + c.minibatch_size]
                    if len(idx) < 2:
                        continue
                    m = learner.update({k: v[idx] for k, v in batch.items()})
                    metrics.update({f"{pid}/{k}": v for k, v in m.items()})
        return metrics

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

    def save_to_path(self, path: str):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump({"weights": self.get_weights(),
                         "iteration": self.iteration,
                         "timesteps": self._timesteps}, f)
        return path

    def restore_from_path(self, path: str):
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        for pid, w in state["weights"].items():
            self.learners[pid].set_weights(w)
        self.iteration = state["iteration"]
        self._timesteps = state["timesteps"]

    def stop(self):
        self.env_runner_group.stop()
