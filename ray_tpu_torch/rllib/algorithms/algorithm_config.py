"""AlgorithmConfig: fluent builder for RL algorithms, counterpart of the
JAX package's `rllib/algorithms/algorithm_config.py` (the
`.environment().env_runners().training().learners()` chain) with the same
sections, defaults and `_compat` shims. One addition: `learners(device=)`
names where the learners, and the on-card envs with their training
iterations, run: "cuda" unless the caller asks for "cpu".
"""

from __future__ import annotations

import copy


class AlgorithmConfig:
    def __init__(self, algo_class=None):
        self.algo_class = algo_class
        # environment
        self.env: str | None = None
        self.env_config: dict = {}
        # env runners
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 1
        self.rollout_fragment_length: int = 128
        self.restart_failed_env_runners: bool = True
        # training (common)
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.train_batch_size: int = 512
        self.minibatch_size: int = 128
        self.num_epochs: int = 4
        self.grad_clip: float | None = 0.5
        self.model: dict = {"hidden": (64, 64)}
        # learners
        self.num_learners: int = 0
        self.device: str = "cuda"
        # debugging
        self.seed: int = 0
        # algo-specific keys land via .training(**kwargs)
        self._extra: dict = {}

    # ---- fluent sections (each returns self) ----

    def environment(self, env=None, *, env_config=None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None,
                    restart_failed_env_runners=None, **_compat):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if restart_failed_env_runners is not None:
            self.restart_failed_env_runners = restart_failed_env_runners
        return self

    def training(self, *, lr=None, gamma=None, train_batch_size=None,
                 minibatch_size=None, num_epochs=None, grad_clip=None,
                 model=None, **algo_specific):
        if lr is not None:
            self.lr = lr
        if gamma is not None:
            self.gamma = gamma
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        if minibatch_size is not None:
            self.minibatch_size = minibatch_size
        if num_epochs is not None:
            self.num_epochs = num_epochs
        if grad_clip is not None:
            self.grad_clip = grad_clip
        if model is not None:
            self.model.update(model)
        self._extra.update(algo_specific)
        return self

    def learners(self, *, num_learners=None, device=None, **_compat):
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed=None, **_compat):
        if seed is not None:
            self.seed = seed
        return self

    def framework(self, *_a, **_k):  # parity shim: one framework
        return self

    def resources(self, **_compat):  # parity shim
        return self

    def __getattr__(self, name):
        extra = self.__dict__.get("_extra")
        if extra is not None and name in extra:
            return extra[name]
        raise AttributeError(name)

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if k not in ("algo_class", "_extra")}
        d.update(self._extra)
        return d

    def build_algo(self):
        if self.algo_class is None:
            raise ValueError("config has no algo_class bound")
        return self.algo_class(self)

    build = build_algo  # parity alias
