"""The port's small env base: spaces, a registry of the built-in ids and a
synchronous vector env.

The JAX package's envs subclass gymnasium's (`rllib/env/minatar.py`,
`atari.py`) and its runners step `gym.make_vec` vectors. The card's
machine may lack gymnasium, so the built-in ids (MinAtar*, AtariClass*)
live here without it:
- `Box` and `Discrete`: the two spaces the built-in games use (shape,
  bounds, `n`, `contains`; `Discrete.sample`).
- `make(env_id)`, `make_vec(env_id, num_envs)`: a built-in id from the
  registry; any other id through gymnasium, imported on use (an
  `ImportError` names it when it is missing).
- `SyncVectorEnv`: gymnasium's `SyncVectorEnv` under
  `AutoresetMode.SAME_STEP`, as the JAX package's runner asks for it:
  `reset(seed=s)` seeds sub-env i with s + i, and a sub-env that ends in
  `step` is reset at once, its reset obs returned in that step's row.
"""

from __future__ import annotations

import numpy as np


class Box:
    """A bounded array space (gymnasium's `Box` for what the games use)."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and np.can_cast(x.dtype, self.dtype)
                and bool(np.all(x >= self.low))
                and bool(np.all(x <= self.high)))

    def __repr__(self):
        return (f"Box({self.low.min()}, {self.high.max()}, {self.shape}, "
                f"{self.dtype})")


class Discrete:
    """Actions 0..n-1 (gymnasium's `Discrete` with start 0)."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)
        self._rng = np.random.default_rng()

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == () and np.issubdtype(x.dtype, np.integer)
                and 0 <= int(x) < self.n)

    def sample(self) -> np.int64:
        return np.int64(self._rng.integers(self.n))

    def __repr__(self):
        return f"Discrete({self.n})"


class Env:
    """What a built-in env provides: `observation_space`, `action_space`,
    `reset(seed=, options=) -> (obs, info)` and `step(action) -> (obs,
    reward, terminated, truncated, info)`."""

    def close(self):
        pass


_REGISTRY: dict[str, tuple[type, dict]] = {}


def register(env_id: str, entry_point: type, **kwargs) -> None:
    _REGISTRY.setdefault(env_id, (entry_point, kwargs))


def is_builtin(env_id: str) -> bool:
    from ray_tpu_torch.rllib.env.minatar import register_builtin_envs
    register_builtin_envs()
    return env_id in _REGISTRY


def _gymnasium(env_id: str):
    try:
        import gymnasium
    except ImportError as e:
        raise ImportError(
            f"env {env_id!r} is not built into ray_tpu_torch.rllib (built "
            f"in: {sorted(_REGISTRY)}); other ids need gymnasium, which is "
            f"not installed") from e
    return gymnasium


def make(env_id: str, **kwargs):
    """One env: a built-in id from the registry, else `gymnasium.make`."""
    if is_builtin(env_id):
        cls, reg_kwargs = _REGISTRY[env_id]
        return cls(**{**reg_kwargs, **kwargs})
    return _gymnasium(env_id).make(env_id, **kwargs)


def make_vec(env_id: str, num_envs: int, **kwargs):
    """A synchronous vector env with same-step autoreset: a built-in id as
    the port's `SyncVectorEnv`, else `gymnasium.make_vec(...,
    autoreset_mode=SAME_STEP)` as the JAX package's runner makes it."""
    if is_builtin(env_id):
        return SyncVectorEnv([make(env_id, **kwargs) for _ in range(num_envs)])
    gym = _gymnasium(env_id)
    return gym.make_vec(
        env_id, num_envs=num_envs, vectorization_mode="sync",
        vector_kwargs={"autoreset_mode": gym.vector.AutoresetMode.SAME_STEP},
        **kwargs)


class SyncVectorEnv:
    """Steps `envs` in turn; rows are stacked in the single spaces' dtypes,
    rewards as float64 and the done bits as bool, as gymnasium's."""

    def __init__(self, envs: list):
        self.envs = list(envs)
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._dtype = self.single_observation_space.dtype

    def reset(self, *, seed=None, options=None):
        seeds = ([None] * self.num_envs if seed is None
                 else [seed + i for i in range(self.num_envs)])
        obs = [env.reset(seed=s, options=options)[0]
               for env, s in zip(self.envs, seeds)]
        return np.stack(obs).astype(self._dtype, copy=False), {}

    def step(self, actions):
        obs, rews, terms, truncs = [], [], [], []
        for env, a in zip(self.envs, actions):
            o, r, term, trunc, _ = env.step(a)
            if term or trunc:
                o, _ = env.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
        return (np.stack(obs).astype(self._dtype, copy=False),
                np.asarray(rews, np.float64), np.asarray(terms, np.bool_),
                np.asarray(truncs, np.bool_), {})

    def close(self):
        for env in self.envs:
            env.close()
