"""Atari-class envs, a copy of the JAX package's `rllib/env/atari.py`.

- `AtariClassEnv` and `register_atari_class()`: `AtariClass<Game>-v0`
  wraps each built-in MinAtar game and renders its state into the
  deepmind observation contract, 84x84x4 float32 frame stacks, so policy
  networks, learner compute and rollout bandwidth match the ALE benchmark
  shape while the dynamics stay ROM-free. This is the path the RL phases
  of `chip_smoke.py` run (with its on-card twin in `env/device_env.py`).
- `register_atari`: only its contract. The reference registers the real
  ALE game in gymnasium's deepmind wrappers where ale-py is importable;
  neither the test box nor the card's machine has ale-py or ROMs.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.env.base import Box, Env


class AtariClassEnv(Env):
    """Deepmind-preprocessed view of a MinAtar core: the 10x10xC state
    renders into an 84x84 grayscale frame (8x nearest-neighbour upscale,
    channels weighted into intensities), stacked over the last 4 frames
    -> obs [84, 84, 4] float32 in [0, 1]."""

    SCREEN = 84

    def __init__(self, core_cls, render_mode=None, **kw):
        self.core = core_cls(**kw)
        s = self.SCREEN
        self.observation_space = Box(0.0, 1.0, (s, s, 4), np.float32)
        self.action_space = self.core.action_space
        self._frames = np.zeros((s, s, 4), np.float32)

    def _render(self, obs10) -> np.ndarray:
        # channel weights spread entity types across gray levels
        weights = np.linspace(1.0, 0.4, obs10.shape[-1], dtype=np.float32)
        gray = np.max(obs10 * weights, axis=-1)   # [10, 10]
        up = np.kron(gray, np.ones((8, 8), np.float32))  # [80, 80]
        frame = np.zeros((self.SCREEN, self.SCREEN), np.float32)
        frame[2:82, 2:82] = up
        return frame

    def reset(self, *, seed=None, options=None):
        obs, info = self.core.reset(seed=seed, options=options)
        frame = self._render(obs)
        self._frames = np.repeat(frame[:, :, None], 4, axis=2)
        return self._frames.copy(), info

    def step(self, action):
        obs, rew, term, trunc, info = self.core.step(action)
        self._frames = np.concatenate(
            [self._frames[:, :, 1:], self._render(obs)[:, :, None]], axis=2)
        return self._frames.copy(), rew, term, trunc, info


_CLASS_REGISTERED = False


def register_atari_class():
    """Register AtariClass{Breakout,SpaceInvaders,Asterix,Freeway,
    Seaquest}-v0 in the port's registry (idempotent)."""
    global _CLASS_REGISTERED
    if _CLASS_REGISTERED:
        return
    _CLASS_REGISTERED = True
    from ray_tpu_torch.rllib.env import minatar as m
    from ray_tpu_torch.rllib.env.base import register
    for game, cls in (("Breakout", m.MinAtarBreakout),
                      ("SpaceInvaders", m.MinAtarSpaceInvaders),
                      ("Asterix", m.MinAtarAsterix),
                      ("Freeway", m.MinAtarFreeway),
                      ("Seaquest", m.MinAtarSeaquest)):
        register(f"AtariClass{game}-v0", AtariClassEnv, core_cls=cls)


def ale_available() -> bool:
    try:
        import ale_py  # noqa: F401
        return True
    except ImportError:
        return False


def register_atari(game: str = "Breakout") -> str:
    """The JAX package's `<game>Deepmind-v0` (the ALE game in gymnasium's
    deepmind wrappers). Without ale-py it raises, naming the built-in ids,
    as the reference does; with it the port has no ALE path yet (neither
    the test box nor the card's machine has ale-py or ROMs)."""
    if not ale_available():
        raise RuntimeError(
            "Atari environments need ale-py (pip install "
            "'gymnasium[atari]'); at test scale use the built-in "
            "MinAtarBreakout-v0 / AtariClassBreakout-v0 instead")
    raise NotImplementedError(
        f"{game}Deepmind-v0 through ale-py is not ported (ROADMAP queue 1 "
        f"item 10); AtariClass{game}-v0 keeps its frame shape ROM-free")
