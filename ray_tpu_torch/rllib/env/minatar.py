"""The five MinAtar-style arcade games on numpy, a copy of the JAX
package's `rllib/env/minatar.py`.

From-scratch 10x10 multi-channel games in the spirit of the MinAtar suite
(Young & Tian 2019): binary-channel grids, the same action semantics,
episodic reward; small enough to step fast on CPU env runners while
exercising the conv module end to end (`rl_module.CNNActorCriticModule`).
The games subclass the port's own env base (`env/base.py`), so they need
no gymnasium; `register_builtin_envs()` puts their ids, and the
AtariClass ids of `env/atari.py`, into the port's registry:
  MinAtarBreakout-v0, MinAtarSpaceInvaders-v0, MinAtarAsterix-v0,
  MinAtarFreeway-v0, MinAtarSeaquest-v0
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.env import base as spaces
from ray_tpu_torch.rllib.env.base import Env as _EnvBase


class MinAtarBreakout(_EnvBase):
    """10x10 Breakout: paddle row at the bottom, three brick rows at the
    top, a diagonally bouncing ball. Channels: 0=paddle, 1=ball, 2=trail,
    3=brick. Actions: 0=noop, 1=left, 2=right. Reward 1 per brick; the
    wall regenerates when cleared; episode ends when the ball drops."""

    metadata = {"render_modes": []}
    SIZE = 10

    def __init__(self, render_mode=None, max_steps: int = 1000):
        n = self.SIZE
        self.observation_space = spaces.Box(0.0, 1.0, (n, n, 4),
                                            np.float32)
        self.action_space = spaces.Discrete(3)
        self.max_steps = max_steps
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        n = self.SIZE
        self.paddle = n // 2
        self.bricks = np.zeros((n, n), np.bool_)
        self.bricks[1:4, :] = True
        self.ball_y = 3
        self.ball_x = int(self._rng.integers(0, n))
        self.dy = 1
        self.dx = 1 if self._rng.random() < 0.5 else -1
        self.last_y, self.last_x = self.ball_y, self.ball_x
        self.steps = 0
        return self._obs(), {}

    def _obs(self):
        n = self.SIZE
        o = np.zeros((n, n, 4), np.float32)
        o[n - 1, self.paddle, 0] = 1.0
        o[self.ball_y, self.ball_x, 1] = 1.0
        o[self.last_y, self.last_x, 2] = 1.0
        o[:, :, 3] = self.bricks
        return o

    def step(self, action):
        n = self.SIZE
        self.steps += 1
        if action == 1:
            self.paddle = max(0, self.paddle - 1)
        elif action == 2:
            self.paddle = min(n - 1, self.paddle + 1)
        self.last_y, self.last_x = self.ball_y, self.ball_x
        ny, nx = self.ball_y + self.dy, self.ball_x + self.dx
        reward = 0.0
        terminated = False
        if nx < 0 or nx >= n:  # side wall
            self.dx = -self.dx
            nx = self.ball_x + self.dx
        if ny < 0:  # ceiling
            self.dy = 1
            ny = self.ball_y + self.dy
        if 0 <= ny < n and self.bricks[ny, nx]:
            self.bricks[ny, nx] = False
            reward = 1.0
            self.dy = -self.dy
            ny = self.ball_y + self.dy
            if not self.bricks.any():  # wall cleared: regenerate
                self.bricks[1:4, :] = True
        if ny == n - 1:  # paddle row
            if nx == self.paddle:
                self.dy = -1
                ny = self.ball_y + self.dy
                # English: moving into the paddle edge mirrors dx.
                if action == 1:
                    self.dx = -1
                elif action == 2:
                    self.dx = 1
            else:
                terminated = True
        self.ball_y = int(np.clip(ny, 0, n - 1))
        self.ball_x = int(np.clip(nx, 0, n - 1))
        truncated = self.steps >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}


class MinAtarSpaceInvaders(_EnvBase):
    """10x10 Space Invaders: a 4x6 alien block marching side-to-side and
    down, a cannon on the bottom row. Channels: 0=cannon, 1=alien,
    2=alien bullet, 3=friendly bullet. Actions: 0=noop, 1=left, 2=right,
    3=fire. Reward 1 per alien; new wave on clear; episode ends when a
    bullet hits the cannon or aliens reach the bottom row."""

    metadata = {"render_modes": []}
    SIZE = 10

    def __init__(self, render_mode=None, max_steps: int = 1000):
        n = self.SIZE
        self.observation_space = spaces.Box(0.0, 1.0, (n, n, 4),
                                            np.float32)
        self.action_space = spaces.Discrete(4)
        self.max_steps = max_steps
        self._rng = np.random.default_rng(0)

    def _spawn_wave(self):
        self.aliens = np.zeros((self.SIZE, self.SIZE), np.bool_)
        self.aliens[1:5, 2:8] = True
        self.adx = 1
        self.move_timer = 0

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.cannon = self.SIZE // 2
        self._spawn_wave()
        self.enemy_shots: list[list[int]] = []  # [y, x]
        self.my_shot = None  # [y, x] — one in flight at a time
        self.steps = 0
        return self._obs(), {}

    def _obs(self):
        n = self.SIZE
        o = np.zeros((n, n, 4), np.float32)
        o[n - 1, self.cannon, 0] = 1.0
        o[:, :, 1] = self.aliens
        for y, x in self.enemy_shots:
            o[y, x, 2] = 1.0
        if self.my_shot is not None:
            o[self.my_shot[0], self.my_shot[1], 3] = 1.0
        return o

    def step(self, action):
        n = self.SIZE
        self.steps += 1
        reward = 0.0
        terminated = False
        if action == 1:
            self.cannon = max(0, self.cannon - 1)
        elif action == 2:
            self.cannon = min(n - 1, self.cannon + 1)
        elif action == 3 and self.my_shot is None:
            self.my_shot = [n - 2, self.cannon]

        # Friendly bullet rises; hit removes an alien.
        if self.my_shot is not None:
            self.my_shot[0] -= 1
            y, x = self.my_shot
            if y < 0:
                self.my_shot = None
            elif self.aliens[y, x]:
                self.aliens[y, x] = False
                reward = 1.0
                self.my_shot = None
                if not self.aliens.any():
                    self._spawn_wave()

        # Alien block marches every other step; edge -> drop a row.
        self.move_timer += 1
        if self.move_timer % 2 == 0 and self.aliens.any():
            cols = np.flatnonzero(self.aliens.any(axis=0))
            if (self.adx > 0 and cols[-1] == n - 1) or \
               (self.adx < 0 and cols[0] == 0):
                self.aliens = np.roll(self.aliens, 1, axis=0)
                self.adx = -self.adx
                if self.aliens[n - 1].any():
                    terminated = True  # invasion
            else:
                self.aliens = np.roll(self.aliens, self.adx, axis=1)

        # Random alien fire from a bottom-most alien.
        if self.aliens.any() and self._rng.random() < 0.2:
            col = int(self._rng.choice(np.flatnonzero(
                self.aliens.any(axis=0))))
            row = int(np.flatnonzero(self.aliens[:, col])[-1])
            self.enemy_shots.append([row + 1, col])

        nxt = []
        for y, x in self.enemy_shots:
            y += 1
            if y == n - 1 and x == self.cannon:
                terminated = True
            elif y < n:
                nxt.append([y, x])
        self.enemy_shots = nxt

        truncated = self.steps >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}


class MinAtarAsterix(_EnvBase):
    """10x10 Asterix: the hero moves in four directions; enemies and
    treasure slide horizontally across rows 1..8, spawning at a fixed
    cadence. Channels: 0=hero, 1=treasure, 2=enemy, 3=motion trail.
    Actions: 0=noop, 1=left, 2=right, 3=up, 4=down. Reward 1 per
    treasure; touching an enemy ends the episode."""

    metadata = {"render_modes": []}
    SIZE = 10

    def __init__(self, render_mode=None, max_steps: int = 1000):
        n = self.SIZE
        self.observation_space = spaces.Box(0.0, 1.0, (n, n, 4),
                                            np.float32)
        self.action_space = spaces.Discrete(5)
        self.max_steps = max_steps
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        n = self.SIZE
        self.hero = [n // 2, n // 2]
        self.entities: list[list] = []  # [y, x, dx, is_gold]
        self.steps = 0
        self.spawn_timer = 0
        return self._obs(), {}

    def _obs(self):
        n = self.SIZE
        o = np.zeros((n, n, 4), np.float32)
        o[self.hero[0], self.hero[1], 0] = 1.0
        for y, x, dx, gold in self.entities:
            o[y, x, 1 if gold else 2] = 1.0
            tx = x - dx
            if 0 <= tx < n:
                o[y, tx, 3] = 1.0
        return o

    def step(self, action):
        n = self.SIZE
        self.steps += 1
        dy, dx = [(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)][int(action)]
        self.hero[0] = int(np.clip(self.hero[0] + dy, 1, n - 2))
        self.hero[1] = int(np.clip(self.hero[1] + dx, 0, n - 1))
        reward = 0.0
        terminated = False
        self.spawn_timer += 1
        if self.spawn_timer >= 3 and len(self.entities) < 8:
            self.spawn_timer = 0
            row = int(self._rng.integers(1, n - 1))
            if not any(e[0] == row for e in self.entities):
                going_right = bool(self._rng.random() < 0.5)
                self.entities.append(
                    [row, 0 if going_right else n - 1,
                     1 if going_right else -1,
                     bool(self._rng.random() < 1 / 3)])
        nxt = []
        for y, x, edx, gold in self.entities:
            x += edx
            if x < 0 or x >= n:
                continue  # slid off
            if [y, x] == self.hero:
                if gold:
                    reward += 1.0
                    continue
                terminated = True
            nxt.append([y, x, edx, gold])
        self.entities = nxt
        truncated = self.steps >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}


class MinAtarFreeway(_EnvBase):
    """10x10 Freeway: the chicken climbs from the bottom row to the top
    across 8 traffic lanes; cars wrap around at lane-specific speeds and
    directions. Channels: 0=chicken, 1=car, 2=fast-car marker,
    3=direction marker. Actions: 0=noop, 1=up, 2=down. Reward 1 per
    crossing (chicken restarts at the bottom); a collision knocks it
    back to the start. Episodes are time-limited only."""

    metadata = {"render_modes": []}
    SIZE = 10

    def __init__(self, render_mode=None, max_steps: int = 1000):
        n = self.SIZE
        self.observation_space = spaces.Box(0.0, 1.0, (n, n, 4),
                                            np.float32)
        self.action_space = spaces.Discrete(3)
        self.max_steps = max_steps
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        n = self.SIZE
        self.chicken = n - 1
        # lanes 1..8: (x, dir, period); speed = move every `period` steps
        self.cars = []
        for lane in range(1, n - 1):
            direction = 1 if lane % 2 else -1
            period = int(self._rng.integers(1, 4))
            self.cars.append([int(self._rng.integers(0, n)), direction,
                              period])
        self.steps = 0
        return self._obs(), {}

    def _obs(self):
        n = self.SIZE
        o = np.zeros((n, n, 4), np.float32)
        o[self.chicken, n // 2, 0] = 1.0
        for lane, (x, d, period) in enumerate(self.cars, start=1):
            o[lane, x, 1] = 1.0
            if period == 1:
                o[lane, x, 2] = 1.0
            if d > 0:
                o[lane, x, 3] = 1.0
        return o

    def step(self, action):
        n = self.SIZE
        self.steps += 1
        if action == 1:
            self.chicken = max(0, self.chicken - 1)
        elif action == 2:
            self.chicken = min(n - 1, self.chicken + 1)
        for car in self.cars:
            if self.steps % car[2] == 0:
                car[0] = (car[0] + car[1]) % n
        reward = 0.0
        if self.chicken == 0:
            reward = 1.0
            self.chicken = n - 1
        elif 1 <= self.chicken <= n - 2:
            car = self.cars[self.chicken - 1]
            if car[0] == n // 2:  # chicken column is fixed at center
                self.chicken = n - 1
        truncated = self.steps >= self.max_steps
        return self._obs(), reward, False, truncated, {}


class MinAtarSeaquest(_EnvBase):
    """10x10 Seaquest: a submarine with an oxygen budget hunts fish with
    torpedoes and must surface (row 0) to refill. Channels: 0=sub,
    1=fish, 2=torpedo, 3=oxygen gauge (bottom row fill). Actions:
    0=noop, 1=left, 2=right, 3=up, 4=down, 5=fire. Reward 1 per fish;
    running out of oxygen or touching a fish ends the episode."""

    metadata = {"render_modes": []}
    SIZE = 10
    MAX_O2 = 60

    def __init__(self, render_mode=None, max_steps: int = 1000):
        n = self.SIZE
        self.observation_space = spaces.Box(0.0, 1.0, (n, n, 4),
                                            np.float32)
        self.action_space = spaces.Discrete(6)
        self.max_steps = max_steps
        self._rng = np.random.default_rng(0)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        n = self.SIZE
        self.sub = [n // 2, n // 2]
        self.fish: list[list] = []       # [y, x, dx]
        self.torps: list[list] = []      # [y, x, dx]
        self.o2 = self.MAX_O2
        self.facing = 1
        self.steps = 0
        return self._obs(), {}

    def _obs(self):
        n = self.SIZE
        o = np.zeros((n, n, 4), np.float32)
        o[self.sub[0], self.sub[1], 0] = 1.0
        for y, x, _d in self.fish:
            o[y, x, 1] = 1.0
        for y, x, _d in self.torps:
            o[y, x, 2] = 1.0
        fill = int(round(self.o2 / self.MAX_O2 * (n - 1)))
        o[n - 1, :fill + 1, 3] = 1.0
        return o

    def step(self, action):
        n = self.SIZE
        self.steps += 1
        reward = 0.0
        terminated = False
        a = int(action)
        if a == 1:
            self.sub[1] = max(0, self.sub[1] - 1)
            self.facing = -1
        elif a == 2:
            self.sub[1] = min(n - 1, self.sub[1] + 1)
            self.facing = 1
        elif a == 3:
            self.sub[0] = max(0, self.sub[0] - 1)
        elif a == 4:
            self.sub[0] = min(n - 2, self.sub[0] + 1)  # row n-1 = gauge
        elif a == 5 and len(self.torps) < 3:
            self.torps.append([self.sub[0], self.sub[1], self.facing])
        # oxygen: refill on the surface row, deplete below it
        if self.sub[0] == 0:
            self.o2 = self.MAX_O2
        else:
            self.o2 -= 1
            if self.o2 <= 0:
                terminated = True
        if self.steps % 4 == 0 and len(self.fish) < 6:
            row = int(self._rng.integers(1, n - 2))
            going_right = bool(self._rng.random() < 0.5)
            self.fish.append([row, 0 if going_right else n - 1,
                              1 if going_right else -1])
        nxt_t = []
        for y, x, d in self.torps:
            x += d
            if not 0 <= x < n:
                continue
            hit = [f for f in self.fish if f[0] == y and f[1] == x]
            if hit:
                self.fish = [f for f in self.fish if f not in hit]
                reward += float(len(hit))
                continue
            nxt_t.append([y, x, d])
        self.torps = nxt_t
        nxt_f = []
        for y, x, d in self.fish:
            if self.steps % 2 == 0:
                x += d
            if not 0 <= x < n:
                continue
            if [y, x] == self.sub:
                terminated = True
            hit = [t for t in self.torps if t[0] == y and t[1] == x]
            if hit:
                self.torps = [t for t in self.torps if t not in hit]
                reward += 1.0
                continue
            nxt_f.append([y, x, d])
        self.fish = nxt_f
        truncated = self.steps >= self.max_steps
        return self._obs(), reward, terminated, truncated, {}


_REGISTERED = False

MINATAR_SUITE = ("MinAtarBreakout-v0", "MinAtarSpaceInvaders-v0",
                 "MinAtarAsterix-v0", "MinAtarFreeway-v0",
                 "MinAtarSeaquest-v0")


def register_builtin_envs():
    """Idempotently register the built-in envs in the port's registry
    (`base.make` and `base.make_vec` call it before they look an id up)."""
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    from ray_tpu_torch.rllib.env.atari import register_atari_class
    from ray_tpu_torch.rllib.env.base import register
    for name, cls in (("MinAtarBreakout-v0", MinAtarBreakout),
                      ("MinAtarSpaceInvaders-v0", MinAtarSpaceInvaders),
                      ("MinAtarAsterix-v0", MinAtarAsterix),
                      ("MinAtarFreeway-v0", MinAtarFreeway),
                      ("MinAtarSeaquest-v0", MinAtarSeaquest)):
        register(name, cls)
    register_atari_class()
