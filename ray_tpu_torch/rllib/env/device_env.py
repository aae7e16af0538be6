"""On-card vectorized environments: MinAtar-class dynamics as batched
tensor code, counterpart of the JAX package's `rllib/env/jax_env.py`.

There the env is a pure jax function of one env (`reset1`, `step1`,
`obs1`) that `vmap` batches and `lax.scan` rolls out, so rollout, GAE and
the update compile into one program and observations never leave the
device. Here each env is written batched over its first dim: every state
field is a [B] tensor (int32 positions, bool bricks), the per-env
`.at[y, x].set` writes are indexing with `torch.arange(B)`, and the
auto-reset is a `torch.where` broadcast over the state tree. Nothing in
`reset`, `observe`, `step` or the rollout reads the device from the host,
so an iteration of the on-card training loops (`core/ondevice.py`) stays
free of synchronizing calls until its one metrics read.

Counterparts: `DeviceBreakout` (`JaxBreakout`), `DeviceAtariClass`
(`JaxAtariClass`), `DeviceVecEnv` (`JaxVecEnv`), `VecState`,
`build_rollout`, `make_device_env` (`make_jax_env`) and `is_device_env`
(`is_jax_env`). The env ids stay the reference's: JaxMinAtarBreakout-v0
and JaxAtariClassBreakout-v0. jax.random and torch streams differ, so the
same seed gives other episodes than the reference's; from the same state
and actions the dynamics are bit-equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ray_tpu_torch import resolve_device

_I = torch.int32
_F = torch.float32


class BreakoutState(NamedTuple):
    paddle: torch.Tensor   # [B] int32
    by: torch.Tensor       # ball y
    bx: torch.Tensor       # ball x
    dy: torch.Tensor
    dx: torch.Tensor
    ly: torch.Tensor       # trail (last ball position)
    lx: torch.Tensor
    bricks: torch.Tensor   # [B, 10, 10] bool
    steps: torch.Tensor    # [B] int32


def _fresh_bricks(n: int, size: int, device) -> torch.Tensor:
    bricks = torch.zeros((n, size, size), dtype=torch.bool, device=device)
    bricks[:, 1:4, :] = True
    return bricks


class DeviceBreakout:
    """MinAtar Breakout (`env/minatar.py` `MinAtarBreakout`) batched: paddle
    row at the bottom, three brick rows, a diagonally bouncing ball;
    reward 1 per brick; the wall regenerates when cleared; an episode ends
    when the ball drops. Channels: 0=paddle, 1=ball, 2=trail, 3=brick."""

    SIZE = 10
    num_actions = 3
    obs_shape = (10, 10, 4)
    max_steps = 1000

    def reset(self, n: int, generator, device) -> BreakoutState:
        size = self.SIZE
        bx = torch.randint(0, size, (n,), generator=generator, device=device,
                           dtype=_I)
        right = torch.rand(n, generator=generator, device=device) < 0.5
        dx = torch.where(right, 1, -1).to(_I)

        def full(v):
            return torch.full((n,), v, dtype=_I, device=device)
        return BreakoutState(
            paddle=full(size // 2), by=full(3), bx=bx, dy=full(1), dx=dx,
            ly=full(3), lx=bx.clone(), bricks=_fresh_bricks(n, size, device),
            steps=full(0))

    def observe(self, s: BreakoutState) -> torch.Tensor:
        size = self.SIZE
        n = s.paddle.shape[0]
        dev = s.paddle.device
        rows = torch.arange(n, device=dev)
        # the written values are a device tensor: a Python scalar would be
        # copied from the host, and wait for the device, on every write
        one = torch.ones(n, dtype=_F, device=dev)
        o = torch.zeros((n, size, size, 4), dtype=_F, device=dev)
        o[rows, size - 1, s.paddle.long(), 0] = one
        o[rows, s.by.long(), s.bx.long(), 1] = one
        o[rows, s.ly.long(), s.lx.long(), 2] = one
        o[..., 3] = s.bricks.to(_F)
        return o

    def step(self, s: BreakoutState, action):
        """The numpy step's where-chain in its order (side wall, ceiling,
        brick bounce and wall regeneration, paddle and english, drop) ->
        (state, reward [B] float32, done [B] bool)."""
        size = self.SIZE
        n = s.paddle.shape[0]
        rows = torch.arange(n, device=s.paddle.device)
        action = action.to(_I)
        paddle = torch.clamp(
            s.paddle + (action == 2).to(_I) - (action == 1).to(_I),
            0, size - 1)
        ly, lx = s.by, s.bx
        dy, dx = s.dy, s.dx
        ny, nx = s.by + dy, s.bx + dx
        # side walls
        hit_side = (nx < 0) | (nx >= size)
        dx = torch.where(hit_side, -dx, dx)
        nx = torch.where(hit_side, s.bx + dx, nx)
        # ceiling
        hit_ceil = ny < 0
        dy = torch.where(hit_ceil, 1, dy)
        ny = torch.where(hit_ceil, s.by + dy, ny)
        # brick
        cy = torch.clamp(ny, 0, size - 1).long()
        cx = torch.clamp(nx, 0, size - 1).long()
        cell = s.bricks[rows, cy, cx]
        brick_hit = (ny >= 0) & (ny < size) & cell
        reward = brick_hit.to(_F)
        bricks = s.bricks.clone()
        bricks[rows, cy, cx] = cell & ~brick_hit
        dy = torch.where(brick_hit, -dy, dy)
        ny = torch.where(brick_hit, s.by + dy, ny)
        # wall cleared: regenerate
        fresh = _fresh_bricks(n, size, bricks.device)
        bricks = torch.where(bricks.flatten(1).any(1)[:, None, None],
                             bricks, fresh)
        # paddle row
        at_row = ny == size - 1
        on_paddle = at_row & (nx == paddle)
        dy = torch.where(on_paddle, -1, dy)
        ny = torch.where(on_paddle, s.by + dy, ny)
        # english: moving into the paddle mirrors dx
        dx = torch.where(on_paddle & (action == 1), -1,
                         torch.where(on_paddle & (action == 2), 1, dx))
        terminated = at_row & ~on_paddle
        steps = s.steps + 1
        truncated = steps >= self.max_steps
        s2 = BreakoutState(
            paddle=paddle, by=torch.clamp(ny, 0, size - 1).to(_I),
            bx=torch.clamp(nx, 0, size - 1).to(_I), dy=dy.to(_I),
            dx=dx.to(_I), ly=ly, lx=lx, bricks=bricks, steps=steps)
        return s2, reward, terminated | truncated


def _linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace's float32 values (start * (1 - s) + stop * s at s =
    i / (num - 1), the stop appended), which the JAX twin's frame weights
    are; numpy's linspace differs from them in the last bit of 0.8."""
    s = torch.arange(num - 1, dtype=_F) / (num - 1)
    w = (torch.tensor(start, dtype=_F) * (1 - s)
         + torch.tensor(stop, dtype=_F) * s)
    return torch.cat([w, torch.tensor([stop], dtype=_F)])


class DeviceAtariClass:
    """Deepmind-preprocessed view of a batched MinAtar core (the on-card
    twin of `env/atari.py` `AtariClassEnv`): each 10x10xC state renders
    into an 84x84 grayscale frame (8x nearest-neighbour upscale, channel
    weights spreading entity types over gray levels, a pad of 2), stacked
    over the last 4 frames -> obs [B, 84, 84, 4] float32 in [0, 1]. The
    state is (core state, frames)."""

    SCREEN = 84

    def __init__(self, core=None):
        self.core = core or DeviceBreakout()
        self.num_actions = self.core.num_actions
        self.obs_shape = (self.SCREEN, self.SCREEN, 4)
        self._weights = _linspace_f32(1.0, 0.4, self.core.obs_shape[-1])

    def _frame(self, core_obs):
        if self._weights.device != core_obs.device:   # once, not a step
            self._weights = self._weights.to(core_obs.device)
        gray = torch.amax(core_obs * self._weights, dim=-1)     # [B, 10, 10]
        up = gray.repeat_interleave(8, 1).repeat_interleave(8, 2)   # 80 x 80
        return torch.nn.functional.pad(up, (2, 2, 2, 2))        # [B, 84, 84]

    def reset(self, n: int, generator, device):
        cs = self.core.reset(n, generator, device)
        frame = self._frame(self.core.observe(cs))
        return (cs, frame[..., None].repeat(1, 1, 1, 4))

    def observe(self, s):
        return s[1]

    def step(self, s, action):
        cs, frames = s
        cs2, reward, done = self.core.step(cs, action)
        frame = self._frame(self.core.observe(cs2))
        frames = torch.cat([frames[..., 1:], frame[..., None]], dim=-1)
        return (cs2, frames), reward, done


class VecState(NamedTuple):
    env: object              # the env's state tree, [B] leading dims
    ep_ret: torch.Tensor     # [B] running episode return
    ep_len: torch.Tensor     # [B]
    done_ret_sum: torch.Tensor  # [] sum of completed-episode returns
    done_len_sum: torch.Tensor
    done_count: torch.Tensor


def _tree_where(done, new, old):
    """new where done else old, over a tree of NamedTuples, tuples and [B,
    ...] tensors."""
    if isinstance(old, tuple):
        vals = [_tree_where(done, a, b) for a, b in zip(new, old)]
        return type(old)(*vals) if hasattr(old, "_fields") else tuple(vals)
    return torch.where(done.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


class DeviceVecEnv:
    """Batched auto-resetting wrapper with on-card episode statistics (the
    host only ever reads three scalars)."""

    def __init__(self, env, num_envs: int, device="cuda"):
        self.env = env
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.num_actions = env.num_actions
        self.obs_shape = env.obs_shape

    def reset(self, generator) -> VecState:
        es = self.env.reset(self.num_envs, generator, self.device)
        z = torch.zeros(self.num_envs, dtype=_F, device=self.device)
        zero = torch.zeros((), dtype=_F, device=self.device)
        return VecState(env=es, ep_ret=z, ep_len=z.clone(),
                        done_ret_sum=zero, done_len_sum=zero.clone(),
                        done_count=zero.clone())

    def observe(self, vs: VecState):
        return self.env.observe(vs.env)

    def step(self, vs: VecState, actions, generator) -> tuple:
        """-> (VecState, rewards [B], dones [B]); finished episodes are
        reset in place, their statistics banked first."""
        es, rew, done = self.env.step(vs.env, actions)
        ep_ret = vs.ep_ret + rew
        ep_len = vs.ep_len + 1.0
        d = done.to(_F)
        fresh = self.env.reset(self.num_envs, generator, self.device)
        return VecState(
            env=_tree_where(done, fresh, es),
            ep_ret=ep_ret * (1.0 - d), ep_len=ep_len * (1.0 - d),
            done_ret_sum=vs.done_ret_sum + (ep_ret * d).sum(),
            done_len_sum=vs.done_len_sum + (ep_len * d).sum(),
            done_count=vs.done_count + d.sum()), rew, done


def build_rollout(vec_env: DeviceVecEnv, module, T: int):
    """A T-step on-card rollout: policy forward, env step, auto-reset,
    trajectory into [T, B, ...] buffers. Returns rollout(params, vs,
    generator) -> (vs, traj), the trajectory on the env's device."""
    B = vec_env.num_envs
    dev = vec_env.device

    @torch.no_grad()
    def rollout(params, vs: VecState, generator):
        obs_buf = torch.empty((T, B) + tuple(vec_env.obs_shape), dtype=_F,
                              device=dev)
        act = torch.empty((T, B), dtype=torch.int64, device=dev)
        logp, val, rew, done = (torch.empty((T, B), dtype=_F, device=dev)
                                for _ in range(4))
        for t in range(T):
            obs = vec_env.observe(vs)
            obs_buf[t] = obs
            a, lp, v = module.forward_exploration(params, obs, generator)
            vs, r, d = vec_env.step(vs, a, generator)
            act[t], logp[t], val[t], rew[t], done[t] = a, lp, v, r, d
        _, last_val = module.forward_train(params, vec_env.observe(vs))
        traj = {"obs": obs_buf, "actions": act, "logp": logp, "values": val,
                "rewards": rew, "dones": done, "last_values": last_val}
        return vs, traj
    return rollout


def make_device_env(name: str, num_envs: int, device="cuda") -> DeviceVecEnv:
    """The reference's names: JaxMinAtarBreakout-v0,
    JaxAtariClassBreakout-v0."""
    base = name[3:] if name.startswith("Jax") else name
    base = base.split("-")[0]
    if base == "MinAtarBreakout":
        env = DeviceBreakout()
    elif base == "AtariClassBreakout":
        env = DeviceAtariClass(DeviceBreakout())
    else:
        raise ValueError(
            f"no on-card env {name!r} (have: JaxMinAtarBreakout-v0, "
            f"JaxAtariClassBreakout-v0)")
    return DeviceVecEnv(env, num_envs, device)


def is_device_env(name: str) -> bool:
    return isinstance(name, str) and name.startswith("Jax")
