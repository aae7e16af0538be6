"""PyTorch port, RLlib's envs on the CPU (`ray_tpu_torch.rllib.env`)
against the JAX package's (`ray_tpu.rllib.env`).

- The five MinAtar games and AtariClass: obs, reward and the done bits
  bit for bit over 300 seeded steps of the same actions.
- The port's vector env against `gym.make_vec(..., autoreset_mode=
  SAME_STEP)` as the JAX package's runner makes it, bit for bit.
- The on-card envs (`device_env.py`, here on the CPU) stepped from states
  carried across from a JAX `VecState`: envs that are not done bit-equal,
  reset ones valid fresh states, the banked statistics equal.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.env import atari as j_atari
from ray_tpu.rllib.env import jax_env as j_env
from ray_tpu.rllib.env import minatar as j_minatar
from ray_tpu_torch.rllib.env import atari as t_atari
from ray_tpu_torch.rllib.env import base as t_base
from ray_tpu_torch.rllib.env import device_env as t_env
from ray_tpu_torch.rllib.env import minatar as t_minatar

GAMES = ("Breakout", "SpaceInvaders", "Asterix", "Freeway", "Seaquest")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small tensors in many eager steps: torch's CPU
    thread pool only adds contention with the neighbouring test workers
    (the on-card learning gate took 20x its time alone under -n 6 with
    the default pool), so the module runs on one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(game: str, atari: bool):
    jc = getattr(j_minatar, f"MinAtar{game}")
    tc = getattr(t_minatar, f"MinAtar{game}")
    if atari:
        return j_atari.AtariClassEnv(jc), t_atari.AtariClassEnv(tc)
    return jc(), tc()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("game,atari", [(g, False) for g in GAMES]
                         + [("Breakout", True), ("Seaquest", True)])
def test_games_bit_equal_over_300_steps(game, atari):
    """The same seeds and actions give the same obs, rewards and done bits
    (episodes reset unseeded on done, continuing each env's own rng)."""
    ref, port = _pair(game, atari)
    n_actions = port.action_space.n
    assert n_actions == ref.action_space.n
    _same(ref.reset(seed=3)[0], port.reset(seed=3)[0])
    actions = np.random.default_rng(0).integers(0, n_actions, 300)
    dones = 0
    for a in actions:
        ro, rr, rt, rtr, _ = ref.step(a)
        po, pr, pt, ptr, _ = port.step(a)
        _same(ro, po)
        assert (rr, rt, rtr) == (pr, pt, ptr)
        if rt or rtr:
            dones += 1
            _same(ref.reset()[0], port.reset()[0])
    if game in ("Breakout", "Seaquest"):
        assert dones > 0    # the reset path ran


def test_builtin_ids_and_atari_class_contract():
    """The built-in ids need no gymnasium; their spaces hold what they
    emit; AtariClass obs are the deepmind 84x84x4 float32 frame stacks."""
    assert len(t_minatar.MINATAR_SUITE) == 5
    for eid in t_minatar.MINATAR_SUITE:
        env = t_base.make(eid)
        obs, _ = env.reset(seed=1)
        assert env.observation_space.contains(obs)
        env.action_space.seed(0)
        stepped = 0
        for _ in range(200):
            obs, _r, term, trunc, _ = env.step(env.action_space.sample())
            assert env.observation_space.contains(obs)
            stepped += 1
            if term or trunc:
                break
        assert stepped > 3
    env = t_base.make("AtariClassSeaquest-v0")
    obs, _ = env.reset(seed=0)
    assert obs.shape == (84, 84, 4) and obs.dtype == np.float32
    o2, *_ = env.step(0)
    assert (o2[:, :, :3] == obs[:, :, 1:]).all()
    with pytest.raises(RuntimeError, match="ale-py"):
        t_atari.register_atari("Breakout")


@pytest.mark.parametrize("env_id,kw", [
    ("MinAtarBreakout-v0", {}),
    ("MinAtarSpaceInvaders-v0", {"max_steps": 40}),   # truncation resets
    ("AtariClassFreeway-v0", {"max_steps": 25}),
])
def test_vector_env_matches_gymnasium_same_step(env_id, kw):
    import gymnasium as gym
    j_minatar.register_builtin_envs()
    same_step = gym.vector.AutoresetMode.SAME_STEP
    ref = gym.make_vec(env_id, num_envs=4, vectorization_mode="sync",
                       vector_kwargs={"autoreset_mode": same_step}, **kw)
    port = t_base.make_vec(env_id, 4, **kw)
    _same(ref.reset(seed=11)[0], port.reset(seed=11)[0])
    n = port.single_action_space.n
    rng = np.random.default_rng(1)
    resets = 0
    for _ in range(120):
        a = rng.integers(0, n, 4)
        r = ref.step(a)
        p = port.step(a)
        for x, y in zip(r[:4], p[:4]):
            _same(x, y)
        resets += int(np.logical_or(p[2], p[3]).sum())
    assert resets > 0
    ref.close()
    port.close()


def test_other_ids_go_through_gymnasium_or_name_it(monkeypatch):
    vec = t_base.make_vec("CartPole-v1", 2)
    obs, _ = vec.reset(seed=0)
    assert obs.shape == (2, 4)
    vec.close()
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError, match="gymnasium"):
        t_base.make("CartPole-v1")
    # built-in ids need none
    assert t_base.make_vec("MinAtarFreeway-v0", 2).num_envs == 2


# ---- the on-card envs (here on the CPU) against the JAX package's ----

def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _port_state(jvs):
    """A JAX VecState as the port's, field for field."""
    env = jvs.env
    if isinstance(env, tuple) and not hasattr(env, "_fields"):   # AtariClass
        core, frames = env
        env = (t_env.BreakoutState(*_to_torch(tuple(core))),
               torch.from_numpy(np.array(frames)))
    else:
        env = t_env.BreakoutState(*_to_torch(tuple(env)))
    return t_env.VecState(env, *_to_torch(tuple(jvs)[1:]))


def _fresh_ok(core, frames, i, atari_env):
    """Env i of the port's state is a valid fresh Breakout state."""
    assert int(core.paddle[i]) == 5 and int(core.by[i]) == 3
    assert int(core.dy[i]) == 1 and int(core.ly[i]) == 3
    assert int(core.lx[i]) == int(core.bx[i]) and 0 <= int(core.bx[i]) < 10
    assert int(core.dx[i]) in (-1, 1) and int(core.steps[i]) == 0
    want = torch.zeros(10, 10, dtype=torch.bool)
    want[1:4] = True
    assert torch.equal(core.bricks[i], want)
    if frames is not None:
        one = t_env.BreakoutState(*(f[i:i + 1] for f in core))
        frame = atari_env._frame(atari_env.core.observe(one))[0]
        assert torch.equal(frames[i], frame[..., None].repeat(1, 1, 4))


@pytest.mark.parametrize("name", ["JaxMinAtarBreakout-v0",
                                  "JaxAtariClassBreakout-v0"])
def test_device_env_steps_from_jax_states(name):
    """150 steps: each step carries the JAX VecState across, steps both
    with the same actions, and holds the port's result to the JAX one."""
    B = 16
    jvec = j_env.make_jax_env(name, B)
    tvec = t_env.make_device_env(name, B, device="cpu")
    atari = "AtariClass" in name
    jstep = jax.jit(jvec.step)
    jvs = jvec.reset(jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(1)
    n_done = 0
    for _ in range(150):
        acts = rng.integers(0, 3, B)
        key, sk = jax.random.split(key)
        tvs = _port_state(jvs)
        _same(np.asarray(jvec.observe(jvs)), tvec.observe(tvs).numpy())
        jvs2, jrew, jdone = jstep(jvs, jnp.asarray(acts, jnp.int32), sk)
        tvs2, trew, tdone = tvec.step(tvs, torch.from_numpy(acts), gen)
        _same(np.asarray(jrew), trew.numpy())
        _same(np.asarray(jdone), tdone.numpy())
        for f in ("ep_ret", "ep_len", "done_ret_sum", "done_len_sum",
                  "done_count"):
            _same(np.asarray(getattr(jvs2, f)), getattr(tvs2, f).numpy())
        jcore = jvs2.env[0] if atari else jvs2.env
        tcore = tvs2.env[0] if atari else tvs2.env
        frames = tvs2.env[1] if atari else None
        done = np.asarray(jdone)
        for i in range(B):
            if done[i]:
                _fresh_ok(tcore, frames, i, tvec.env if atari else None)
                continue
            for jf, tf in zip(jcore, tcore):
                _same(np.asarray(jf)[i], tf[i].numpy())
            if atari:
                _same(np.asarray(jvs2.env[1])[i], frames[i].numpy())
        n_done += int(done.sum())
        jvs = jvs2
    assert n_done > 10


def test_device_env_obs_contract_and_frame_weights():
    env = t_env.make_device_env("JaxAtariClassBreakout-v0", 3, device="cpu")
    vs = env.reset(torch.Generator().manual_seed(0))
    obs = env.observe(vs)
    assert obs.shape == (3, 84, 84, 4) and obs.dtype == torch.float32
    assert float(obs.min()) >= 0.0 and float(obs.max()) <= 1.0
    vs2, _rew, _done = env.step(vs, torch.zeros(3, dtype=torch.int64),
                                torch.Generator().manual_seed(1))
    assert torch.equal(obs[..., 1], env.observe(vs2)[..., 0])
    # the frame's channel weights are the JAX twin's, bit for bit, at
    # every channel count
    for c in (3, 4, 6):
        _same(np.asarray(jnp.linspace(1.0, 0.4, c, dtype=jnp.float32)),
              t_env._linspace_f32(1.0, 0.4, c).numpy())
    with pytest.raises(ValueError, match="JaxMinAtarBreakout"):
        t_env.make_device_env("JaxPong-v0", 2, device="cpu")


def test_device_env_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_env.make_device_env("JaxMinAtarBreakout-v0", 2)


def test_device_breakout_statistics_match_numpy():
    """Random play on the batched env matches the numpy game's episode
    statistics (same dynamics, different random streams)."""
    env = t_env.make_device_env("JaxMinAtarBreakout-v0", 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    vs = env.reset(gen)
    rew_sum = 0.0
    for _ in range(200):
        a = torch.randint(0, 3, (16,), generator=gen)
        vs, rew, _done = env.step(vs, a, gen)
        rew_sum += float(rew.sum())
    ep_len = float(vs.done_len_sum / vs.done_count)
    e = t_minatar.MinAtarBreakout()
    rng = np.random.default_rng(0)
    e.reset(seed=0)
    tot, lens, cur = 0.0, [], 0
    for _ in range(200 * 16):
        _, r, t, tr, _ = e.step(int(rng.integers(0, 3)))
        tot += r
        cur += 1
        if t or tr:
            lens.append(cur)
            cur = 0
            e.reset()
    assert 0.5 * np.mean(lens) < ep_len < 2.0 * np.mean(lens)
    assert abs(rew_sum / (200 * 16) - tot / (200 * 16)) < 0.05
