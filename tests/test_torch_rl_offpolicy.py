"""PyTorch port, RLlib's off-policy half on the CPU (`ray_tpu_torch.rllib`:
the replay buffer, `Algorithm._replay_rows`, DQN, SAC and CQL) against the
JAX package's (`ray_tpu.rllib`), in one process (`JAX_PLATFORMS=cpu`), on
inputs made with numpy from a seed and weights carried by
`params_from_numpy`.

Tolerances, stated per check: the replay buffer and `_replay_rows`
bit-equal (both numpy); `dqn_loss` and its gradients against
`jax.value_and_grad` 1e-5; one fused SAC and CQL update, the noise fed
(the normals and uniforms JAX draws from the keys its update splits),
1e-5 on the metrics and 1e-5 on the params, targets and alpha after the
Adam steps. The Pendulum twin that the card's script uses in place of
gymnasium's Pendulum-v1 is held against it step for step (1e-6).
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu.rllib.algorithms import algorithm as j_algorithm
from ray_tpu.rllib.algorithms import cql as j_cql
from ray_tpu.rllib.algorithms import dqn as j_dqn
from ray_tpu.rllib.algorithms import sac as j_sac
from ray_tpu.rllib.core import rl_module as j_mod
from ray_tpu.rllib.utils import replay_buffer as j_replay
from ray_tpu_torch.rllib.algorithms import algorithm as t_algorithm
from ray_tpu_torch.rllib.algorithms import cql as t_cql
from ray_tpu_torch.rllib.algorithms import dqn as t_dqn
from ray_tpu_torch.rllib.algorithms import sac as t_sac
from ray_tpu_torch.rllib.core import learner as t_learner
from ray_tpu_torch.rllib.core import rl_module as t_mod
from ray_tpu_torch.rllib.utils import replay_buffer as t_replay

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors in many eager steps: one torch thread, restored
    after (as in test_torch_rllib.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _close_trees(j, t, tol):
    jl = jax.tree_util.tree_leaves(_np(j))
    tl = t_mod.tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape
        _close(a, b, tol)


# ---- the replay buffer and the replay rows ----

def test_replay_buffer_bit_equal():
    """Adds past the capacity (the ring wraps) and samples: bit-equal."""
    jb, tb = j_replay.ReplayBuffer(50, seed=3), t_replay.ReplayBuffer(
        50, seed=3)
    rng = np.random.default_rng(1)
    for n in (20, 17, 30, 9):
        batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
                 "actions": rng.integers(0, 4, n)}
        jb.add_batch(batch)
        tb.add_batch(batch)
        assert len(jb) == len(tb)
        for a, b in ((jb.sample(16), tb.sample(16)),):
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("actions_2d", [False, True])
def test_replay_rows_bit_equal(actions_2d):
    """Truncated-not-terminated rows dropped, dones the terminations."""
    T, B = 6, 3
    rng = np.random.default_rng(2)
    dones = (rng.random((T, B)) < 0.3).astype(np.float32)
    terms = dones * (rng.random((T, B)) < 0.5)
    f = {"obs": rng.standard_normal((T, B, 4)).astype(np.float32),
         "actions": (rng.standard_normal((T, B, 2)).astype(np.float32)
                     if actions_2d else rng.integers(0, 3, (T, B))),
         "rewards": rng.standard_normal((T, B)).astype(np.float32),
         "dones": dones, "terminateds": terms.astype(np.float32),
         "final_obs": rng.standard_normal((B, 4)).astype(np.float32)}
    a = j_algorithm.Algorithm._replay_rows(f, actions_2d=actions_2d)
    b = t_algorithm.Algorithm._replay_rows(f, actions_2d=actions_2d)
    assert set(a) == set(b)
    assert len(b["obs"]) == int((~((dones > 0) & (terms == 0))).sum())
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


# ---- DQN ----

@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
def test_dqn_loss_and_grads_match_jax(double_q, dueling):
    jm = j_mod.QModule(5, 4, (32, 16), dueling=dueling)
    tm = t_mod.QModule(5, 4, (32, 16), dueling=dueling)
    jp = jm.init(jax.random.PRNGKey(1))
    jt = jm.init(jax.random.PRNGKey(2))
    n = 24
    batch = {"obs": RNG.standard_normal((n, 5)).astype(np.float32),
             "next_obs": RNG.standard_normal((n, 5)).astype(np.float32),
             "actions": RNG.integers(0, 4, n),
             "rewards": RNG.standard_normal(n).astype(np.float32),
             "dones": (RNG.random(n) < 0.3).astype(np.float32)}
    cfg = dict(gamma=0.97, double_q=double_q)
    (jl, jaux), jg = jax.value_and_grad(
        functools.partial(j_dqn.dqn_loss, module=jm, **cfg), has_aux=True)(
        jp, {**{k: jnp.asarray(v) for k, v in batch.items()},
             "target_params": jt})
    tp = t_mod.tree_map(lambda t: t.requires_grad_(True),
                        t_mod.params_from_numpy(_np(jp), "cpu"))
    tb = t_learner.to_device(
        {**batch, "target_params": _np(jt)}, torch.device("cpu"))
    tl, taux = t_dqn.dqn_loss(tp, tb, module=tm, **cfg)
    tg = torch.autograd.grad(tl, t_mod.tree_leaves(tp))
    _close(jl, tl.detach(), 1e-5)
    for k in jaux:
        _close(jaux[k], taux[k].detach(), 1e-5)
    _close_trees(jg, list(tg), 1e-5)


def test_to_device_carries_a_tree_without_copying():
    """The batch's nested tree reaches the device leaf by leaf; a tensor
    already there is the same object, not a copy."""
    tree = {"a": [torch.ones(2), {"w": torch.zeros(3)}]}
    got = t_learner.to_device({"obs": np.ones((4, 2), np.float32),
                               "target_params": tree},
                              torch.device("cpu"))
    assert got["target_params"]["a"][0] is tree["a"][0]
    assert got["target_params"]["a"][1]["w"] is tree["a"][1]["w"]
    assert torch.is_tensor(got["obs"]) and got["obs"].shape == (4, 2)


def _dqn_config(**training):
    return (t_dqn.DQNConfig().environment(env="MinAtarBreakout-v0")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=16)
            .training(num_steps_sampled_before_learning_starts=64,
                      target_network_update_freq=128, **training)
            .learners(device="cpu").debugging(seed=0))


def test_dqn_trains_and_syncs_its_target():
    """Updates start after 64 steps; the target tree stays put between
    syncs and equals the online params at each sync (every 128 steps)."""
    algo = _dqn_config(num_updates_per_iter=4).build_algo()
    try:
        r = algo.train()                      # 64 steps: updates start
        assert np.isfinite(r["total_loss"]) and "td_error_mean" in r
        before = [t.clone() for t in t_mod.tree_leaves(algo.target_params)]
        algo.train()                          # 128 steps: a sync
        online = t_mod.tree_leaves(algo.learner_group.local.params)
        synced = t_mod.tree_leaves(algo.target_params)
        assert all(torch.equal(a, b.detach()) for a, b in zip(synced, online))
        assert not all(torch.equal(a, b) for a, b in zip(before, synced))
        algo.train()                          # 192: no sync
        assert all(torch.equal(a, b) for a, b in
                   zip(synced, t_mod.tree_leaves(algo.target_params)))
        assert algo._timesteps == 192 and len(algo.buffer) > 0
    finally:
        algo.stop()


def test_dqn_refuses_learner_actors():
    with pytest.raises(ValueError, match="single learner"):
        _dqn_config().learners(num_learners=2).build_algo()


# ---- SAC and CQL: one fused update, the noise fed ----

def _pendulum_config(cfg_cls, **training):
    return (cfg_cls().environment(env="Pendulum-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=1,
                         rollout_fragment_length=32)
            .training(lr=1e-3, train_batch_size=32, **training)
            .debugging(seed=0))


def _carry_sac_state(j, t):
    """The JAX algorithm's params, targets and log alpha into the
    port's."""
    t.learner_group.set_weights(_np(j.params))
    with torch.no_grad():
        for a, b in zip(t_mod.tree_leaves(t.target_params),
                        jax.tree_util.tree_leaves(_np(j.target_params))):
            a.copy_(torch.from_numpy(np.array(b)))
        t.log_alpha.fill_(float(j.log_alpha))


def _offline_batch(n=32):
    return {"obs": RNG.standard_normal((n, 3)).astype(np.float32),
            "actions": RNG.uniform(-1.9, 1.9, (n, 1)).astype(np.float32),
            "rewards": RNG.standard_normal(n).astype(np.float32),
            "next_obs": RNG.standard_normal((n, 3)).astype(np.float32),
            "dones": (RNG.random(n) < 0.2).astype(np.float32)}


def _check_update(ja, ta, batch, jout, tm):
    (jp, jt, _o, jla, _ao, jaux) = jout
    for k in jaux:
        _close(jaux[k], tm[k], 1e-5)
    _close_trees(jp, ta.params, 1e-5)
    _close_trees(jt, ta.target_params, 1e-5)
    _close(jla, ta.log_alpha.detach(), 1e-5)


def test_sac_fused_update_matches_jax():
    """Two updates in a row (the second with Adam's moments from the
    first), the normals JAX draws from its keys fed to the port."""
    ja = _pendulum_config(j_sac.SACConfig).build_algo()
    ta = _pendulum_config(t_sac.SACConfig).learners(
        device="cpu").build_algo()
    try:
        _carry_sac_state(ja, ta)
        state = (ja.params, ja.target_params, ja.opt_state, ja.log_alpha,
                 ja.alpha_opt_state)
        for step in range(2):
            batch = _offline_batch()
            key = jax.random.PRNGKey(10 + step)
            k1, k2 = jax.random.split(key)
            noise = {"next": jax.random.normal(k1, (32, 1)),
                     "actor": jax.random.normal(k2, (32, 1))}
            jout = ja._update(*state, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, key)
            tm = t_learner.read_metrics(ta._update(
                t_learner.to_device(batch, ta.device),
                {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}))
            _check_update(ja, ta, batch, jout, tm)
            state = jout[:5]
    finally:
        ja.stop()
        ta.stop()


@pytest.mark.parametrize("bc_mode", [False, True])
def test_cql_fused_update_matches_jax(bc_mode):
    """The conservative critic (uniform and policy OOD actions, log_vol)
    and, with bc_mode, the BC warm-up actor: one update, JAX's normals and
    uniforms fed."""
    n_ood = 3
    ja = _pendulum_config(j_cql.CQLConfig, num_ood_actions=n_ood,
                          bc_iters=1).offline_data(
        input_=[{"obs": [0.0, 0.0, 0.0], "actions": [0.0], "rewards": 0.0,
                 "next_obs": [0.0, 0.0, 0.0], "dones": 0.0}]).build_algo()
    ta = _pendulum_config(t_cql.CQLConfig, num_ood_actions=n_ood,
                          bc_iters=1).offline_data(
        input_=[{"obs": [0.0, 0.0, 0.0], "actions": [0.0], "rewards": 0.0,
                 "next_obs": [0.0, 0.0, 0.0], "dones": 0.0}]).learners(
        device="cpu").build_algo()
    try:
        _carry_sac_state(ja, ta)
        batch = _offline_batch()
        key = jax.random.PRNGKey(5)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        m = ja.module
        ks = jax.random.split(k3, n_ood)
        noise = {"next": jax.random.normal(k1, (32, 1)),
                 "actor": jax.random.normal(k4, (32, 1)),
                 "rand": jax.random.uniform(
                     k2, (n_ood, 32, 1), minval=jnp.asarray(m.low),
                     maxval=jnp.asarray(m.high)),
                 "pol": jnp.stack([jax.random.normal(kk, (32, 1))
                                   for kk in ks])}
        upd = ja._update_bc if bc_mode else ja._update
        jout = upd(ja.params, ja.target_params, ja.opt_state, ja.log_alpha,
                   ja.alpha_opt_state,
                   {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tm = t_learner.read_metrics(ta._update(
            t_learner.to_device(batch, ta.device),
            {k: torch.from_numpy(np.array(v)) for k, v in noise.items()},
            bc_mode=bc_mode))
        assert set(tm) == set(jout[5])
        _check_update(ja, ta, batch, jout, tm)
    finally:
        ja.stop()
        ta.stop()


def test_cql_learns_conservatively_offline():
    """The JAX package's test through the port: CQL from recorded
    Pendulum rows, a BC warm-up iteration then conservative ones; losses
    finite and critic_loss > bellman_loss."""
    from ray_tpu_torch.rllib.env.base import make
    from ray_tpu_torch.rllib.offline import record_transitions
    module = t_mod.module_for_env(make("Pendulum-v1"), kind="sac")
    rows = record_transitions("Pendulum-v1", module, module.init(
        0, device="cpu"), num_steps=256)
    algo = (t_cql.CQLConfig().environment(env="Pendulum-v1")
            .offline_data(input_=rows)
            .training(lr=3e-4, train_batch_size=64, num_updates_per_iter=8,
                      cql_alpha=1.0, num_ood_actions=3, bc_iters=1)
            .learners(device="cpu").debugging(seed=0)).build_algo()
    try:
        for _ in range(3):
            metrics = algo.train()
        assert np.isfinite(metrics["critic_loss"])
        assert np.isfinite(metrics["actor_loss"])
        assert metrics["critic_loss"] > metrics["bellman_loss"]
        assert algo._timesteps == 3 * 8 * 64
        assert np.isfinite(algo.evaluate(64)["num_episodes"])
    finally:
        algo.stop()


def test_sac_trains_and_checkpoints_round_trip(tmp_path):
    """A few SAC iterations, then save and restore into a fresh SAC:
    params, targets, log alpha, both Adam states and the generator come
    back; the next update of both is the same."""
    config = _pendulum_config(
        t_sac.SACConfig, num_steps_sampled_before_learning_starts=32,
        num_updates_per_iter=4).learners(device="cpu")
    algo = config.build_algo()
    algo2 = config.copy().build_algo()
    try:
        for _ in range(3):
            r = algo.train()
        assert np.isfinite(r["critic_loss"]) and 0 < r["alpha"] < 1
        path = algo.save_to_path(str(tmp_path / "sac"))
        algo2.restore_from_path(path)
        for a, b in ((algo.params, algo2.params),
                     (algo.target_params, algo2.target_params)):
            for x, y in zip(t_mod.tree_leaves(a), t_mod.tree_leaves(b)):
                assert torch.equal(x, y)
        assert torch.equal(algo.log_alpha.detach(), algo2.log_alpha.detach())
        assert algo2.iteration == 3
        batch = t_learner.to_device(algo.buffer.sample(32), algo.device)
        m1 = t_learner.read_metrics(algo._update(batch))
        m2 = t_learner.read_metrics(algo2._update(batch))
        assert m1 == m2
    finally:
        algo.stop()
        algo2.stop()


@pytest.mark.parametrize("optax_installed", [True, False])
def test_sac_restores_a_jax_checkpoints_weights(tmp_path, monkeypatch,
                                                optax_installed):
    """A checkpoint of the JAX package's SAC: its weights come in; its
    optax states and key are not this package's, and are left. Where
    optax cannot be imported (the card's machine), the checkpoint still
    loads."""
    import sys
    ja = _pendulum_config(j_sac.SACConfig).build_algo()
    ta = _pendulum_config(t_sac.SACConfig).learners(
        device="cpu").build_algo()
    try:
        path = ja.save_to_path(str(tmp_path / "jax_sac"))
        if not optax_installed:
            for name in [m for m in sys.modules if m.split(".")[0] == "optax"]:
                monkeypatch.setitem(sys.modules, name, None)
            with pytest.raises(ImportError):
                import optax  # noqa: F401
        alpha = float(ta.log_alpha.detach())
        ta.restore_from_path(path)
        _close_trees(ja.params, ta.params, 0)
        assert float(ta.log_alpha.detach()) == alpha
    finally:
        ja.stop()
        ta.stop()


def test_sac_needs_a_box_action_space():
    with pytest.raises(ValueError, match="continuous"):
        (t_sac.SACConfig().environment(env="MinAtarBreakout-v0")
         .learners(device="cpu")).build_algo()


# ---- the card script's Pendulum twin ----

def test_pendulum_twin_matches_gymnasium():
    """chip_smoke's PendulumTwin against gymnasium's Pendulum-v1 from the
    same states and actions, step for step, within 1e-6; both truncate at
    200 steps; a seeded reset draws the same state."""
    import gymnasium as gym
    ref = gym.make("Pendulum-v1")
    twin = chip_smoke.PendulumTwin()
    o1, _ = ref.reset(seed=4)
    o2, _ = twin.reset(seed=4)
    np.testing.assert_array_equal(o1, o2)
    rng = np.random.default_rng(0)
    for start in range(3):
        state = rng.uniform([-np.pi, -8.0], [np.pi, 8.0])
        ref.reset(seed=start)
        twin.reset(seed=start)
        ref.unwrapped.state = state.copy()
        twin.state = state.copy()
        for t in range(200):
            u = rng.uniform(-3.0, 3.0, (1,)).astype(np.float32)
            a = ref.step(u)
            b = twin.step(u)
            np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-6)
            assert abs(float(a[1]) - float(b[1])) <= 1e-6
            assert (a[2], a[3]) == (b[2], b[3]) == (False, t == 199)
    assert twin.observation_space.shape == ref.observation_space.shape
    np.testing.assert_array_equal(twin.action_space.high,
                                  ref.action_space.high)


def test_pendulum_twin_registers_and_trains_sac():
    """Registered in the port's env registry, the twin drives SAC's
    runner without gymnasium."""
    from ray_tpu_torch.rllib.env.base import register
    register(chip_smoke.PENDULUM_TWIN, chip_smoke.PendulumTwin)
    algo = (t_sac.SACConfig().environment(env=chip_smoke.PENDULUM_TWIN)
            .env_runners(rollout_fragment_length=16)
            .training(num_steps_sampled_before_learning_starts=16,
                      num_updates_per_iter=2)
            .learners(device="cpu").debugging(seed=0)).build_algo()
    try:
        r = algo.train()
        assert np.isfinite(r["critic_loss"])
        assert algo.module.action_dim == 1 and algo.module.high == (2.0,)
    finally:
        algo.stop()


def test_checkpoint_extra_state_pickles_as_numpy(tmp_path):
    """The port's SAC checkpoint holds numpy and builtins only."""
    algo = _pendulum_config(t_sac.SACConfig).learners(
        device="cpu").build_algo()
    try:
        path = algo.save_to_path(str(tmp_path / "s"))
        with open(f"{path}/algorithm_state.pkl", "rb") as f:
            state = pickle.load(f)
        leaves = jax.tree_util.tree_leaves(state["extra"])
        assert leaves and all(isinstance(x, (np.ndarray, float, str))
                              for x in leaves)
    finally:
        algo.stop()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
@pytest.mark.parametrize("cls", [t_dqn.DQNConfig, t_sac.SACConfig])
def test_learner_on_cuda_without_a_card_raises(cls):
    """The learners run on the card unless the config asks for the CPU;
    on a host without one the build refuses instead of falling back."""
    env = "Pendulum-v1" if cls is t_sac.SACConfig else "MinAtarBreakout-v0"
    with pytest.raises(RuntimeError, match="CUDA"):
        cls().environment(env=env).build_algo()


def test_sac_iteration_without_updates():
    """num_updates_per_iter 0: the iteration samples and updates nothing,
    as the JAX package's loop does."""
    algo = _pendulum_config(
        t_sac.SACConfig, num_updates_per_iter=0,
        num_steps_sampled_before_learning_starts=0).learners(
        device="cpu").build_algo()
    try:
        before = [t.clone() for t in t_mod.tree_leaves(algo.params)]
        r = algo.train()
        assert "critic_loss" not in r and algo._timesteps == 32
        assert all(torch.equal(a, b.detach()) for a, b in
                   zip(before, t_mod.tree_leaves(algo.params)))
    finally:
        algo.stop()
