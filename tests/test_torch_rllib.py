"""PyTorch port, RLlib's on-policy half on the CPU (`ray_tpu_torch.rllib`)
against the JAX package's (`ray_tpu.rllib`), in one process
(`JAX_PLATFORMS=cpu`), on inputs made with numpy from a seed.

Tolerances, stated per check: module forwards 1e-5; the three losses and
their gradients against `jax.value_and_grad` 1e-5; GAE and V-trace 1e-6;
one clipped Learner update against optax 1e-6, five 1e-5; the fused epoch
sweep fed JAX's permutations 1e-5. Checkpoints cross both ways. The
learning gates are the JAX package's, run through the port. jax.random
and torch streams differ, so sampled behaviour is held by those gates,
never compared draw for draw.

The runtime cases (IMPALA and APPO over two runner actors, one SIGKILLed
between iterations; PPO over remote runners; two learner actors against
one local learner) share one runtime of the port.
"""

import functools
import os
import pickle
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import rllib as j_rllib
from ray_tpu.rllib.algorithms import appo as j_appo
from ray_tpu.rllib.algorithms import impala as j_impala
from ray_tpu.rllib.algorithms import ppo as j_ppo
from ray_tpu.rllib.core import learner as j_learner
from ray_tpu.rllib.core import rl_module as j_mod
from ray_tpu_torch.rllib.algorithms import appo as t_appo
from ray_tpu_torch.rllib.algorithms import impala as t_impala
from ray_tpu_torch.rllib.algorithms import ppo as t_ppo
from ray_tpu_torch.rllib.core import learner as t_learner
from ray_tpu_torch.rllib.core import rl_module as t_mod
from tests import test_torch_dist_workers as W

RNG = np.random.default_rng(0)


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jparams):
    """JAX params -> the port's tree on the CPU."""
    return t_mod.params_from_numpy(_np(jparams), "cpu")


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _close_trees(j, t, tol):
    jl = jax.tree_util.tree_leaves(_np(j))
    tl = t_mod.tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.shape == tuple(b.shape)
        _close(a, b.detach().numpy(), tol)


MODULES = {
    "actor_critic": (lambda m: (m.ActorCriticModule(6, 3, (32, 16))), (6,)),
    "q_dueling": (lambda m: m.QModule(6, 4, (32,), dueling=True), (6,)),
    "q_plain": (lambda m: m.QModule(6, 4, (32,), dueling=False), (6,)),
    "cnn_minatar": (lambda m: m.CNNActorCriticModule(
        (10, 10, 4), 3, filters=m.MINATAR_FILTERS, dense=128), (400,)),
    "cnn_nature": (lambda m: m.CNNActorCriticModule(
        (84, 84, 4), 4, filters=m.NATURE_FILTERS, dense=512), (84, 84, 4)),
}


@pytest.mark.parametrize("kind", sorted(MODULES))
def test_module_forwards_match_jax(kind):
    """Every module kind, the CNN at both filter stacks (flat and image
    inputs), on carried params: 1e-5."""
    make, obs_shape = MODULES[kind]
    jm, tm = make(j_mod), make(t_mod)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = _carry(jp)
    obs = RNG.random((5,) + obs_shape, dtype=np.float32)
    jout = jm.forward(jp, jnp.asarray(obs))
    tout = tm.forward(tp, torch.from_numpy(obs))
    for a, b in zip(jax.tree_util.tree_leaves(jout),
                    [tout] if torch.is_tensor(tout) else tout):
        assert a.shape == tuple(b.shape)
        _close(a, b, 1e-5)
    _close(jm.forward_inference(jp, jnp.asarray(obs)),
           tm.forward_inference(tp, torch.from_numpy(obs)), 0)
    if kind.startswith("cnn") and obs_shape != (400,):
        flat = obs.reshape(5, -1)
        _close(jm.forward(jp, jnp.asarray(flat))[0],
               tm.forward(tp, torch.from_numpy(flat))[0], 1e-5)


def test_squashed_gaussian_module_matches_jax():
    jm = j_mod.SquashedGaussianModule(3, 2, (-2.0, -1.0), (2.0, 1.0), (32,))
    tm = t_mod.SquashedGaussianModule(3, 2, (-2.0, -1.0), (2.0, 1.0), (32,))
    jp = jm.init(jax.random.PRNGKey(2))
    tp = _carry(jp)
    obs = RNG.standard_normal((7, 3)).astype(np.float32)
    act = (RNG.random((7, 2)).astype(np.float32) * 2 - 1) * [1.5, 0.5]
    act = act.astype(np.float32)
    for a, b in zip(jm.pi(jp, obs), tm.pi(tp, obs)):
        _close(a, b, 1e-5)
    for a, b in zip(jm.q_values(jp, obs, act), tm.q_values(tp, obs, act)):
        _close(a, b, 1e-5)
    _close(jm.log_prob(jp, obs, act), tm.log_prob(tp, obs, act), 1e-5)
    _close(jm.forward_inference(jp, obs), tm.forward_inference(tp, obs),
           1e-5)
    # a sample lies in the bounds, and its logp is log_prob's of itself
    a, logp = tm.sample(tp, obs, torch.Generator().manual_seed(0))
    assert (a.abs() <= torch.tensor([2.0, 1.0]) + 1e-5).all()
    _close(logp, tm.log_prob(tp, obs, a), 1e-3)


def test_module_for_env_reads_both_space_kinds():
    import gymnasium as gym
    from ray_tpu_torch.rllib.env.base import make
    m = t_mod.module_for_env(make("MinAtarBreakout-v0"))
    assert isinstance(m, t_mod.CNNActorCriticModule)
    m = t_mod.module_for_env(make("AtariClassBreakout-v0"))
    assert m.filters == t_mod.NATURE_FILTERS and m.dense == 512
    cart = gym.make("CartPole-v1")
    assert isinstance(t_mod.module_for_env(cart), t_mod.ActorCriticModule)
    assert isinstance(t_mod.module_for_env(cart, kind="q"), t_mod.QModule)
    pend = gym.make("Pendulum-v1")
    assert isinstance(t_mod.module_for_env(pend, kind="sac"),
                      t_mod.SquashedGaussianModule)
    with pytest.raises(ValueError, match="SAC"):
        t_mod.module_for_env(pend)


def test_init_is_one_tree_per_seed_and_asks_for_the_card():
    m = t_mod.CNNActorCriticModule((10, 10, 4), 3)
    a, b = m.init(3, device="cpu"), m.init(3, device="cpu")
    for x, y in zip(t_mod.tree_leaves(a), t_mod.tree_leaves(b)):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, y) for x, y in zip(
        t_mod.tree_leaves(m.init(4, device="cpu")), t_mod.tree_leaves(a)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m.init(0)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_learner.Learner(m, None)


def _batch(obs_dim, n, extra):
    b = {"obs": RNG.standard_normal((n, obs_dim)).astype(np.float32),
         "actions": RNG.integers(0, 3, n).astype(np.int64)}
    for k in extra:
        b[k] = RNG.standard_normal(n).astype(np.float32)
    if "logp" in b:
        b["logp"] = -np.abs(b["logp"]) - 0.5
    if "behavior_logp" in b:
        b["behavior_logp"] = -np.abs(b["behavior_logp"]) - 0.5
    return b


LOSSES = {
    "ppo": (j_ppo.ppo_loss, t_ppo.ppo_loss,
            dict(clip=0.2, vf_coef=0.5, ent_coef=0.01),
            ("logp", "advantages", "returns")),
    "impala": (j_impala.impala_loss, t_impala.impala_loss,
               dict(vf_coef=0.5, ent_coef=0.01), ("vs", "pg_advantages")),
    "appo": (j_appo.appo_loss, t_appo.appo_loss,
             dict(clip=0.2, vf_coef=0.5, ent_coef=0.01),
             ("behavior_logp", "vs", "pg_advantages")),
}


@pytest.mark.parametrize("module", ["mlp", "cnn"])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_losses_and_gradients_match_jax(loss, module):
    jfn, tfn, cfg, extra = LOSSES[loss]
    if module == "mlp":
        jm, tm = (m.ActorCriticModule(8, 3, (32, 32)) for m in (j_mod, t_mod))
        obs_dim = 8
    else:
        jm, tm = (m.CNNActorCriticModule((10, 10, 4), 3) for m in (j_mod,
                                                                  t_mod))
        obs_dim = 400
    jp = jm.init(jax.random.PRNGKey(3))
    tp = t_mod.tree_map(lambda t: t.requires_grad_(True), _carry(jp))
    batch = _batch(obs_dim, 32, extra)
    (jl, jaux), jg = jax.value_and_grad(
        functools.partial(jfn, module=jm, **cfg), has_aux=True)(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    tl, taux = tfn(tp, t_learner.to_device(batch, "cpu"), module=tm, **cfg)
    tg = torch.autograd.grad(tl, t_mod.tree_leaves(tp))
    _close(jl, tl.detach(), 1e-5)
    assert sorted(jaux) == sorted(taux)
    for k in jaux:
        _close(jaux[k], taux[k].detach(), 1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tg):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("bootstrap", [False, True])
def test_gae_matches_jax(bootstrap):
    T, B = 12, 3
    r, v = (RNG.standard_normal((T, B)).astype(np.float32) for _ in range(2))
    d = (RNG.random((T, B)) < 0.2).astype(np.float32)
    last = RNG.standard_normal(B).astype(np.float32)
    bv = (RNG.standard_normal((T, B)) * d).astype(np.float32)
    kw = dict(gamma=0.99, lam=0.95)
    jout = j_ppo._gae(*map(jnp.asarray, (r, v, d, last)), **kw,
                      bootstrap=jnp.asarray(bv) if bootstrap else None)
    tout = t_ppo._gae(*map(torch.from_numpy, (r, v, d, last)), **kw,
                      bootstrap=torch.from_numpy(bv) if bootstrap else None)
    for a, b in zip(jout, tout):
        _close(a, b, 1e-6)


def test_vtrace_matches_jax():
    T, B = 10, 4
    blogp, tlogp = (-np.abs(RNG.standard_normal((T, B))).astype(np.float32)
                    for _ in range(2))
    r, v = (RNG.standard_normal((T, B)).astype(np.float32) for _ in range(2))
    d = (RNG.random((T, B)) < 0.15).astype(np.float32)
    last = RNG.standard_normal(B).astype(np.float32)
    args = (blogp, tlogp, r, v, d, last)
    kw = dict(gamma=0.9, rho_bar=1.0, c_bar=0.8)
    jout = j_impala._vtrace_core(*map(jnp.asarray, args), **kw)
    tout = t_impala._vtrace_core(*map(torch.from_numpy, args), **kw)
    for a, b in zip(jout, tout):
        _close(a, b, 1e-6)


def _learners(grad_clip, lr):
    jm, tm = (m.CNNActorCriticModule((10, 10, 4), 3) for m in (j_mod, t_mod))
    cfg = dict(clip=0.2, vf_coef=0.5, ent_coef=0.01)
    jl = j_learner.Learner(jm, functools.partial(j_ppo.ppo_loss, module=jm),
                           lr=lr, grad_clip=grad_clip, loss_cfg=cfg)
    tl = t_learner.Learner(tm, functools.partial(t_ppo.ppo_loss, module=tm),
                           lr=lr, grad_clip=grad_clip, loss_cfg=cfg,
                           device="cpu")
    tl.set_weights(jl.get_weights())
    return jl, tl


@pytest.mark.parametrize("grad_clip", [0.05, 100.0])
def test_learner_update_matches_optax(grad_clip):
    """clip_by_global_norm then adam at the configs' default rate (3e-4):
    one update 1e-6, five 1e-5; at 0.05 the clip is live (the gradient's
    global norm is past it). Adam's first step moves an entry by about
    lr * g / (|g| + eps), so where |g| is near eps the fp32 rounding of the
    two gradients shows as a share of lr: the bound is held at the rate
    the algorithms train with."""
    jl, tl = _learners(grad_clip, lr=3e-4)
    batch = _batch(400, 64, ("logp", "advantages", "returns"))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    g = jax.grad(lambda p: jl._loss_fn(p, jb, **jl._loss_cfg)[0])(jl.params)
    assert (float(optax.global_norm(g)) > grad_clip) == (grad_clip < 1)
    jm, tmx = jl.update(batch), tl.update(batch)
    _close_trees(jl.params, tl.params, 1e-6)
    for k in jm:
        _close(jm[k], tmx[k], 1e-5)
    for _ in range(4):
        jl.update(batch)
        tl.update(batch)
    _close_trees(jl.params, tl.params, 1e-5)


def test_update_epochs_fed_jax_permutations_matches_fused_sweep():
    """Eight minibatch steps of the port's sweep on JAX's permutations
    against the JAX fused sweep: metrics 1e-5; params 1e-5 in all but at
    most one entry in 10^5, and none past 2 lr. Adam divides by
    sqrt(v) + eps, so an entry whose gradient sums to near zero moves by
    a share of lr that the two fp32 summation orders set (one entry of
    132,308 moved 1.5e-05 apart at lr 3e-4 with one torch thread); a
    wrong permutation or minibatch order moves every entry."""
    jl, tl = _learners(0.5, lr=3e-4)
    batch = _batch(400, 64, ("logp", "advantages", "returns"))
    n, epochs, mb, seed = 64, 2, 16, 5
    keys = jax.random.split(jax.random.PRNGKey(seed), epochs)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in keys])
    tl.epoch_permutations = lambda n_, e_, s_: torch.from_numpy(perms)
    jm = jl.update_epochs(batch, num_epochs=epochs, minibatch_size=mb,
                          seed=seed)
    tmx = tl.update_epochs(batch, num_epochs=epochs, minibatch_size=mb,
                           seed=seed)
    jp = np.concatenate([a.ravel() for a in
                         jax.tree_util.tree_leaves(_np(jl.params))])
    tp = np.concatenate([b.detach().numpy().ravel()
                         for b in t_mod.tree_leaves(tl.params)])
    diff = np.abs(jp - tp)
    assert (diff > 1e-5 + 1e-5 * np.abs(jp)).sum() <= -(-jp.size // 100000)
    assert diff.max() <= 2 * 3e-4, diff.max()
    for k in jm:
        _close(jm[k], tmx[k], 1e-5)
    assert tl.update_epochs(batch, num_epochs=1, minibatch_size=48) is None


def _ppo_config(pkg, env, **training):
    from importlib import import_module
    cfg = (import_module(f"{pkg}.rllib").PPOConfig()
           .environment(env=env)
           .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                        rollout_fragment_length=16)
           .training(train_batch_size=32, minibatch_size=16, num_epochs=1,
                     **training)
           .debugging(seed=0))
    if pkg == "ray_tpu_torch":
        cfg.learners(device="cpu")
    return cfg


@pytest.mark.parametrize("writer", ["ray_tpu", "ray_tpu_torch"])
def test_checkpoint_crosses_between_packages(writer, tmp_path):
    """algorithm_state.pkl written by one package restores in the other
    and gives the same forward (1e-5)."""
    reader = "ray_tpu_torch" if writer == "ray_tpu" else "ray_tpu"
    a = _ppo_config(writer, "MinAtarBreakout-v0").build_algo()
    b = _ppo_config(reader, "MinAtarBreakout-v0").build_algo()
    try:
        a.train()
        path = a.save_to_path(str(tmp_path / "ckpt"))
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            assert pickle.load(f)["iteration"] == 1
        b.restore_from_path(path)
        assert b.iteration == 1 and b._timesteps == a._timesteps
        obs = RNG.random((6, 400), dtype=np.float32)
        outs = []
        for algo in (a, b):
            w = algo.get_weights()
            if isinstance(algo.module, t_mod.CNNActorCriticModule):
                outs.append(algo.module.forward(
                    t_mod.params_from_numpy(w, "cpu"), torch.from_numpy(obs)))
            else:
                outs.append(algo.module.forward(w, jnp.asarray(obs)))
        for x, y in zip(*outs):
            _close(np.asarray(x), np.asarray(y), 1e-5)
    finally:
        a.stop()
        b.stop()


def test_ppo_cartpole_learns_local():
    """test_rllib.py's gate C, through the port: PPO improves CartPole's
    return (local runner, a CPU learner)."""
    config = (t_ppo.PPOConfig()
              .environment(env="CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(train_batch_size=512, minibatch_size=128,
                        num_epochs=4, lr=3e-4)
              .learners(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    try:
        best = 0.0
        for _ in range(40):
            ret = algo.train().get("episode_return_mean", float("nan"))
            if np.isfinite(ret):
                best = max(best, ret)
            if best >= 120.0:
                break
        assert best >= 120.0, f"PPO failed to learn: best return {best}"
    finally:
        algo.stop()


def test_ppo_minatar_trains():
    config = (t_ppo.PPOConfig()
              .environment(env="MinAtarBreakout-v0")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(train_batch_size=128, minibatch_size=64,
                        num_epochs=2, lr=1e-3)
              .learners(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    try:
        for _ in range(2):
            result = algo.train()
        assert np.isfinite(result["policy_loss"])
        assert result["num_env_steps_sampled_lifetime"] == 256
        assert algo.learner_group.local.device.type == "cpu"
    finally:
        algo.stop()


def test_fused_ppo_learns_on_device():
    """test_jax_env.py's gate, through the port's on-card iteration (here
    on the CPU): after 120 iterations the last window's return per episode
    beats random play (~0.12) by a wide margin (> 0.4)."""
    from ray_tpu_torch.rllib.core.ondevice import (OnDeviceSamplerGroup,
                                                   build_ppo_train_iter)
    from ray_tpu_torch.rllib.env.device_env import make_device_env
    env = make_device_env("JaxMinAtarBreakout-v0", 16, device="cpu")
    mod = t_mod.CNNActorCriticModule((10, 10, 4), 3)
    learner = t_learner.Learner(
        mod, None, lr=1e-3, grad_clip=0.5, seed=0, device="cpu")
    ti = build_ppo_train_iter(env, mod, T=64, num_epochs=2,
                              minibatch_size=256, gamma=0.99, lam=0.95,
                              clip=0.2, vf_coef=0.5, ent_coef=0.01,
                              learner=learner)
    vs = env.reset(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    grp = OnDeviceSamplerGroup()
    m = None
    for i in range(120):
        vs, m = ti(vs, gen)
        if i == 89:
            m = t_learner.read_metrics(m)
            grp.record(m["ep_ret_sum"], m["ep_len_sum"], m["ep_count"])
    m = t_learner.read_metrics(m)
    grp.record(m["ep_ret_sum"], m["ep_len_sum"], m["ep_count"])
    assert grp._window[-1][0] > 0.4, grp._window


def test_ondevice_algorithms_run_their_iterations():
    """PPO and IMPALA on the on-card envs through the Algorithm surface:
    steps counted, losses finite, episodes banked; IMPALA's behavior tree
    is a copy the learner's in-place updates do not reach."""
    for cls, env in ((t_ppo.PPOConfig, "JaxAtariClassBreakout-v0"),
                     (t_impala.IMPALAConfig, "JaxMinAtarBreakout-v0")):
        config = (cls().environment(env=env)
                  .env_runners(num_env_runners=0, num_envs_per_env_runner=8)
                  .training(train_batch_size=256, minibatch_size=128,
                            num_epochs=1, lr=1e-3)
                  .learners(device="cpu").debugging(seed=0))
        if cls is t_impala.IMPALAConfig:
            config.training(broadcast_interval=2)
        algo = config.build_algo()
        try:
            for _ in range(3):
                r = algo.train()
            assert r["num_env_steps_sampled_lifetime"] == 3 * 256
            assert np.isfinite(r["policy_loss"]) and "vf_loss" in r
            assert r["num_episodes"] > 0
            if cls is t_impala.IMPALAConfig:
                lp = t_mod.tree_leaves(algo.learner_group.local.params)
                bp = t_mod.tree_leaves(algo._behavior_params)
                assert not any(x is y for x, y in zip(lp, bp))
                # three updates since the broadcast after the second
                assert not all(torch.equal(x, y) for x, y in zip(lp, bp))
        finally:
            algo.stop()


@pytest.mark.parametrize("name", j_rllib.__all__)
def test_port_exports_every_jax_name(name):
    """Every public name of the JAX package's RLlib imports from the
    port's, as a class of the same name; unknown names still raise
    AttributeError."""
    import ray_tpu_torch.rllib as rl
    got = getattr(rl, name)
    assert isinstance(got, type) and got.__name__ == name
    assert name in rl.__all__
    with pytest.raises(AttributeError):
        rl.NoSuchThing


# ---- through the port's runtime ----

@pytest.fixture(scope="module")
def runtime():
    rt.init(num_cpus=6, object_store_memory=128 << 20)
    yield rt
    rt.shutdown()


def _runner_pid(handle) -> int:
    from ray_tpu_torch.core.runtime import get_runtime
    return get_runtime().actors[handle._actor_id].worker.proc.pid


@pytest.mark.parametrize("algo", ["IMPALA", "APPO"])
def test_async_algorithms_survive_a_killed_runner(runtime, algo):
    """Two runner actors, three iterations; one runner SIGKILLed after the
    first, replaced, and the run goes on."""
    cfg_cls = (t_impala.IMPALAConfig if algo == "IMPALA"
               else t_appo.APPOConfig)
    config = (cfg_cls().environment(env="CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=32)
              .training(train_batch_size=256, lr=5e-4)
              .learners(device="cpu").debugging(seed=0))
    a = config.build_algo()
    try:
        r = a.train()
        old = a.env_runner_group.remotes[0]
        os.kill(_runner_pid(old), signal.SIGKILL)
        for _ in range(2):
            r = a.train()
        assert np.isfinite(r["total_loss"])
        assert r["num_env_steps_sampled_lifetime"] >= 3 * 256
        assert a.env_runner_group.remotes[0] is not old
    finally:
        a.stop()


def test_ppo_with_remote_env_runners(runtime):
    config = (t_ppo.PPOConfig().environment(env="MinAtarBreakout-v0")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=32)
              .training(train_batch_size=128, minibatch_size=64,
                        num_epochs=2)
              .learners(device="cpu").debugging(seed=0))
    a = config.build_algo()
    try:
        r = a.train()
        assert "total_loss" in r
        r = a.train()
        assert r["num_env_steps_sampled_lifetime"] >= 256
    finally:
        a.stop()


def test_two_learner_group_matches_local(runtime):
    """Two learner actors averaging gradients by the collective allreduce
    equal one local learner on the whole batch (1e-4 / 1e-5), after 3
    updates."""
    module = t_mod.ActorCriticModule(obs_dim=4, num_actions=2)
    loss = functools.partial(W.rl_regression_loss, module=module)
    batch = {"obs": RNG.standard_normal((16, 4)).astype(np.float32),
             "y": RNG.standard_normal(16).astype(np.float32)}
    cfg = {"lr": 1e-2, "seed": 7, "grad_clip": 0.5}
    local = t_learner.Learner(module, loss, device="cpu", **cfg)
    t0 = time.monotonic()
    group = t_learner.LearnerGroup(module, loss, num_learners=2, config=cfg,
                                   device="cpu")
    try:
        for _ in range(3):
            ml = local.update(batch)
            mg = group.update(batch)
        _close(ml["total_loss"], mg["total_loss"], 1e-4)
        for a, b in zip(t_mod.tree_leaves(local.get_weights()),
                        t_mod.tree_leaves(group.get_weights())):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        assert time.monotonic() - t0 < 240
    finally:
        group.stop()
