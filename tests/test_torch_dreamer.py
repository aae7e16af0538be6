"""PyTorch port, DreamerV3 on the CPU (`ray_tpu_torch.rllib.algorithms.
dreamerv3`) against the JAX package's (`ray_tpu.rllib.algorithms.
dreamerv3`), in one process (`JAX_PLATFORMS=cpu`), on inputs made with
numpy from a seed and weights carried by `params_from_numpy`.

The categorical draws are fed: the test draws JAX's Gumbel noise from the
keys the JAX code splits (`jax.random.categorical` is the argmax of the
logits plus `jax.random.gumbel` of the same key) and hands it to the port
in draw order.

Tolerances, stated per check: symlog and symexp 1e-6; the RSSM cells
(GRU, unimix, KL, the posterior and prior steps) and their gradients
through the straight-through latents 1e-5; the lambda-returns against the
JAX package's reversed scan 1e-6 and the 5th/95th percentiles against
`jnp.percentile` 1e-6; one whole update (world model, imagination,
actor and critic, both optimizer chains, the critic EMA and the return
normalizer) 1e-5 on the metrics and 1e-5 on every parameter. The world
model's learning check is the JAX package's, run through the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import dreamerv3 as jd
from ray_tpu_torch.rllib.algorithms import dreamerv3 as td
from ray_tpu_torch.rllib.core import rl_module as t_mod

RNG = np.random.default_rng(0)
SPEC = dict(obs_dim=6, num_actions=3, deter=16, classes=4, groups=3,
            hidden=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol):
    if torch.is_tensor(b):
        b = b.detach().numpy()
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _specs():
    jspec, tspec = jd.RSSMSpec(**SPEC), td.RSSMSpec(**SPEC)
    jp = jspec.init_params(jax.random.PRNGKey(0))
    tp = t_mod.tree_map(lambda t: t.requires_grad_(True),
                        t_mod.params_from_numpy(_np(jp), "cpu"))
    return jspec, tspec, jp, tp


def test_symlog_symexp_match_jax():
    x = (RNG.standard_normal(64) * 30).astype(np.float32)
    _close(jd.symlog(jnp.asarray(x)), td.symlog(_t(x)), 1e-6)
    y = (RNG.standard_normal(64) * 3).astype(np.float32)
    _close(jd.symexp(jnp.asarray(y)), td.symexp(_t(y)), 1e-6)


def test_init_tree_has_the_jax_layout():
    jspec, tspec, jp, _ = _specs()
    tp = tspec.init_params(0, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = t_mod.tree_leaves(tp)
    assert len(jl) == len(tl)
    for (_path, a), b in zip(jl, tl):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32


def test_rssm_cells_match_jax():
    """GRU, unimix and KL directly; the posterior and prior steps with
    the Gumbel noise fed; is_first resets half the batch."""
    jspec, tspec, jp, tp = _specs()
    B, s, d = 5, jspec.stoch, jspec.deter
    h = RNG.standard_normal((B, d)).astype(np.float32)
    z = RNG.random((B, s)).astype(np.float32)
    a = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, B)]
    embed = RNG.standard_normal((B, 12)).astype(np.float32)
    first = (np.arange(B) % 2).astype(np.float32)
    x = np.concatenate([z, a], -1)
    _close(jspec._gru(jp, h, x), tspec._gru(tp, _t(h), _t(x)), 1e-5)
    logits = RNG.standard_normal((B, s)).astype(np.float32)
    jm, tm = jspec._unimix(jnp.asarray(logits)), tspec._unimix(_t(logits))
    _close(jm, tm, 1e-5)
    other = RNG.standard_normal((B, s)).astype(np.float32)
    _close(jspec._kl(jm, jspec._unimix(jnp.asarray(other))),
           tspec._kl(tm, tspec._unimix(_t(other))), 1e-5)

    key = jax.random.PRNGKey(7)
    g = jax.random.gumbel(key, (B, jspec.groups, jspec.classes))
    jout = jspec.obs_step(jp, h, z, a, embed, first, key)
    tout = tspec.obs_step(tp, _t(h), _t(z), _t(a), _t(embed), _t(first),
                          td._Gumbel(fed=[_t(g)]))
    for u, v in zip(jout, tout):
        _close(u, v, 1e-5)
    jh, jz = jspec.img_step(jp, h, z, a, key)
    th, tz = tspec.img_step(tp, _t(h), _t(z), _t(a),
                            td._Gumbel(fed=[_t(g)]))
    _close(jh, th, 1e-5)
    _close(jz, tz, 1e-5)


def test_rssm_gradients_through_the_straight_through_latents():
    """d/dparams of a weighted sum of a posterior step's h and z (the
    straight-through estimator carries the latent's gradient into the
    posterior's logits) and of its KL terms."""
    jspec, tspec, jp, tp = _specs()
    B = 4
    h = RNG.standard_normal((B, jspec.deter)).astype(np.float32)
    z = RNG.random((B, jspec.stoch)).astype(np.float32)
    a = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, B)]
    embed = RNG.standard_normal((B, 12)).astype(np.float32)
    first = np.zeros(B, np.float32)
    wz = RNG.standard_normal((B, jspec.stoch)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    g = jax.random.gumbel(key, (B, jspec.groups, jspec.classes))

    def jloss(p):
        hh, zz, pr, po = jspec.obs_step(p, h, z, a, embed, first, key)
        return (hh.sum() + (zz * wz).sum()
                + jspec._kl(po, pr).mean())

    jg = jax.grad(jloss)(jp)
    hh, zz, pr, po = tspec.obs_step(tp, _t(h), _t(z), _t(a), _t(embed),
                                    _t(first), td._Gumbel(fed=[_t(g)]))
    loss = hh.sum() + (zz * _t(wz)).sum() + tspec._kl(po, pr).mean()
    leaves = t_mod.tree_leaves(tp)
    tg = torch.autograd.grad(loss, leaves, allow_unused=True)
    for u, p, v in zip(jax.tree_util.tree_leaves(_np(jg)), leaves, tg):
        _close(u, torch.zeros_like(p) if v is None else v, 1e-5)


def test_lambda_returns_and_percentiles_match_jax():
    """The port's loop against the JAX package's reversed lax.scan (its
    lam_step, copied), and the 5th/95th percentiles of the returns."""
    H, N, lam = 10, 37, 0.95
    rew = RNG.standard_normal((H, N)).astype(np.float32)
    disc = (0.99 * RNG.random((H, N))).astype(np.float32)
    values = RNG.standard_normal((H + 1, N)).astype(np.float32)

    def lam_step(nxt, xs):
        r, d, v_next = xs
        ret = r + d * ((1 - lam) * v_next + lam * nxt)
        return ret, ret
    _, jrets = jax.lax.scan(lam_step, values[-1],
                            (rew, disc, values[1:]), reverse=True)
    trets = td.lambda_returns(_t(rew), _t(disc), _t(values), lam)
    _close(jrets, trets, 1e-6)
    lo, hi = td.return_range(trets)
    _close(jnp.percentile(jrets, 5.0), lo, 1e-6)
    _close(jnp.percentile(jrets, 95.0), hi, 1e-6)


def _algos(**training):
    kw = {**dict(batch_size_B=3, batch_length_T=5, horizon_H=4,
                 num_updates_per_iter=1,
                 model_size={"deter": 16, "hidden": 12, "classes": 4,
                             "groups": 3}), **training}
    jc = (jd.DreamerV3Config().environment(
        env="MinAtarFreeway-v0", env_config={"max_steps": 150})
          .training(**kw).debugging(seed=0))
    jc.num_envs = 2
    tc = (td.DreamerV3Config().environment(
        env="MinAtarFreeway-v0", env_config={"max_steps": 150})
          .training(**kw).learners(device="cpu").debugging(seed=0))
    tc.num_envs = 2
    return jc.build_algo(), tc.build_algo()


def _batch(B, T, obs_dim):
    first = np.zeros((B, T), np.float32)
    first[:, 0] = 1.0
    first[1, 3] = 1.0
    return {"obs": (RNG.random((B, T, obs_dim)) < 0.2).astype(np.float32),
            "action": RNG.integers(0, 3, (B, T)),
            "reward": (RNG.random((B, T)) < 0.2).astype(np.float32),
            "cont": (RNG.random((B, T)) > 0.1).astype(np.float32),
            "is_first": first}


def test_whole_update_matches_jax():
    """Two updates in a row from the same params, batches and Gumbel
    noise: every metric, parameter, the critic EMA and the return
    normalizer 1e-5."""
    ja, ta = _algos()
    try:
        with torch.no_grad():
            for a, b in zip(t_mod.tree_leaves(ta.params),
                            jax.tree_util.tree_leaves(_np(ja.params))):
                a.copy_(_t(b))
            for a, b in zip(t_mod.tree_leaves(ta.critic_ema),
                            jax.tree_util.tree_leaves(_np(ja.critic_ema))):
                a.copy_(_t(b))
        spec, c = ja.spec, ja.config
        B, T, H = c.batch_size_B, c.batch_length_T, c.horizon_H
        N = B * T
        state = (ja.params, ja.critic_ema, ja.wm_opt, ja.ac_opt, ja.retnorm)
        for step in range(2):
            batch = _batch(B, T, spec.obs_dim)
            key = jax.random.PRNGKey(20 + step)
            k_wm, k_img = jax.random.split(key)
            fed, k = [], k_wm
            for _ in range(T):
                k, sub = jax.random.split(k)
                fed.append(jax.random.gumbel(
                    sub, (B, spec.groups, spec.classes)))
            k = k_img
            for _ in range(H):
                k, ka, kz = jax.random.split(k, 3)
                fed.append(jax.random.gumbel(ka, (N, spec.num_actions)))
                fed.append(jax.random.gumbel(
                    kz, (N, spec.groups, spec.classes)))
            jout = ja._update(*state, {k_: jnp.asarray(v) for k_, v in
                                          batch.items()}, key)
            tm = ta._update({k_: _t(v) for k_, v in batch.items()},
                            td._Gumbel(fed=[_t(g) for g in fed]))
            jparams, jema, _wo, _ao, jret, jm = jout
            assert set(jm) == set(tm)
            for name in jm:
                _close(jm[name], tm[name], 1e-5)
            for u, v in zip(jax.tree_util.tree_leaves(_np(jparams)),
                            t_mod.tree_leaves(ta.params)):
                _close(u, v, 1e-5)
            for u, v in zip(jax.tree_util.tree_leaves(_np(jema)),
                            t_mod.tree_leaves(ta.critic_ema)):
                _close(u, v, 1e-5)
            _close(jret, ta.retnorm, 1e-6)
            state = jout[:5]
    finally:
        ja.stop()
        ta.stop()


def test_fed_noise_of_the_wrong_shape_raises():
    g = td._Gumbel(fed=[torch.zeros(2, 3)])
    with pytest.raises(ValueError, match="fed Gumbel noise"):
        g((3, 2), torch.device("cpu"))


def test_dreamerv3_world_model_learns():
    """The JAX package's check through the port: the RSSM's
    reconstruction and reward losses fall on replayed CartPole
    fragments, everything stays finite, the imagined return is read."""
    config = (td.DreamerV3Config().environment(env="CartPole-v1")
              .training(batch_size_B=4, batch_length_T=16,
                        num_updates_per_iter=4,
                        model_size={"deter": 64, "hidden": 64,
                                    "classes": 8, "groups": 8})
              .learners(device="cpu").debugging(seed=0))
    config.num_envs = 4
    algo = config.build_algo()
    try:
        first = algo.train()
        assert np.isfinite(first["world_model_loss"])
        losses = []
        for _ in range(12):
            r = algo.train()
            losses.append(r["recon_loss"] + r["reward_loss"])
        assert all(np.isfinite(v) for v in losses)
        assert np.mean(losses[-3:]) < 0.7 * np.mean(losses[:3]), losses
        assert "imagined_return" in r and np.isfinite(r["imagined_return"])
        assert r["num_env_steps_sampled_lifetime"] == 13 * 16 * 4
        assert len(algo.buffer) == 13 * 4
    finally:
        algo.stop()


def test_iteration_without_updates_collects_only():
    """num_updates_per_iter 0 (or a replay shorter than B): collection
    only, no metrics, as the JAX package's loop."""
    _ja, ta = _algos(num_updates_per_iter=0)
    _ja.stop()
    try:
        r = ta.train()
        assert "world_model_loss" not in r
        assert r["num_env_steps_sampled_lifetime"] == 5 * 2
    finally:
        ta.stop()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_asking_for_cuda_without_a_card_raises():
    """DreamerV3 runs on the card by default; on a host without one it
    refuses instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA"):
        (td.DreamerV3Config().environment(env="MinAtarFreeway-v0")
         .build_algo())
