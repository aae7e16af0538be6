"""PyTorch port, RLlib's offline half on the CPU (`ray_tpu_torch.rllib`:
`offline.py`, BC and MARWIL) against the JAX package's (`ray_tpu.rllib`),
in one process (`JAX_PLATFORMS=cpu`), on inputs made with numpy from a
seed and weights carried by `params_from_numpy`.

Tolerances, stated per check: offline rows cross between the packages
bit-equal (JSON lines and Parquet, both ways; `rows_to_arrays` of the
same rows equal); `bc_loss` and `marwil_loss` and their gradients against
`jax.value_and_grad` 1e-5. The learning gates are the JAX package's (BC
clones an expert rule; MARWIL beats BC on mixed data), run through the
port.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import offline as j_off
from ray_tpu.rllib.algorithms import bc as j_bc
from ray_tpu.rllib.algorithms import marwil as j_marwil
from ray_tpu.rllib.core import rl_module as j_mod
from ray_tpu_torch.rllib import offline as t_off
from ray_tpu_torch.rllib.algorithms import bc as t_bc
from ray_tpu_torch.rllib.algorithms import marwil as t_marwil
from ray_tpu_torch.rllib.core import learner as t_learner
from ray_tpu_torch.rllib.core import rl_module as t_mod

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


# ---- offline rows across the packages ----

def _port_rows(tmp_path, fmt):
    from ray_tpu_torch.rllib.env.base import make
    module = t_mod.module_for_env(make("MinAtarBreakout-v0"), kind="q")
    path = str(tmp_path / f"port.{'json' if fmt == 'json' else 'parquet'}")
    rows = t_off.record_transitions(
        "MinAtarBreakout-v0", module, module.init(0, device="cpu"),
        num_steps=48, path=path, fmt=fmt, seed=2)
    return rows, path


@pytest.mark.parametrize("fmt", ["json", "parquet"])
def test_port_rows_load_in_jax(tmp_path, fmt):
    """The port records MinAtar transitions; the JAX package loads the
    file (and its glob) to the same rows and arrays."""
    rows, path = _port_rows(tmp_path, fmt)
    assert rows and {"obs", "actions", "rewards", "next_obs",
                     "dones"} == set(rows[0])
    assert isinstance(rows[0]["obs"], list)
    assert isinstance(rows[0]["actions"], int)
    loaded = j_off.load_offline(path)
    assert loaded == rows
    assert j_off.load_offline(str(tmp_path / "port.*")) == rows
    _same_arrays(j_off.rows_to_arrays(loaded), t_off.rows_to_arrays(rows))


@pytest.mark.parametrize("fmt", ["json", "parquet"])
def test_jax_rows_load_in_port(tmp_path, fmt):
    """The JAX package records Pendulum transitions (continuous actions);
    the port loads them bit-equal, through a path and a glob."""
    import gymnasium as gym
    probe = gym.make("Pendulum-v1")
    module = j_mod.module_for_env(probe, kind="sac")
    probe.close()
    path = str(tmp_path / f"jax.{'json' if fmt == 'json' else 'parquet'}")
    rows = j_off.record_transitions(
        "Pendulum-v1", module, module.init(jax.random.PRNGKey(0)),
        num_steps=40, path=path, fmt=fmt)
    for got in (t_off.load_offline(path),
                t_off.load_offline(str(tmp_path / "jax.*"))):
        assert got == rows
    want = j_off.rows_to_arrays(rows, continuous=True)
    _same_arrays(want, t_off.rows_to_arrays(
        t_off.load_offline(path), continuous=True))


def test_dataset_input_feeds_bc(tmp_path):
    """A `ray_tpu_torch.data` Dataset of the JAX package's rows (the
    reference's input_ as a dataset) loads bit-equal and trains BC."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    rows = [{"obs": RNG.standard_normal(4).astype(np.float32).tolist(),
             "actions": int(a)} for a in RNG.integers(0, 2, 64)]
    rt.init(num_cpus=2, object_store_memory=64 << 20)
    try:
        ds = rd.from_items(rows, override_num_blocks=2)
        _same_arrays(j_off.rows_to_arrays(rows),
                     t_off.rows_to_arrays(t_off.load_offline(ds)))
        algo = (t_bc.BCConfig().environment(env="CartPole-v1")
                .offline_data(input_=ds).training(minibatch_size=32)
                .learners(device="cpu")).build_algo()
        try:
            assert np.isfinite(algo.train()["neg_logp"])
        finally:
            algo.stop()
    finally:
        rt.shutdown()


def test_offline_inputs_and_errors(tmp_path, monkeypatch):
    assert t_off.load_offline(None) is None
    rows = [{"obs": [1.0], "actions": 0}]
    assert t_off.load_offline(rows) is rows
    with pytest.raises(TypeError):
        t_off.load_offline(3)
    with pytest.raises(ValueError, match="unknown offline format"):
        _port_rows(tmp_path, "csv")
    # Parquet without pyarrow: an ImportError that names it
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="pyarrow"):
        t_off.load_offline(str(tmp_path / "x.parquet"))
    rows, path = _port_rows(tmp_path, "json")    # JSON needs numpy only
    assert t_off.load_offline(path) == rows


def test_record_greedy_actions(tmp_path):
    """explore=False records the module's argmax actions."""
    from ray_tpu_torch.rllib.env.base import make
    module = t_mod.module_for_env(make("MinAtarBreakout-v0"), kind="q")
    params = module.init(1, device="cpu")
    rows = t_off.record_transitions("MinAtarBreakout-v0", module, params,
                                    num_steps=32, explore=False)
    obs = torch.tensor([r["obs"] for r in rows])
    greedy = module.forward_inference(params, obs).numpy()
    assert [r["actions"] for r in rows] == greedy.tolist()


# ---- the losses ----

def _ac_params(obs_dim=6, n_act=3):
    jm = j_mod.ActorCriticModule(obs_dim, n_act, (32, 16))
    tm = t_mod.ActorCriticModule(obs_dim, n_act, (32, 16))
    return jm, tm, jm.init(jax.random.PRNGKey(4))


def _loss_and_grads(jfn, tfn, jp, batch):
    (jl, jaux), jg = jax.value_and_grad(jfn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = t_mod.tree_map(lambda t: t.requires_grad_(True),
                        t_mod.params_from_numpy(_np(jp), "cpu"))
    tl, taux = tfn(tp, t_learner.to_device(batch, torch.device("cpu")))
    leaves = t_mod.tree_leaves(tp)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    _close(jl, tl.detach(), 1e-5)
    for k in jaux:
        _close(jaux[k], taux[k].detach(), 1e-5)
    jleaves = jax.tree_util.tree_leaves(_np(jg))
    for a, p, g in zip(jleaves, leaves, tg):
        _close(a, torch.zeros_like(p) if g is None else g, 1e-5)


def test_bc_loss_and_grads_match_jax():
    jm, tm, jp = _ac_params()
    n = 40
    batch = {"obs": RNG.standard_normal((n, 6)).astype(np.float32),
             "actions": RNG.integers(0, 3, n)}
    _loss_and_grads(functools.partial(j_bc.bc_loss, module=jm),
                    functools.partial(t_bc.bc_loss, module=tm), jp, batch)


@pytest.mark.parametrize("beta", [0.0, 1.0, 4.0])
def test_marwil_loss_and_grads_match_jax(beta):
    """beta 0 is BC plus the value loss; large returns exercise the
    scale normalization and the clip."""
    jm, tm, jp = _ac_params()
    n = 40
    batch = {"obs": RNG.standard_normal((n, 6)).astype(np.float32),
             "actions": RNG.integers(0, 3, n),
             "returns": (RNG.standard_normal(n) * 50).astype(np.float32)}
    cfg = dict(beta=beta, vf_coeff=0.5)
    _loss_and_grads(functools.partial(j_marwil.marwil_loss, module=jm,
                                      **cfg),
                    functools.partial(t_marwil.marwil_loss, module=tm, **cfg),
                    jp, batch)


# ---- the algorithms ----

def test_bc_clones_expert_policy():
    """The JAX package's gate: BC on (obs -> expert action) rows fits the
    mapping (neg_logp < 0.2, greedy accuracy > 0.95)."""
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(512, 4)).astype(np.float32)
    actions = (obs[:, 0] > 0).astype(np.int64)
    rows = [{"obs": o, "actions": a} for o, a in zip(obs, actions)]
    algo = (t_bc.BCConfig().environment(env="CartPole-v1")
            .offline_data(input_=rows)
            .training(lr=1e-2, minibatch_size=64, num_epochs=3)
            .learners(device="cpu")).build_algo()
    try:
        for _ in range(5):
            metrics = algo.train()
        assert metrics["neg_logp"] < 0.2
        logits, _ = algo.module.forward_train(
            algo.learner_group.local.params, torch.from_numpy(obs[:64]))
        pred = logits.argmax(-1).numpy()
        assert (pred == actions[:64]).mean() > 0.95
        ev = algo.evaluate(64)
        assert ev["num_episodes"] >= 0
    finally:
        algo.stop()


def _mixed_rows():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(600, 4)).astype(np.float32)
    good = (obs[:, 0] > 0).astype(np.int64)
    rows = []
    for o, g in zip(obs, good):
        rows.append({"obs": o, "actions": int(g), "returns": 10.0})
        rows.append({"obs": o, "actions": int(1 - g), "returns": 0.0})
    return obs, good, rows


def test_marwil_prefers_high_return_actions():
    """The JAX package's gate: on mixed-quality rows MARWIL (beta 2)
    learns the good actions (> 0.9) and beats plain BC by > 0.1."""
    obs, good, rows = _mixed_rows()

    def fit(config_cls, **training):
        algo = (config_cls().environment(env="CartPole-v1")
                .offline_data(input_=rows)
                .training(lr=1e-2, minibatch_size=128, num_epochs=2,
                          **training)
                .learners(device="cpu").debugging(seed=0)).build_algo()
        try:
            for _ in range(6):
                algo.train()
            logits, _ = algo.module.forward_train(
                algo.learner_group.local.params, torch.from_numpy(obs[:200]))
            return float((logits.argmax(-1).numpy() == good[:200]).mean())
        finally:
            algo.stop()

    marwil_acc = fit(t_marwil.MARWILConfig, beta=2.0)
    bc_acc = fit(t_bc.BCConfig)
    assert marwil_acc > 0.9, marwil_acc
    assert marwil_acc > bc_acc + 0.1, (marwil_acc, bc_acc)


def test_bc_and_marwil_from_a_file(tmp_path):
    """Both read their rows from a JSON lines path (the reference's
    input_ shape); MARWIL refuses rows without returns."""
    import json
    obs, good, rows = _mixed_rows()
    path = str(tmp_path / "mixed.json")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps({**r, "obs": r["obs"].tolist()}) + "\n")
    for cls in (t_bc.BCConfig, t_marwil.MARWILConfig):
        algo = (cls().environment(env="CartPole-v1").offline_data(
            input_=path).training(minibatch_size=256, num_epochs=1)
                .learners(device="cpu")).build_algo()
        try:
            assert np.isfinite(algo.train()["total_loss"])
            assert algo._obs.shape == (1200, 4)
        finally:
            algo.stop()
    bare = str(tmp_path / "bare.json")
    with open(bare, "w") as f:
        f.write(json.dumps({"obs": [0.0] * 4, "actions": 1}) + "\n")
    with pytest.raises(ValueError, match="returns"):
        (t_marwil.MARWILConfig().environment(env="CartPole-v1")
         .offline_data(input_=bare).learners(device="cpu")).build_algo()
    with pytest.raises(ValueError, match="offline_data"):
        (t_bc.BCConfig().environment(env="CartPole-v1")
         .learners(device="cpu")).build_algo()
