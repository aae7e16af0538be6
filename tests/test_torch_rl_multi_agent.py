"""PyTorch port, RLlib's multi-agent half on the CPU
(`ray_tpu_torch.rllib`: the multi-agent env and runner, MultiAgentPPO)
against the JAX package's (`ray_tpu.rllib`), in one process
(`JAX_PLATFORMS=cpu`), on inputs made with numpy from a seed and weights
carried by `params_from_numpy`.

Tolerances, stated per check: the card script's copy of the cooperative
test env equals the JAX test's step for step (exact); per-policy GAE on a
fed fragment 1e-6; one training step of both policies on that fragment
(two epochs of two minibatches each) 1e-5 on the params. The learning
gates are the JAX package's (independent and shared policies), run
through the port; runner actors take the env and the default policy
mapping by name.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu.rllib.algorithms import multi_agent_ppo as j_mappo
from ray_tpu_torch.rllib.algorithms import multi_agent_ppo as t_mappo
from ray_tpu_torch.rllib.core import rl_module as t_mod
from tests.test_rllib import _TargetMatchEnv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cooperative_env_copy_matches_the_jax_tests():
    """chip_smoke.TargetMatchEnv (the port's spaces) against the JAX
    test's _TargetMatchEnv (gymnasium's): same observations, rewards and
    done flags for the same actions, over three episodes."""
    ref, copy = _TargetMatchEnv(), chip_smoke.TargetMatchEnv()
    assert ref.possible_agents == copy.possible_agents
    for a in ref.possible_agents:
        assert (ref.observation_spaces[a].shape
                == copy.observation_spaces[a].shape)
        assert ref.action_spaces[a].n == copy.action_spaces[a].n
    rng = np.random.default_rng(3)
    o1, _ = ref.reset()
    o2, _ = copy.reset()
    for _ in range(24):
        for a in o1:
            np.testing.assert_array_equal(o1[a], o2[a])
        acts = {a: int(rng.integers(4)) for a in ref.possible_agents}
        s1, s2 = ref.step(acts), copy.step(acts)
        assert s1[1:4] == s2[1:4]
        o1, o2 = s1[0], s2[0]
        if s1[2]["__all__"]:
            o1, _ = ref.reset()
            o2, _ = copy.reset()


def _config(cls, env, **training):
    return (cls().environment(env=env)
            .env_runners(num_env_runners=0, rollout_fragment_length=32)
            .training(lr=3e-3, minibatch_size=16, num_epochs=2, **training)
            .debugging(seed=0))


def _fragment(seed: int, T: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    dones = np.zeros((T, 1), np.float32)
    dones[7::8] = 1.0
    boot = np.zeros((T, 1), np.float32)
    boot[15] = 0.7       # one truncation, bootstrapped
    return {"obs": np.eye(4, dtype=np.float32)[rng.integers(0, 4, (T, 1))],
            "actions": rng.integers(0, 4, (T, 1)),
            "logp": (np.log(0.25) + 0.1 * rng.standard_normal((T, 1))
                     ).astype(np.float32),
            "values": rng.standard_normal((T, 1)).astype(np.float32),
            "rewards": (rng.random((T, 1)) < 0.3).astype(np.float32),
            "dones": dones, "bootstrap": boot,
            "last_values": rng.standard_normal(1).astype(np.float32)}


def test_gae_and_update_on_a_fed_fragment_match_jax():
    """Both algorithms sample the same fed fragment: the per-policy GAE
    (with a bootstrapped truncation) 1e-6, then the epochs of minibatch
    updates of both policies from the same weights 1e-5."""
    ja = _config(j_mappo.MultiAgentPPOConfig, _TargetMatchEnv).build_algo()
    ta = _config(t_mappo.MultiAgentPPOConfig,
                 chip_smoke.TargetMatchEnv).learners(device="cpu").build_algo()
    try:
        for pid, w in ja.get_weights().items():
            ta.learners[pid].set_weights(w)
        frags = {pid: _fragment(i) for i, pid in enumerate(("a0", "a1"))}
        fed = {}
        for name, algo in (("jax", ja), ("port", ta)):
            fed[name] = {pid: {k: v.copy() for k, v in f.items()}
                         for pid, f in frags.items()}
            algo.env_runner_group.sample = (
                lambda params, n, d=fed[name]: [d])
            m = algo.training_step()
            assert {"a0/total_loss", "a1/total_loss"} <= set(m)
        for pid in frags:
            for k in ("advantages", "returns"):
                np.testing.assert_allclose(fed["jax"][pid][k],
                                           fed["port"][pid][k],
                                           rtol=1e-6, atol=1e-6)
        jw, tw = ja.get_weights(), ta.get_weights()
        for pid in jw:
            for a, b in zip(t_mod.tree_leaves(jw[pid]),
                            t_mod.tree_leaves(tw[pid])):
                np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5,
                                           atol=1e-5)
        assert ta._timesteps == ja._timesteps == 64
    finally:
        ja.stop()
        ta.stop()


@pytest.mark.parametrize("shared", [False, True])
def test_multi_agent_ppo_learns(shared):
    """The JAX package's gates through the port: two agents with their
    own policies, or one shared policy, learn to match their targets
    (return per episode > 9 after 25 iterations; random play ~4)."""
    config = (t_mappo.MultiAgentPPOConfig()
              .environment(env=chip_smoke.TargetMatchEnv)
              .env_runners(num_env_runners=0, rollout_fragment_length=128)
              .training(lr=3e-3, minibatch_size=64, num_epochs=4)
              .learners(device="cpu").debugging(seed=int(shared)))
    if shared:
        config.multi_agent(policies=["shared"],
                           policy_mapping_fn=lambda aid: "shared")
    algo = config.build_algo()
    try:
        for _ in range(25):
            last = algo.train()
        assert last["episode_return_mean"] > 9.0, last
        if shared:
            assert set(algo.learners) == {"shared"}
        else:
            assert "a0/total_loss" in last and "a1/total_loss" in last
    finally:
        algo.stop()


def test_policy_mapping_errors():
    base = (t_mappo.MultiAgentPPOConfig()
            .environment(env=chip_smoke.TargetMatchEnv)
            .learners(device="cpu"))
    with pytest.raises(ValueError, match="routes no agent"):
        base.copy().multi_agent(policies=["a0", "a1", "idle"]).build_algo()
    with pytest.raises(ValueError, match="unknown policies"):
        base.copy().multi_agent(
            policies=["a0"], policy_mapping_fn=lambda aid: aid).build_algo()
    with pytest.raises(ValueError, match="MultiAgentEnv class"):
        (t_mappo.MultiAgentPPOConfig().environment(env="CartPole-v1")
         .learners(device="cpu")).build_algo()


def test_checkpoint_round_trip(tmp_path):
    config = _config(t_mappo.MultiAgentPPOConfig,
                     chip_smoke.TargetMatchEnv).learners(device="cpu")
    a = config.build_algo()
    b = config.copy().build_algo()
    try:
        a.train()
        b.restore_from_path(a.save_to_path(str(tmp_path / "ma")))
        for pid in a.learners:
            for x, y in zip(t_mod.tree_leaves(a.get_weights()[pid]),
                            t_mod.tree_leaves(b.get_weights()[pid])):
                np.testing.assert_array_equal(x, y)
        assert b.iteration == 1 and b._timesteps == a._timesteps
    finally:
        a.stop()
        b.stop()


def test_runner_actors_take_the_env_and_mapping_by_name():
    """Two runner actors on the port's runtime: the env class and the
    default policy mapping travel by reference; both policies train."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    try:
        algo = (t_mappo.MultiAgentPPOConfig()
                .environment(env=chip_smoke.TargetMatchEnv)
                .env_runners(num_env_runners=2, rollout_fragment_length=32)
                .training(minibatch_size=32, num_epochs=1)
                .learners(device="cpu").debugging(seed=0)).build_algo()
        try:
            for _ in range(2):
                r = algo.train()
            assert np.isfinite(r["a0/total_loss"])
            assert np.isfinite(r["a1/total_loss"])
            # 2 runners x 32 steps x 2 policies (one agent each) a round
            assert r["num_env_steps_sampled_lifetime"] == 2 * 128
            assert r["num_episodes"] > 0
        finally:
            algo.stop()
    finally:
        rt.shutdown()
