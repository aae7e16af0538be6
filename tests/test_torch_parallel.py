"""PyTorch port, sharded slice: meshes, sharding rules, the sharded train
step and the tensor-parallel engines, held against the JAX package.

The pure functions (`MeshConfig.resolve`, `elastic_config`,
`ShardingRules.spec`) are compared with `ray_tpu.parallel`'s directly.
The sharded paths run in gloo process groups on the CPU, spawned by
`tests/test_torch_dist_workers.py` (the workers import torch and ray_tpu_torch
only), each group joined with its own time limit:
- 4 ranks, MeshConfig(dp=1, fsdp=2, tp=2): 3 AdamW steps of the port's
  `make_train_step` against the JAX package's on the conftest's 8-device
  CPU mesh with the same config, weights and batch;
- 2 ranks: the tp=2 engines (plain, ngram speculation, prefill export +
  import_kv) against the port at tp=1 and the JAX engine at tp=2, then
  the fsdp=2 gradients against the one-device gradients (a gather whose
  gradient is not declared a partial sum gives each rank its own local
  gradient: this catches it).
"""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import InferenceEngine as JInferenceEngine
from ray_tpu.models import configs as j_configs
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models import loss_fn as j_loss_fn
from ray_tpu.models import param_logical_axes as j_param_logical_axes
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import elastic_config as j_elastic_config
from ray_tpu.parallel import make_mesh as j_make_mesh
from ray_tpu.parallel.sharding import ShardingRules as JShardingRules
from ray_tpu.train.step import make_train_step as j_make_train_step
from ray_tpu_torch.llm import EngineConfig, InferenceEngine, PrefillEngine
from ray_tpu_torch.models import (ModelConfig, configs, loss_fn,
                                  param_logical_axes, params_from_numpy)
from ray_tpu_torch.models.transformer import local_config
from ray_tpu_torch.parallel import (AXES, MeshConfig, ShardingRules,
                                    elastic_config, make_hybrid_mesh,
                                    placements)
from ray_tpu_torch.train import adamw, make_train_step
from tests import test_torch_dist_workers as workers

TINY_LLM = dict(vocab=300, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=128, dtype="float32")
PROMPTS = [[7, 8, 9], [20, 21]]            # test_llm.py's tp test inputs
HANDOFF = list(range(3, 18))               # 15 tokens: one 8-token page
N_NEW = 5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the port's CPU tests run beside other test
    files in parallel workers and must not take every core from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _standin_mesh(**degrees):
    """A stand-in with a DeviceMesh's names and shape (no process group):
    enough for the checks that run before any collective."""
    return types.SimpleNamespace(
        mesh_dim_names=AXES, shape=tuple(degrees.get(a, 1) for a in AXES))


# ---- pure functions against the reference ----

_DEGREES = [dict(dp=1, fsdp=-1), dict(dp=2, fsdp=-1), dict(fsdp=2, tp=2),
            dict(dp=2, fsdp=2, tp=2), dict(tp=-1), dict(dp=-1, tp=4),
            dict(fsdp=-1, sp=2, pp=2), dict(dp=3, fsdp=1),
            dict(dp=-1, fsdp=-1), dict(fsdp=4, ep=2)]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kw", _DEGREES, ids=range(len(_DEGREES)))
def test_mesh_config_resolve_matches_jax(kw):
    """The same degrees, the same -1 absorption and the same refusals (at
    most one -1, a device count the fixed axes do not divide, a fixed
    product that misses the count) over 1-16 devices."""
    assert AXES == ("dp", "fsdp", "pp", "sp", "tp", "ep")
    for n in range(1, 17):
        assert _outcome(lambda: MeshConfig(**kw).resolve(n)) == \
            _outcome(lambda: JMeshConfig(**kw).resolve(n)), n


@pytest.mark.parametrize("kw", [dict(dp=2, fsdp=4), dict(dp=4, fsdp=1),
                                dict(dp=1, fsdp=8, tp=2),
                                dict(dp=2, fsdp=2, tp=4, pp=2),
                                dict(dp=6, fsdp=1, sp=2)])
def test_elastic_config_matches_jax(kw):
    """The re-mesh after a device loss keeps the model axes and refits dp
    and fsdp exactly as the JAX package does, refusals included."""
    for n in range(1, 33):
        got = _outcome(lambda: elastic_config(MeshConfig(**kw), n))
        want = _outcome(lambda: j_elastic_config(JMeshConfig(**kw), n))
        if isinstance(want, JMeshConfig):
            want = dataclasses.asdict(want)
            got = dataclasses.asdict(got)
        assert got == want, n


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("name", ["bench_125m", "tiny_moe", "llama3_8b"])
def test_sharding_spec_matches_jax_partition_spec(name):
    """`ShardingRules.spec` gives the JAX package's PartitionSpec entries
    for every param of the config and for the activation axes."""
    t_rules, j_rules = ShardingRules.default(), JShardingRules.default()
    axes = param_logical_axes(getattr(configs, name)())
    assert axes == j_param_logical_axes(getattr(j_configs, name)())
    extra = [("batch", "seq", "embed_act"), ("batch", None),
             ("embed", "embed"), ("vocab", "heads", "mlp")]
    for logical in _leaves(axes) + extra:
        assert t_rules.spec(logical) == tuple(j_rules.spec(logical)), logical


def test_placements_follow_the_spec():
    """A spec entry puts Shard(dim) on each mesh dim it names (a tuple
    entry on several, in mesh-dim order) and Replicate elsewhere; an axis
    the mesh lacks is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _standin_mesh(dp=2, fsdp=2, tp=2)
    got = placements((("dp", "fsdp"), None, "tp"), mesh)
    assert got == [Shard(0), Shard(0), Replicate(), Replicate(), Shard(2),
                   Replicate()]
    assert placements((), mesh) == [Replicate()] * 6
    with pytest.raises(ValueError, match="lacks"):
        placements(("x",), mesh)


def test_meshes_refuse_what_is_not_ported():
    """sp, pp and ep above 1 build the step (tests/test_torch_sp.py runs
    them); what a mesh cannot run is refused before any collective:
    attention within a block under sp (an attn_impl that is neither ring
    nor ulysses), an ep that does not divide the experts and a tp that
    does not divide the flat head widths (ValueError, as the JAX
    package's placement refuses them), and a node count that does not
    factor into the dcn axes."""
    cfg = configs.tiny()
    for axis in ("sp", "pp", "ep"):
        mesh = _standin_mesh(**{axis: 2})
        _, _, _, shardings = make_train_step(
            lambda p, b: loss_fn(p, b, cfg, mesh), adamw(1e-3), mesh,
            param_logical_axes(cfg), device="cpu")
        assert shardings["layers"]["wq"].spec == (None, "fsdp", "tp")
    with pytest.raises(ValueError, match="attn_impl='auto'"):
        loss_fn({}, {"tokens": torch.zeros(1, 3, dtype=torch.long)}, cfg,
                mesh=_standin_mesh(sp=2))
    with pytest.raises(ValueError, match="moe_experts=4"):
        local_config(configs.tiny_moe(), _standin_mesh(ep=3))
    with pytest.raises(ValueError, match="must divide"):
        local_config(configs.tiny(), _standin_mesh(tp=3))
    with pytest.raises(ValueError, match="do not factor"):
        make_hybrid_mesh(MeshConfig(fsdp=-1), num_nodes=2, device="cpu")


# ---- the sharded train step against the JAX step ----


def _weights(cfg, seed):
    return jax.tree.map(np.asarray,
                        j_init_params(cfg, jax.random.PRNGKey(seed)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def sharded_run():
    """3 steps of the port's step on 4 gloo ranks at dp=1, fsdp=2, tp=2
    (tiny, fp32, AdamW 1e-3), and the JAX step on 4 CPU devices."""
    jcfg = j_configs.tiny(attn_impl="reference")
    w = _weights(jcfg, seed=21)
    rng = np.random.default_rng(22)
    batch = {"tokens": rng.integers(0, 256, (4, 33)).astype(np.int32)}
    mesh_kw = dict(dp=1, fsdp=2, tp=2)
    lr, steps = 1e-3, 3
    got = workers.run_group(
        workers.sharded_steps, 4, dataclasses.asdict(configs.tiny()),
        mesh_kw, w, batch, steps, lr, timeout=150)
    mesh = j_make_mesh(JMeshConfig(**mesh_kw), devices=jax.devices()[:4])
    init_fn, _, compile_for, _ = j_make_train_step(
        lambda p, b: j_loss_fn(p, b, jcfg, mesh), optax.adamw(lr), mesh,
        j_param_logical_axes(jcfg))
    state = init_fn(jax.tree.map(jnp.asarray, w))
    jb = jax.tree.map(jnp.asarray, batch)
    step = compile_for(state, jb)
    want = []
    for _ in range(steps):
        state, loss = step(state, jb)
        want.append(float(loss))
    return got, want, _flat(state.params)


def test_sharded_step_matches_jax_sharded_step(sharded_run):
    """Per-step losses within 1e-5 (relative; fp32 sums in another order
    and over other shards) and the gathered params within 2e-4 (AdamW
    divides each gradient by its running RMS, so an entry whose gradient
    sits at fp32 noise moves by up to lr per step in a direction the
    rounding decides; 2e-4 is a fifth of one step's lr) on every rank."""
    got, want, want_params = sharded_run
    for losses, params in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        flat = _flat(params)
        assert flat.keys() == want_params.keys()
        for k in flat:
            np.testing.assert_allclose(flat[k], want_params[k], rtol=0,
                                       atol=2e-4, err_msg=k)
    assert want[-1] < want[0]


# ---- tp splits that cut the heads (F6) ----

# tiny (4 heads, 2 kv heads) at tp 4: each rank one query head and a
# whole copy of the kv head it reads; 6 heads of 16 over 4 ranks: the
# split cuts heads, so attention runs whole on every rank
_UNEVEN = {"kv_replicated": dict(), "replicated": dict(
    d_model=96, n_heads=6, n_kv_heads=2)}


def _uneven_cfg_kw(name):
    return {**dataclasses.asdict(configs.tiny()), **_UNEVEN[name]}


@pytest.fixture(scope="module")
def uneven_tp_run():
    """3 AdamW 1e-3 steps of the port's step on 4 gloo ranks at dp 1,
    fsdp 1, tp 4 for each config of _UNEVEN (one group), and the JAX step
    on 4 CPU devices, on 4 x 33 tokens from default_rng(0)."""
    from ray_tpu.models import ModelConfig as JModelConfig
    mesh_kw = dict(dp=1, fsdp=1, tp=4)
    lr, steps = 1e-3, 3
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 256, (4, 33)).astype(np.int32)}
    runs, want = [], {}
    mesh = j_make_mesh(JMeshConfig(**mesh_kw), devices=jax.devices()[:4])
    for name in _UNEVEN:
        kw = _uneven_cfg_kw(name)
        jcfg = JModelConfig(**{**kw, "attn_impl": "reference"})
        w = _weights(jcfg, seed=0)
        runs.append((kw, mesh_kw, w, batch, steps, lr))
        init_fn, _, compile_for, _ = j_make_train_step(
            lambda p, b, jcfg=jcfg: j_loss_fn(p, b, jcfg, mesh),
            optax.adamw(lr), mesh, j_param_logical_axes(jcfg))
        state = init_fn(jax.tree.map(jnp.asarray, w))
        jb = jax.tree.map(jnp.asarray, batch)
        step = compile_for(state, jb)
        losses = []
        for _ in range(steps):
            state, loss = step(state, jb)
            losses.append(float(loss))
        want[name] = (losses, _flat(state.params))
    got = workers.run_group(workers.sharded_steps_each, 4, runs,
                            timeout=150)
    return {name: ([r[i] for r in got], want[name])
            for i, name in enumerate(_UNEVEN)}


@pytest.mark.parametrize("name", list(_UNEVEN))
def test_uneven_tp_step_matches_jax_sharded_step(uneven_tp_run, name):
    """tp = 4 over heads it does not divide evenly, as the reference's
    placement takes it: each rank's losses within 1e-5 (relative) of the
    JAX step's and its gathered params within 2e-4 (the tolerance of
    test_sharded_step_matches_jax_sharded_step); the local config runs
    the split it names."""
    got, (want, want_params) = uneven_tp_run[name]
    cfg = ModelConfig(**_uneven_cfg_kw(name))
    mesh = _standin_mesh(tp=4)
    mesh.get_group = mesh.get_local_rank = lambda axis: 0
    assert local_config(cfg, mesh).attn_split == name
    for losses, params in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        flat = _flat(params)
        assert flat.keys() == want_params.keys()
        for k in flat:
            np.testing.assert_allclose(flat[k], want_params[k], rtol=0,
                                       atol=2e-4, err_msg=k)
    assert want[-1] < want[0]
    if name == "kv_replicated":   # the reference's own tp = 4 losses
        np.testing.assert_allclose(want, [5.5695, 5.4090, 5.2895],
                                   atol=1e-4)


def test_engines_refuse_a_tp_that_splits_kv_heads():
    """The engines keep the reference's refusal: the KV pool is split by
    kv head, so tp must divide n_kv_heads (configs.tiny() at tp 4). The
    JAX engine's pool placement refuses it (ValueError), and so do the
    port's engines, before any collective."""
    cfg = configs.tiny()
    w = _weights(j_configs.tiny(), seed=0)
    mesh = j_make_mesh(JMeshConfig(tp=4, fsdp=1, dp=1),
                       devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        JInferenceEngine(j_configs.tiny(), JEngineConfig(
            max_slots=2, max_len=64, prompt_buckets=(16,)),
            params=jax.tree.map(jnp.asarray, w), mesh=mesh)
    pt = params_from_numpy(w, device="cpu")
    for cls in (InferenceEngine, PrefillEngine):
        with pytest.raises(ValueError, match="n_kv_heads=2"):
            cls(cfg, EngineConfig(), params=pt, mesh=_standin_mesh(tp=4),
                device="cpu")


# ---- 2 ranks: tp engines, fsdp gradients ----


@pytest.fixture(scope="module")
def two_ranks():
    w_llm = _weights(_jax_llm_cfg(), seed=0)
    w_train = _weights(j_configs.tiny(), seed=23)
    rng = np.random.default_rng(24)
    batch = {"tokens": rng.integers(0, 256, (4, 17)).astype(np.int32)}
    res = workers.run_group(
        workers.two_rank_suite, 2, TINY_LLM, w_llm, PROMPTS, N_NEW, HANDOFF,
        dataclasses.asdict(configs.tiny()), w_train, batch, timeout=150)
    return dict(results=res, w_llm=w_llm, w_train=w_train, batch=batch)


def _jax_llm_cfg():
    from ray_tpu.models import ModelConfig as JModelConfig
    return JModelConfig(**TINY_LLM)


def _port_engine(params, **kw):
    return InferenceEngine(ModelConfig(**TINY_LLM), EngineConfig(
        max_slots=2, max_len=48, prompt_buckets=(16,), eos_token=-1, **kw),
        params=params, device="cpu")


def test_tp_engine_matches_tp1_and_jax_tp2(two_ranks):
    """tp=2 greedy tokens, plain and with ngram speculation, equal the
    port's tp=1 engine's and the JAX engine's on a tp=2 CPU mesh, on
    every rank (each holding 1 of the 2 kv heads); a PrefillEngine export
    at tp=2 imported into a tp=2 decode engine continues as the
    monolithic engines do."""
    w = two_ranks["w_llm"]
    pt = params_from_numpy(w, device="cpu")
    tp1 = _port_engine(pt).generate(PROMPTS + [HANDOFF],
                                    max_new_tokens=N_NEW, temperature=0.0)
    mesh = j_make_mesh(JMeshConfig(tp=2, fsdp=1, dp=1),
                       devices=jax.devices()[:2])
    jeng = JInferenceEngine(
        _jax_llm_cfg(), JEngineConfig(max_slots=2, max_len=48,
                                      prompt_buckets=(16,), eos_token=-1),
        params=jax.tree.map(jnp.asarray, w), mesh=mesh)
    jax_tp2 = jeng.generate(PROMPTS + [HANDOFF], max_new_tokens=N_NEW,
                            temperature=0.0)
    assert tp1 == jax_tp2
    for r in two_ranks["results"]:
        eng = r["engines"]
        assert eng["kv_heads"] == eng["handoff_kv_heads"] == 1
        assert eng["plain"] == tp1[:2]
        assert eng["spec"] == tp1[:2] and eng["spec_verify_steps"] > 0
        assert eng["imported_pages"] == 1
        assert eng["handoff"] == tp1[2]


def test_fsdp2_gradients_equal_one_device_gradients(two_ranks):
    """The fsdp=2 loss equals the one-device loss of the whole batch, and
    every gathered gradient equals the one-device gradient within 1e-6 of
    its scale (fp32; the two shards' sums added in another order): each
    rank's gradient is summed over both data shards, not its own alone."""
    w, batch = two_ranks["w_train"], two_ranks["batch"]
    cfg = configs.tiny()
    params = params_from_numpy(w, device="cpu")
    for t in _leaves(params):
        t.requires_grad_(True)
    loss = loss_fn(params, {"tokens": torch.tensor(batch["tokens"])}, cfg)
    loss.backward()
    want = {k: v.grad.numpy() for k, v in _flat_t(params).items()}
    for r in two_ranks["results"]:
        got_loss, grads = r["grads"]
        np.testing.assert_allclose(got_loss, loss.item(), rtol=1e-6)
        flat = _flat(grads)
        assert flat.keys() == want.keys()
        for k in flat:
            scale = max(1e-3, float(np.abs(want[k]).max()))
            np.testing.assert_allclose(flat[k], want[k], rtol=0,
                                       atol=1e-6 * scale, err_msg=k)


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_t(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_reshard_moves_params_between_meshes(two_ranks):
    """`reshard` (the elastic restore step) moves params placed on an
    fsdp=2 mesh onto a tp=2 mesh: every full tensor unchanged, each local
    block cut by the new mesh (wq: d_model halves before, heads after)."""
    for r in two_ranks["results"]:
        flat = _flat_t(r["reshard"])
        assert all(same for same, _, _ in flat.values())
        _, before, after = flat["layers/wq"]
        assert before == (2, 32, 64) and after == (2, 64, 32)
        _, before, after = flat["embed"]
        assert before == (256, 32) and after == (128, 64)


def test_prefill_engine_refuses_data_axes():
    """An engine shards over tp only: dp or fsdp above 1 raises."""
    pt = params_from_numpy(_weights(_jax_llm_cfg(), seed=0), device="cpu")
    for cls, kw in itertools.product((InferenceEngine, PrefillEngine),
                                     (dict(fsdp=2), dict(dp=2), dict(sp=2))):
        with pytest.raises(NotImplementedError):
            cls(ModelConfig(**TINY_LLM), EngineConfig(), params=pt,
                mesh=_standin_mesh(**kw), device="cpu")
