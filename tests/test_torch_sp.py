"""PyTorch port, sequence and expert parallelism: ring attention (the
plain ring and the kernel ring's wiring), Ulysses, and the sharded train
step under sp, ep and pp, held against the JAX package.

The port runs one process per rank: each gets its block of the sequence
(`parallel.ring_attention`, `parallel.ulysses`). Two gloo process groups
on the CPU, spawned by `tests/test_torch_dist_workers.py`, each joined
with its own time limit:
- 4 ranks: ring attention (impl "jnp", the plain ring, and "interpret",
  the kernel ring's Function on the kernels' plain versions) and Ulysses
  at sp = 4 (MeshConfig(fsdp=1, sp=4)) and sp = 2 (dp=2 x sp=2, each dp
  replica on the same inputs), causal and full, outputs and gradients of
  the sum of the squared output; then 3 AdamW steps at fsdp = 2 x sp = 2
  with attn_impl "ring";
- 2 ranks: 3 AdamW steps each at sp = 2 (ring and Ulysses), at ep = 2
  (`configs.tiny_moe()`) and at pp = 2 (the JAX step replicates over pp).
The JAX side runs on the conftest's 8 CPU devices: its ring on CPU is the
jnp ring, its steps `ray_tpu.train.step.make_train_step` on a mesh of the
same degrees, on the same weights (`params_from_numpy`).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import ModelConfig as JModelConfig
from ray_tpu.models import init_params as j_init_params
from ray_tpu.models import loss_fn as j_loss_fn
from ray_tpu.models import param_logical_axes as j_param_logical_axes
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as j_make_mesh
from ray_tpu.parallel import ring_attention as j_ring_attention
from ray_tpu.parallel import ulysses_attention as j_ulysses_attention
from ray_tpu.train.step import make_train_step as j_make_train_step
from ray_tpu_torch.models import configs
from ray_tpu_torch.parallel import AXES, ring_attention
from ray_tpu_torch.train.step import sequence_block
from tests import test_torch_dist_workers as workers

B, S, H, D = 2, 64, 4, 16        # tests/test_parallel.py's _qkv shape
SPS = (2, 4)
CAUSAL = (True, False)
KINDS = (("ring", "jnp"), ("ring", "interpret"), ("ulysses", None))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the port's CPU tests run beside other test
    files in parallel workers and must not take every core from them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sp_mesh_kw(sp: int) -> dict:
    """sp ranks of a 4-rank group: sp = 2 beside dp = 2."""
    return dict(dp=4 // sp, fsdp=1, sp=sp)


def _qkv(kind, sp, causal):
    """The global inputs of a case (the two rings' cases share them)."""
    rng = np.random.default_rng([("ring", "ulysses").index(kind), sp,
                                 int(causal)])
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 for _ in range(3))


CASES = [(kind, impl, sp, causal) for kind, impl in KINDS for sp in SPS
         for causal in CAUSAL]


@functools.lru_cache(maxsize=None)
def _jax_attention(kind, sp, causal):
    """The JAX package's ring (its CPU path, the jnp ring) or Ulysses on
    a mesh of sp CPU devices, on the case's inputs: the output and the
    gradients of the sum of its squared output."""
    q, k, v = _qkv(kind, sp, causal)
    mesh = j_make_mesh(JMeshConfig(fsdp=1, sp=sp), devices=jax.devices()[:sp])
    fn = j_ring_attention if kind == "ring" else j_ulysses_attention

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mesh, causal=causal) ** 2)

    out = fn(*map(jnp.asarray, (q, k, v)), mesh, causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in (out, *grads)]


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


# the sharded steps: (config, mesh degrees, world)
STEPS = {
    "sp2-ring": (dict(attn_impl="ring"), dict(fsdp=1, sp=2), 2),
    "sp2-ulysses": (dict(attn_impl="ulysses"), dict(fsdp=1, sp=2), 2),
    "ep2-tiny_moe": ("tiny_moe", dict(fsdp=1, ep=2), 2),
    "pp2": (dict(), dict(fsdp=1, pp=2), 2),
    "fsdp2-sp2-ring": (dict(attn_impl="ring"), dict(fsdp=2, sp=2), 4),
}
LR, N_STEPS = 1e-3, 3


def _step_run(name):
    """(port config kwargs, JAX config, weights, batch, mesh degrees)."""
    kw, mesh_kw, _ = STEPS[name]
    if kw == "tiny_moe":
        cfg = dataclasses.asdict(configs.tiny_moe())
    else:
        cfg = dataclasses.asdict(configs.tiny(**kw))
    jcfg = JModelConfig(**cfg)
    w = _weights(jcfg, seed=0)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 256, (4, 33)).astype(np.int32)}
    return cfg, jcfg, w, batch, mesh_kw


def _jax_steps(jcfg, w, batch, mesh_kw):
    n = int(np.prod(list(mesh_kw.values())))
    mesh = j_make_mesh(JMeshConfig(**mesh_kw), devices=jax.devices()[:n])
    init_fn, _, compile_for, _ = j_make_train_step(
        lambda p, b: j_loss_fn(p, b, jcfg, mesh), optax.adamw(LR), mesh,
        j_param_logical_axes(jcfg))
    state = init_fn(jax.tree.map(jnp.asarray, w))
    jb = jax.tree.map(jnp.asarray, batch)
    step = compile_for(state, jb)
    losses = []
    for _ in range(N_STEPS):
        state, loss = step(state, jb)
        losses.append(float(loss))
    return losses, _flat(state.params)


@pytest.fixture(scope="module")
def four_ranks():
    """Every attention case of CASES and the fsdp = 2 x sp = 2 step, in
    one group of 4 ranks."""
    cases = [(_sp_mesh_kw(sp), kind, impl, causal, _qkv(kind, sp, causal))
             for kind, impl, sp, causal in CASES]
    cfg, jcfg, w, batch, mesh_kw = _step_run("fsdp2-sp2-ring")
    per_rank = workers.run_group(
        workers.sp_attention_and_steps, 4,
        [(m, k, i or "jnp", c, a) for m, k, i, c, a in cases],
        [(cfg, mesh_kw, w, batch, N_STEPS, LR)], timeout=240)
    return dict(cases=cases, attn=[attn for attn, _ in per_rank],
                steps={"fsdp2-sp2-ring": [steps[0]
                                          for _, steps in per_rank]})


@pytest.fixture(scope="module")
def two_ranks():
    """The 2-rank steps of STEPS, in one group."""
    names = [n for n in STEPS if STEPS[n][2] == 2]
    runs = []
    for n in names:
        cfg, _, w, batch, mesh_kw = _step_run(n)
        runs.append((cfg, mesh_kw, w, batch, N_STEPS, LR))
    got = workers.run_group(workers.sharded_steps_each, 2, runs,
                            timeout=240)
    return {n: [r[i] for r in got] for i, n in enumerate(names)}


def _assemble(per_rank, case_index, sp):
    """Each replica's (out, dq, dk, dv), its sp blocks concatenated along
    the sequence in sp-rank order."""
    replicas = {}
    for rank, res in enumerate(per_rank):
        sp_rank, *arrays = res[case_index]
        replicas.setdefault(rank // sp, {})[sp_rank] = arrays
    return [[np.concatenate([blocks[r][j] for r in range(sp)], axis=1)
             for j in range(4)] for blocks in replicas.values()]


def _check_attention(four_ranks, kind, impl, sp, causal, grad_tol):
    i = CASES.index((kind, impl, sp, causal))
    want = _jax_attention(kind, sp, causal)
    replicas = _assemble(four_ranks["attn"], i, sp)
    assert len(replicas) == 4 // sp
    for got in replicas:
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
        for g, w, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, w, rtol=grad_tol, atol=grad_tol,
                                       err_msg=name)


@pytest.mark.parametrize("sp,causal", [(sp, c) for sp in SPS for c in CAUSAL],
                         ids=[f"sp{sp}-{'causal' if c else 'full'}"
                              for sp in SPS for c in CAUSAL])
def test_ring_attention_matches_jax(four_ranks, sp, causal):
    """The plain ring (impl "jnp", autograd through the loop and the
    ppermute Function) against the JAX package's ring on sp CPU devices:
    the output within 2e-5 and the gradients within 1e-4
    (tests/test_parallel.py's tolerances), on every replica."""
    _check_attention(four_ranks, "ring", "jnp", sp, causal, 1e-4)


@pytest.mark.parametrize("sp,causal", [(sp, c) for sp in SPS for c in CAUSAL],
                         ids=[f"sp{sp}-{'causal' if c else 'full'}"
                              for sp in SPS for c in CAUSAL])
def test_interpret_ring_matches_jax(four_ranks, sp, causal):
    """The kernel ring's Function (the per-step forward with lse, the fp32
    merge, the ring-level backward with travelling dK/dV) on the kernels'
    plain versions, against the JAX ring: the output within 2e-5, the
    gradients within 2e-4 (the JAX kernel-ring test's tolerance)."""
    _check_attention(four_ranks, "ring", "interpret", sp, causal, 2e-4)


@pytest.mark.parametrize("sp,causal", [(sp, c) for sp in SPS for c in CAUSAL],
                         ids=[f"sp{sp}-{'causal' if c else 'full'}"
                              for sp in SPS for c in CAUSAL])
def test_ulysses_matches_jax(four_ranks, sp, causal):
    """Ulysses (two all-to-alls around the plain dense attention) against
    the JAX package's: the output within 2e-5, the gradients within 1e-4
    (the all-to-all Function's backward swaps the dims)."""
    _check_attention(four_ranks, "ulysses", None, sp, causal, 1e-4)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_matches_jax_step(four_ranks, two_ranks, name):
    """3 AdamW 1e-3 steps of the port's `make_train_step` on 4 x 33
    tokens at sp = 2 (ring, Ulysses), fsdp = 2 x sp = 2 (ring), ep = 2
    (tiny_moe) and pp = 2, against the JAX step on a mesh of the same
    degrees and the same weights: each rank's losses within 1e-5
    (relative) and its gathered params within 2e-4 (the tolerances of
    test_sharded_step_matches_jax_sharded_step); the losses fall."""
    cfg, jcfg, w, batch, mesh_kw = _step_run(name)
    want, want_params = _jax_steps(jcfg, w, batch, mesh_kw)
    got = (four_ranks["steps"] if STEPS[name][2] == 4 else two_ranks)[name]
    assert len(got) == STEPS[name][2]
    for losses, params in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        flat = _flat(params)
        assert flat.keys() == want_params.keys()
        for k in flat:
            np.testing.assert_allclose(flat[k], want_params[k], rtol=0,
                                       atol=2e-4, err_msg=k)
    assert want[-1] < want[0]


def test_sequence_block_shifts_then_cuts():
    """The train step's sp cut: a tokens batch is shifted into inputs and
    targets first, then every row cut into sp contiguous blocks (rank r
    the r-th); a sequence that sp does not divide is refused."""
    tokens = torch.arange(2 * 9).reshape(2, 9)
    for r in range(2):
        mesh = types.SimpleNamespace(
            mesh_dim_names=AXES, shape=(1, 1, 1, 2, 1, 1),
            get_local_rank=lambda axis, r=r: r)
        got = sequence_block({"tokens": tokens,
                              "mask": torch.ones(2, 8)}, mesh)
        assert sorted(got) == ["inputs", "mask", "targets"]
        assert torch.equal(got["inputs"], tokens[:, r * 4:r * 4 + 4])
        assert torch.equal(got["targets"], tokens[:, r * 4 + 1:r * 4 + 5])
        assert got["mask"].shape == (2, 4)
    with pytest.raises(ValueError, match="sp=2"):
        sequence_block({"tokens": tokens[:, :8]}, mesh)


def test_ring_attention_refuses_what_the_reference_refuses():
    """An explicit kernel impl on a local chunk with no tile divisor of
    at least 8 raises ValueError, as the JAX package's; "auto" on the CPU
    takes the plain ring at any length; a q_spec that does not cut the
    sequence over the axis is refused."""
    x = torch.zeros(1, 12, 2, 16)
    for impl in ("pallas", "interpret"):
        with pytest.raises(ValueError, match="tile divisor"):
            ring_attention(x, x, x, None, impl=impl)
    assert ring_attention(x, x, x, None).shape == x.shape
    with pytest.raises(ValueError, match="q_spec"):
        ring_attention(x, x, x, None, q_spec=(None, None, "sp", None))
