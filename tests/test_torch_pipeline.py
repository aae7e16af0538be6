"""PyTorch port, pipeline stages and the remaining collectives: GPipe
(`parallel.pipeline.gpipe`), `reduce_scatter` and the runtime `Barrier`
of `parallel.collectives`, held against the JAX package.

One gloo process group of 4 ranks on the CPU (spawned by
`tests/test_torch_dist_workers.py`, killed at its time limit) runs every
GPipe case (pp = 4 and pp = 2 beside dp = 2; each rank its stage's block
of the stacked weights, the same microbatches everywhere) and every
reduce_scatter case; the JAX side runs `ray_tpu.parallel.pipeline.gpipe`
and `jax.lax.psum_scatter` on the conftest's CPU devices. The Barrier
runs in actors of the port's runtime.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as j_make_mesh
from ray_tpu.parallel import pipeline as j_pipeline
from ray_tpu.parallel.sharding import shard_map_compat
from jax.sharding import PartitionSpec as P
from tests import test_torch_dist_workers as workers

# tests/test_parallel.py's shapes: (stages, microbatches, features, rows)
GPIPE = {"pp4": (4, 6, 8, 3), "pp2": (2, 4, 8, 2)}
SCATTER = [(n, dim) for n in (2, 4) for dim in (0, 1)]


def _stage_fn(w, x):
    return jnp.tanh(x @ w)


def _gpipe_inputs(name):
    s, m, f, rows = GPIPE[name]
    rng = np.random.default_rng(s)
    ws = (rng.standard_normal((s, f, f)) / np.sqrt(f)).astype(np.float32)
    mbs = rng.standard_normal((m, rows, f)).astype(np.float32)
    return ws, mbs


def _scatter_inputs(n, dim):
    rng = np.random.default_rng(10 * n + dim)
    return rng.standard_normal((n, 8, 12)).astype(np.float32)


@pytest.fixture(scope="module")
def four_ranks():
    gpipe_cases = [(dict(dp=4 // GPIPE[n][0], fsdp=1, pp=GPIPE[n][0]),
                    *_gpipe_inputs(n)) for n in GPIPE]
    scatter_cases = [(dict(dp=4 // n, fsdp=1, sp=n), "sp",
                      _scatter_inputs(n, dim), dim) for n, dim in SCATTER]
    per_rank = workers.run_group(workers.pipeline_cases, 4, gpipe_cases,
                                 scatter_cases, timeout=180)
    return ([piped for piped, _ in per_rank],
            [scattered for _, scattered in per_rank])


def _jax_gpipe(name):
    """The JAX package's gpipe on a pp mesh of S CPU devices: the output
    and the gradient of the sum of its squared output by stage."""
    s = GPIPE[name][0]
    ws, mbs = _gpipe_inputs(name)
    mesh = j_make_mesh(JMeshConfig(fsdp=1, pp=s), devices=jax.devices()[:s])
    out = j_pipeline.gpipe(_stage_fn, jnp.asarray(ws), jnp.asarray(mbs),
                           mesh)
    grads = jax.grad(lambda w: jnp.sum(
        j_pipeline.gpipe(_stage_fn, w, jnp.asarray(mbs), mesh) ** 2))(
            jnp.asarray(ws))
    return np.asarray(out), np.asarray(grads)


@pytest.mark.parametrize("name", list(GPIPE))
def test_gpipe_matches_jax(four_ranks, name):
    """Every rank's gpipe output (the last stage's, summed over pp)
    within 1e-5 of the JAX package's (test_gpipe_matches_sequential's
    tolerance)."""
    want, _ = _jax_gpipe(name)
    i = list(GPIPE).index(name)
    for piped in four_ranks[0]:
        _stage, out, _grad = piped[i]
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(GPIPE))
def test_gpipe_grads_match_jax(four_ranks, name):
    """Each stage's gradient (through the ppermute Function's inverse
    exchange, every rank running the same backward exchanges) within
    1e-4 of the JAX package's gradient of that stage's weights
    (test_gpipe_grads_flow's tolerance), on every replica."""
    _, want = _jax_gpipe(name)
    i = list(GPIPE).index(name)
    stages = set()
    for piped in four_ranks[0]:
        stage, _out, grad = piped[i]
        stages.add(stage)
        np.testing.assert_allclose(grad, want[stage], rtol=1e-4, atol=1e-4)
    assert stages == set(range(GPIPE[name][0]))


@pytest.mark.parametrize("n,dim", SCATTER,
                         ids=[f"n{n}-dim{d}" for n, d in SCATTER])
def test_reduce_scatter_matches_psum_scatter(four_ranks, n, dim):
    """`reduce_scatter` over a group of n (on gloo, an all-reduce and the
    rank's tile) equals the JAX package's `reduce_scatter`
    (`jax.lax.psum_scatter(..., tiled=True)`) of the same per-device
    inputs, tile for tile, within 1e-6."""
    from ray_tpu.parallel.collectives import reduce_scatter as j_rs
    xs = _scatter_inputs(n, dim)
    mesh = j_make_mesh(JMeshConfig(fsdp=1, sp=n), devices=jax.devices()[:n])
    spec = [None] * 3
    spec[0] = "sp"
    out_spec = [None] * 3
    out_spec[dim + 1] = "sp"
    want = np.asarray(shard_map_compat(
        lambda x: j_rs(x[0], "sp", dim)[None], mesh, (P(*spec),),
        P(*out_spec))(jnp.asarray(xs)))[0]
    i = SCATTER.index((n, dim))
    for scattered in four_ranks[1]:
        place, got = scattered[i]
        tile = np.split(want, n, axis=dim)[place]
        np.testing.assert_allclose(got, tile, rtol=1e-6, atol=1e-6)


def test_barrier_concurrent_arrivals():
    """4 actors gang-entering `Barrier.wait` 5 times on the port's
    runtime: the head's atomic kv_incr counts every concurrent arrival,
    so no round hangs (tests/test_parallel.py's barrier test)."""
    import ray_tpu_torch as rt
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    try:
        member = rt.remote(workers.BarrierMember)
        members = [member.remote() for _ in range(4)]
        assert rt.get([m.go.remote("gang", 4, 5) for m in members],
                      timeout=120) == [5] * 4
    finally:
        rt.shutdown()
