"""PyTorch port, compiled graphs (`ray_tpu_torch.dag`) over the port's
channels on the CPU, against the JAX package's (`ray_tpu.dag`).

The seqlock channel cases of `tests/test_dag.py` run through both
packages' `Channel` and must observe the same values. The two-stage
chain runs through the JAX package's compiled DAG and then the port's,
each runtime shut down before the other starts, and the failure message
says which side failed: the same scalar results, pipelined executes in
order, and a numpy pytree over tensor channels equal to the JAX
package's. Then, on one module-scoped port runtime, the cases with no
JAX counterpart: several ops on one actor, the actor serving plain calls
after teardown, torch leaves (fp32, bf16, int64) over tensor channels bit
for bit, pickle channels, and the graphs the port refuses as the JAX
package does. Stage actors live in `tests/test_torch_dist_workers.py`.
No timing is asserted (the card's phase logs compiled against plain
calls).
"""

import threading
import traceback

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu.experimental import channel as j_ch
from ray_tpu_torch.experimental import channel as t_ch
from tests import test_torch_dist_workers as W


@pytest.mark.parametrize("mod", [j_ch, t_ch], ids=["jax", "port"])
def test_channel_roundtrip_and_versions(mod):
    w = mod.Channel(create=True, capacity=1 << 16)
    r = mod.Channel(w.path)
    seen = []
    try:
        w.write({"a": 1})
        seen.append(r.read())
        w.write([1, 2, 3])
        seen.append(r.read())
        with pytest.raises(TimeoutError):
            r.read(timeout=0.1)  # no new version
        r2 = mod.Channel(w.path)  # a second cursor sees the latest value
        seen.append(r2.read())
        r2.close()
    finally:
        w.close_writer()
        with pytest.raises(mod.ChannelClosedError):
            r.read(timeout=1.0)
        r.close()
        w.close()
        w.unlink()
    assert seen == [{"a": 1}, [1, 2, 3], [1, 2, 3]]


@pytest.mark.parametrize("mod", [j_ch, t_ch], ids=["jax", "port"])
def test_channel_concurrent_writer_reader(mod):
    w = mod.Channel(create=True, capacity=1 << 16)
    r = mod.Channel(w.path)
    got = []

    def reader():
        try:
            while True:
                got.append(r.read(timeout=10.0))
        except mod.ChannelClosedError:
            pass

    t = threading.Thread(target=reader)
    t.start()
    for i in range(50):
        w.write(i)
    w.close_writer()
    t.join(timeout=10)
    assert got == list(range(50))  # backpressure: nothing is lost
    r.close()
    w.close()
    w.unlink()


def _chain(mod, dag_mod):
    """The two-stage chain of tests/test_dag.py and a numpy pytree over
    tensor channels, through `mod`'s runtime and compiled DAG."""
    out = {}
    a = mod.remote(W.DagStage).remote(10)
    b = mod.remote(W.DagStage).remote(100)
    with dag_mod.InputNode() as inp:
        dag = b.step.bind(a.step.bind(inp))
    compiled = dag.experimental_compile()
    try:
        out["first"] = [compiled.execute(1).get(timeout=60),
                        compiled.execute(2).get(timeout=60)]
        refs = [compiled.execute(i) for i in range(3, 8)]
        out["pipelined"] = [r.get(timeout=60) for r in refs]
    finally:
        compiled.teardown()
    out["calls"] = mod.get([a.num_calls.remote(), b.num_calls.remote()],
                           timeout=60)
    s, u = mod.remote(W.DagStage).remote(2.0), mod.remote(
        W.DagStage).remote(10.0)
    with dag_mod.InputNode() as inp:
        dag = u.scale.bind(s.scale.bind(inp))
    compiled = dag.experimental_compile(buffer_size_bytes=8 << 20,
                                        channel_type="tensor")
    try:
        x = np.arange(40000, dtype=np.float32)
        res = [compiled.execute({"x": x * k, "hops": 0}).get(timeout=60)
               for k in (1, 3)]
        out["tensor"] = [(r["x"].copy(), r["hops"], r["x"].flags.owndata
                          or r["x"].base is None) for r in res]
    finally:
        compiled.teardown()
    return out


def test_compiled_pipeline_two_actors_jax_then_port():
    """The same chain through the JAX package's compiled DAG, then the
    port's, one runtime at a time: the same results."""
    import ray_tpu.dag as j_dag
    import ray_tpu_torch.dag as t_dag
    results = {}
    for side, mod, dag_mod in (("JAX package", ray_tpu, j_dag),
                               ("port", rt, t_dag)):
        mod.init(num_cpus=4, object_store_memory=64 << 20)
        try:
            results[side] = _chain(mod, dag_mod)
        except Exception:
            pytest.fail(f"the {side}'s compiled pipeline failed:\n"
                        f"{traceback.format_exc()}")
        finally:
            mod.shutdown()
    ref, port = results["JAX package"], results["port"]
    assert ref["first"] == [111, 112], f"JAX package: {ref['first']}"
    assert ref["pipelined"] == [113, 114, 115, 116, 117], ref
    for key in ("first", "pipelined", "calls"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    for (px, ph, po), (jx, jh, _) in zip(port["tensor"], ref["tensor"]):
        np.testing.assert_array_equal(px, jx)
        assert ph == jh == 2 and po   # results are owned copies
    np.testing.assert_array_equal(port["tensor"][1][0],
                                  np.arange(40000, dtype=np.float32) * 60)


@pytest.fixture(scope="module")
def port_rt():
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    yield
    rt.shutdown()


def test_compiled_multi_op_per_actor(port_rt):
    from ray_tpu_torch.dag import InputNode
    a = rt.remote(W.DagStage).remote(5)
    with InputNode() as inp:
        dag = a.twice.bind(a.step.bind(inp))  # both ops on one actor
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(1).get(timeout=60) == 12  # (1 + 5) * 2
    finally:
        compiled.teardown()
    rt.kill(a)


def test_compiled_dag_loop_survives_and_actor_usable_after_teardown(port_rt):
    from ray_tpu_torch.dag import InputNode
    a = rt.remote(W.DagStage).remote(1)
    with InputNode() as inp:
        dag = a.step.bind(inp)
    compiled = dag.experimental_compile()
    try:
        for i in range(20):
            assert compiled.execute(i).get(timeout=60) == i + 1
    finally:
        compiled.teardown()
    # the exec loop exited; the actor serves plain calls again
    assert rt.get(a.num_calls.remote(), timeout=30) == 20
    rt.kill(a)


def _torch_value(k: int):
    g = torch.Generator().manual_seed(k)
    return {"f": torch.randn(3, 5000, generator=g),
            "b": torch.randn(16, 768, generator=g).to(torch.bfloat16),
            "n": torch.arange(16, dtype=torch.int64) + k, "tag": f"t{k}"}


def test_compiled_pipeline_torch_leaves_bit_exact(port_rt):
    """torch leaves through two stage processes over tensor channels: the
    result equals the two stages' ops run in this process, bit for bit,
    with every dtype kept, for several pipelined executes."""
    from ray_tpu_torch.dag import InputNode
    a = rt.remote(W.DagStage).remote(1.5)
    b = rt.remote(W.DagStage).remote(-4.0)
    with InputNode() as inp:
        dag = b.torch_step.bind(a.torch_step.bind(inp))
    compiled = dag.experimental_compile(buffer_size_bytes=4 << 20)
    try:
        refs = [compiled.execute(_torch_value(k)) for k in range(4)]
        got = [r.get(timeout=60) for r in refs]
    finally:
        compiled.teardown()
    sa, sb = W.DagStage(1.5), W.DagStage(-4.0)
    for k, g in enumerate(got):
        want = sb.torch_step(sa.torch_step(_torch_value(k)))
        assert g["tag"] == want["tag"] == f"t{k}"
        for key in ("f", "b", "n"):
            assert isinstance(g[key], torch.Tensor)
            assert g[key].dtype == want[key].dtype, key
            assert W._bits(g[key]) == W._bits(want[key]), (k, key)
    for h in (a, b):
        rt.kill(h)


def test_compiled_pipeline_pickle_channels_still_work(port_rt):
    from ray_tpu_torch.dag import InputNode
    a = rt.remote(W.DagStage).remote(3.0)
    with InputNode() as inp:
        dag = a.scale.bind(inp)
    compiled = dag.experimental_compile(channel_type="pickle")
    try:
        out = compiled.execute({"x": np.ones(10, np.float32),
                                "hops": 0}).get(timeout=60)
        np.testing.assert_array_equal(out["x"], np.full(10, 3.0, np.float32))
        assert out["hops"] == 1
    finally:
        compiled.teardown()
    rt.kill(a)


def test_refused_graphs_match_jax_package(port_rt):
    """What the JAX package refuses to compile, the port refuses alike:
    keyword arguments, a MultiOutputNode, a graph without an InputNode,
    and an unknown channel type."""
    import ray_tpu.dag as j_dag
    import ray_tpu_torch.dag as t_dag
    a = rt.remote(W.DagStage).remote(1)
    with pytest.raises(ValueError, match="positional args only"):
        a.step.bind(x=1)
    with t_dag.InputNode() as inp:
        node = a.step.bind(inp)
    assert isinstance(node, t_dag.ClassMethodNode)
    assert (node.method_name, node.args) == ("step", (inp,))
    with pytest.raises(NotImplementedError, match="MultiOutputNode"):
        t_dag.MultiOutputNode([node]).experimental_compile()
    with pytest.raises(ValueError, match="exactly one InputNode"):
        a.step.bind(1).experimental_compile()
    with pytest.raises(ValueError, match="unknown channel_type"):
        node.experimental_compile(channel_type="nccl")
    for name in ("MultiOutputNode", "InputNode", "CompiledDAG",
                 "ChannelClosedError"):
        assert name in t_dag.__all__ and name in j_dag.__all__
    rt.kill(a)
