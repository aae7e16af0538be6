"""PyTorch port, the host collective library (`ray_tpu_torch.util.
collective`) and the internal KV on the CPU, against the JAX package's.

One module-scoped runtime of each package in this process, each with a
group of three `CollectiveMember` actors (`tests/test_torch_dist_workers.
py`). Every op of `tests/test_collective.py` runs on the same numpy
inputs through both: the JAX package's members on numpy arrays, the
port's on torch tensors (and on numpy arrays). The port's results must
equal the JAX package's exactly (fp32 sums of three ranks fold in rank
order in both; bfloat16 against the JAX package's ml_dtypes arrays, bit
for bit), and a torch tensor must hold the result in place afterwards.
"""

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from tests import test_torch_dist_workers as W

WORLD = 3


@pytest.fixture(scope="module")
def groups():
    ray_tpu.init(num_cpus=4, object_store_memory=64 << 20)
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    ref = [ray_tpu.remote(W.CollectiveMember).remote("ray_tpu", r, WORLD)
           for r in range(WORLD)]
    port = [rt.remote(W.CollectiveMember).remote("ray_tpu_torch", r, WORLD)
            for r in range(WORLD)]
    yield ref, port
    rt.shutdown()
    ray_tpu.shutdown()


def _run(mod, members, *args, **kw):
    return mod.get([m.run.remote(*args, **kw) for m in members],
                   timeout=120)


def _both(groups, *args, **kw):
    ref, port = groups
    return (_run(ray_tpu, ref, *args, **kw),
            _run(rt, port, *args, as_torch=True, **kw),
            _run(rt, port, *args, **kw))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), (a, b)


RNG = np.random.default_rng(7)
VALUES = RNG.standard_normal((WORLD, 64)).astype(np.float32)


@pytest.mark.parametrize("op", ["sum", "product", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
def test_allreduce(groups, op, dtype):
    vals = (np.round(VALUES * 10) if dtype == "int64" else VALUES).tolist()
    ref, port_t, port_np = _both(groups, "allreduce", vals, dtype, op=op)
    for r, t, n in zip(ref, port_t, port_np):
        _same(r["out"], t["out"])
        _same(r["out"], t["inplace"])       # the tensor holds the result
        assert t["same"]                     # and is what the op returned
        if dtype != "bfloat16":
            _same(r["out"], n["out"])
            _same(r["out"], n["inplace"])


def test_big_payload_allreduce(groups):
    """512 KiB contributions: past the peer-to-peer threshold, where the
    rendezvous finds no peer endpoint and keeps the KV path."""
    vals = [np.full(1 << 17, r + 1, np.float32).tolist()
            for r in range(WORLD)]
    ref, port_t, _ = _both(groups, "allreduce", vals)
    for r, t in zip(ref, port_t):
        _same(r["out"], t["inplace"])
        assert float(t["inplace"][0]) == 6.0


def test_allgather(groups):
    ref, port_t, port_np = _both(groups, "allgather", VALUES.tolist())
    for r, t, n in zip(ref, port_t, port_np):
        assert len(r) == len(t) == len(n) == WORLD
        for a, b, c in zip(r, t, n):
            _same(a, b)
            _same(a, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_broadcast(groups, dtype):
    ref, port_t, _ = _both(groups, "broadcast", VALUES.tolist(), dtype,
                           src_rank=1)
    for r, t in zip(ref, port_t):
        _same(r["out"], t["inplace"])
        assert t["same"]


def test_reducescatter(groups):
    vals = RNG.standard_normal((WORLD, WORLD, 16)).astype(np.float32)
    ref, port_t, port_np = _both(groups, "reducescatter", vals.tolist())
    for r, t, n in zip(ref, port_t, port_np):
        _same(r["out"], t["inplace"])
        _same(r["out"], n["out"])
        assert t["same"]


def test_reduce(groups):
    ref, port_t, _ = _both(groups, "reduce", VALUES.tolist(), op="max",
                           dst_rank=0)
    _same(ref[0]["out"], port_t[0]["inplace"])
    # other ranks keep their own tensor
    for r in (1, 2):
        _same(port_t[r]["inplace"], VALUES[r])


def test_send_recv(groups):
    ref, port_t, _ = _both(groups, "sendrecv", VALUES.tolist())
    assert ref[0] is None and port_t[0] is None
    _same(ref[1]["out"], port_t[1]["out"])
    _same(port_t[1]["out"], VALUES[0])


def test_barrier(groups):
    ref, port_t, _ = _both(groups, "barrier", VALUES.tolist())
    assert ref == port_t == [0, 1, 2]


def test_p2p_rendezvous_keeps_the_kv_path(groups):
    """On one node no member has a peer endpoint: the rendezvous round
    sends every group to the KV path, in both packages."""
    ref, port = groups
    for mod, ms in ((ray_tpu, ref), (rt, port)):
        assert mod.get([m.p2p_route.remote(1 << 20) for m in ms],
                       timeout=60) == [None] * WORLD


def test_join_group(groups):
    for mod, pkg in ((ray_tpu, "ray_tpu"), (rt, "ray_tpu_torch")):
        f = mod.remote(W.join_collective)
        ranks = mod.get([f.remote(pkg, "mesh0", 3) for _ in range(3)],
                        timeout=60)
        assert sorted(ranks) == [0, 1, 2], pkg


def test_errors():
    from ray_tpu_torch.util import collective as col
    with pytest.raises(RuntimeError, match="not initialized"):
        col.allreduce(torch.zeros(1), group_name="nope")
    with pytest.raises(ValueError, match="out of range"):
        col.init_collective_group(2, 5, group_name="bad")
    with pytest.raises(ValueError, match="unknown backend"):
        col.init_collective_group(2, 0, backend="nccl", group_name="bad")


def test_internal_kv_roundtrip_and_from_worker(groups):
    """The internal KV through the driver and a worker, both packages:
    the same answers."""
    outs = []
    for mod, pkg in ((ray_tpu, "ray_tpu"), (rt, "ray_tpu_torch")):
        import importlib
        kv = importlib.import_module(pkg + ".experimental.internal_kv")
        assert kv._internal_kv_initialized()
        got = [kv._internal_kv_put(b"ik:a", b"1"),
               kv._internal_kv_put(b"ik:a", b"2"),
               kv._internal_kv_get(b"ik:a")]
        kv._internal_kv_put(b"ik:a", b"3", overwrite=False)
        got.append(kv._internal_kv_get(b"ik:a"))
        kv._internal_kv_put(b"ik:b", b"x")
        got.append(sorted(k for k in kv._internal_kv_list(b"ik:")))
        kv._internal_kv_del(b"ik:a")
        got.append(kv._internal_kv_exists(b"ik:a"))
        got.append(kv._internal_kv_take(b"ik:b"))
        got.append(kv._internal_kv_take(b"ik:b"))
        got.append(mod.get(mod.remote(W.internal_kv_from_worker).remote(
            pkg), timeout=60))
        outs.append(got)
    assert outs[0] == outs[1] == [
        False, True, b"2", b"2", [b"ik:a", b"ik:b"], False, b"x", None,
        (b"99", [b"wk:x"])]
