"""PyTorch port, the tensor-channel plane (`ray_tpu_torch.experimental.
channel`) on the CPU, against the JAX package's
(`ray_tpu.experimental.channel`).

The cases of `tests/test_channel_tensor.py` that have a torch
counterpart, with numpy leaves and torch CPU leaves (bfloat16 included):
every value read back equals what was written, bit for bit, and equals
what the JAX package's channel gives on the same numpy pytree. The frame
layout is the JAX package's: a numpy pytree written by both packages
gives equal frame bytes outside the header's epoch and writer-pid fields
and the sidecar pickle, whose skeletons load equal (the placeholder
class's module path differs by package). A CUDA leaf read where no card
is visible raises an error naming the leaf. The cross-node hop seals
the frame into one arena and pulls it over the port's `objxfer`.
"""

import pickle
import struct
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.experimental import channel as j_ch
from ray_tpu_torch.experimental import channel as t_ch
from ray_tpu_torch.experimental.channel import (
    _HDR,
    ChannelClosedError,
    TensorChannel,
    frame_regions,
    get_tensor_object,
    put_tensor_object,
)
from tests import test_torch_dist_workers as W

PICKLE_MAGIC = b"\x80\x05"


def _force_shm_decode(mod, w):
    """Drop the writer's in-process registry entry so a same-process
    reader takes the cross-process (shm decode) path."""
    mod._INPROC.drop(w.path)


def _frame(w) -> bytes:
    length = struct.unpack_from("<QQ", w._mm, 0)[1]
    return bytes(w._mm[_HDR.size:_HDR.size + length])


def _numpy_tree():
    return {"x": np.arange(50000, dtype=np.float32).reshape(100, 500),
            "nested": [np.ones(3000, np.int64), {"k": 7, "s": "hi"}],
            "scalar": 1.25}


def _torch_tree():
    g = torch.Generator().manual_seed(0)
    return {"f": torch.randn(64, 300, generator=g),
            "b": torch.randn(4, 1024, generator=g).to(torch.bfloat16),
            "i": torch.arange(7, dtype=torch.int64),
            "h": torch.randn(33, generator=g).to(torch.float16),
            "tag": "t"}


def _roundtrip(mod, val, **read_kw):
    w = mod.TensorChannel(create=True, capacity=8 << 20)
    r = mod.TensorChannel(w.path)
    try:
        w.write(val)
        _force_shm_decode(mod, w)
        got = r.read(**read_kw)
        frame = _frame(w)
        out = (got, frame)
        if isinstance(got, dict):
            got = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                   for k, v in got.items()}
            out = (got, frame)
        r.release()
        return out
    finally:
        r.close()
        w.close()
        w.unlink()


def test_numpy_pytree_roundtrip_equals_jax_package():
    """A numpy pytree through the shm path: the port's value equals what
    was written and the JAX package's read of the same pytree; leaves
    are read-only views until release()."""
    val = _numpy_tree()
    w = TensorChannel(create=True, capacity=8 << 20)
    r = TensorChannel(w.path)
    try:
        w.write(val)
        _force_shm_decode(t_ch, w)
        got = r.read()
        assert got["x"] is not val["x"] and not got["x"].flags.writeable
        np.testing.assert_array_equal(got["x"], val["x"])
        np.testing.assert_array_equal(got["nested"][0], val["nested"][0])
        assert got["nested"][1] == {"k": 7, "s": "hi"}
        assert got["scalar"] == 1.25
        r.release()
    finally:
        r.close()
        w.close()
        w.unlink()
    ref, _ = _roundtrip(j_ch, _numpy_tree(), copy=True)
    port, _ = _roundtrip(t_ch, _numpy_tree(), copy=True)
    np.testing.assert_array_equal(port["x"], ref["x"])
    np.testing.assert_array_equal(port["nested"][0], ref["nested"][0])
    assert port["nested"][1] == ref["nested"][1]
    assert port["scalar"] == ref["scalar"]


def test_frame_layout_equals_jax_package():
    """The same numpy pytree written by both packages: equal header (bar
    epoch and writer pid), equal leaf table and payload bytes, and meta
    regions whose skeletons load to the same structure."""
    val = {"act": np.arange(100000, dtype=np.float32),
           "ids": np.arange(6000, dtype=np.int64).reshape(2, 3000),
           "step": 3, "small": np.arange(4, dtype=np.int16)}
    _, ref = _roundtrip(j_ch, val)
    _, port = _roundtrip(t_ch, val)
    ri, pi = frame_regions(ref), frame_regions(port)
    for info in (ri, pi):
        info.pop("epoch"), info.pop("writer_pid")
    assert pi["leaves"] == ri["leaves"] and pi["flags"] == ri["flags"]
    assert pi["meta_offset"] == ri["meta_offset"]
    head = t_ch._TC_HDR.size
    assert port[:8] == ref[:8]              # magic, flags
    assert port[24:head - 4] == ref[24:head - 4]   # n_leaves
    assert port[head:pi["meta_offset"]] == ref[head:ri["meta_offset"]]
    for leaf in pi["leaves"]:
        lo, hi = leaf["offset"], leaf["offset"] + leaf["nbytes"]
        assert port[lo:hi] == ref[lo:hi]

    class Skeleton(pickle.Unpickler):
        def find_class(self, module, name):
            if name == "_TensorRef":
                return lambda index, spec: ("leaf", index, spec)
            return super().find_class(module, name)

    import io
    metas = [Skeleton(io.BytesIO(f[i["meta_offset"]:i["meta_offset"]
                                   + i["meta_len"]])).load()
             for f, i in ((ref, ri), (port, pi))]
    smalls = [m.pop("small") for m in metas]
    np.testing.assert_array_equal(smalls[0], smalls[1])
    assert metas[0] == metas[1] == {"act": ("leaf", 0, None),
                                    "ids": ("leaf", 1, None), "step": 3}


def test_torch_leaves_roundtrip_bit_exact():
    """torch CPU leaves (fp32, bf16, fp16, int64) come back as fresh
    writable tensors of their dtype, bit for bit; the read acks at once,
    so the writer proceeds without release()."""
    val = _torch_tree()
    w = TensorChannel(create=True, capacity=4 << 20)
    r = TensorChannel(w.path)
    try:
        w.write(val)
        _force_shm_decode(t_ch, w)
        got = r.read()
        for k in ("f", "b", "i", "h"):
            assert isinstance(got[k], torch.Tensor)
            assert got[k].dtype == val[k].dtype, k
            assert got[k].shape == val[k].shape, k
            assert W._bits(got[k]) == W._bits(val[k]), k
            assert got[k].data_ptr() != val[k].data_ptr()
        assert got["tag"] == "t"
        info = frame_regions(_frame(w))
        assert [(d["dtype"], d["kind"]) for d in info["leaves"]] == [
            ("float32", 1), ("bfloat16", 1), ("int64", 1), ("float16", 1)]
        got["f"].add_(1.0)            # owned: writable, no channel alias
        w.write(val, timeout=5.0)
    finally:
        r.close()
        w.close()
        w.unlink()


def test_bf16_tensor_matches_jax_package_bfloat16_array():
    """A bf16 tensor and the JAX package's ml_dtypes bfloat16 array of the
    same values cross with the same leaf bytes and dtype name."""
    import ml_dtypes
    vals = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    a = vals.astype(ml_dtypes.bfloat16)
    assert W._bits(t) == a.tobytes()
    ref, rframe = _roundtrip(j_ch, {"v": a}, copy=True)
    port, pframe = _roundtrip(t_ch, {"v": t})
    (rl,), (pl,) = frame_regions(rframe)["leaves"], frame_regions(
        pframe)["leaves"]
    assert rl["dtype"] == pl["dtype"] == "bfloat16"
    assert rl["shape"] == pl["shape"] and rl["nbytes"] == pl["nbytes"]
    assert pframe[pl["offset"]:pl["offset"] + pl["nbytes"]] == rframe[
        rl["offset"]:rl["offset"] + rl["nbytes"]]
    assert W._bits(port["v"]) == ref["v"].tobytes()


def test_no_pickle_bytes_on_tensor_frames():
    """Tensor leaf bytes, numpy and torch, cross outside any pickle
    stream; the only pickle in the frame is the declared sidecar."""
    w = TensorChannel(create=True, capacity=4 << 20)
    try:
        arr = np.zeros(100000, dtype=np.float32)
        ten = torch.zeros(50000, dtype=torch.bfloat16)
        w.write({"activation": arr, "bf": ten, "step": 3})
        frame = _frame(w)
        info = frame_regions(frame)
        a, b = info["leaves"]
        assert (a["dtype"], a["shape"], b["dtype"], b["shape"]) == (
            "float32", (100000,), "bfloat16", (50000,))
        assert frame[a["offset"]:a["offset"] + a["nbytes"]] == arr.tobytes()
        assert frame[b["offset"]:b["offset"] + b["nbytes"]] == W._bits(ten)
        meta = frame[info["meta_offset"]:
                     info["meta_offset"] + info["meta_len"]]
        assert meta.startswith(PICKLE_MAGIC)
        assert frame.count(PICKLE_MAGIC) == 1
    finally:
        w.close()
        w.unlink()


def test_inproc_handoff_returns_same_object_and_skips_staging():
    w = TensorChannel(create=True, capacity=1 << 16, inproc=True)
    r = TensorChannel(w.path)
    try:
        big = torch.ones((512, 512), dtype=torch.float32)  # 1 MB > capacity
        w.write({"t": big})
        got = r.read()
        assert got["t"] is big
        assert struct.unpack_from("<QQ", w._mm, 0)[1] == t_ch._TC_HDR.size
    finally:
        r.close()
        w.close()
        w.unlink()


def test_inproc_frame_rejected_cross_process():
    w = TensorChannel(create=True, capacity=1 << 16, inproc=True)
    r = TensorChannel(w.path)
    try:
        w.write({"v": torch.arange(10)})
        _force_shm_decode(t_ch, w)
        with pytest.raises(RuntimeError, match="in-proc tensor channel"):
            r.read(timeout=2.0)
    finally:
        r.close()
        w.close()
        w.unlink()


def test_epoch_guard_rejects_stale_registry_entry():
    w = TensorChannel(create=True, capacity=1 << 20)
    r = TensorChannel(w.path)
    try:
        val = {"x": torch.arange(20000, dtype=torch.int32)}
        w.write(val)
        t_ch._INPROC.publish(w.path, 2, 999, {"x": "wrong"})
        got = r.read()
        assert torch.equal(got["x"], val["x"])
        assert got["x"] is not val["x"]
    finally:
        r.close()
        w.close()
        w.unlink()


def test_writer_overwrite_blocked_while_reader_borrows():
    """A numpy leaf is borrowed until release(): the writer waits."""
    w = TensorChannel(create=True, capacity=4 << 20)
    r = TensorChannel(w.path)
    try:
        w.write({"x": np.full(100000, 7, np.int32)})
        _force_shm_decode(t_ch, w)
        view = r.read()["x"]
        done = []

        def overwrite():
            w.write({"x": np.full(100000, 9, np.int32)}, timeout=30.0)
            done.append(True)

        t = threading.Thread(target=overwrite)
        t.start()
        time.sleep(0.25)
        assert not done, "writer overwrote while the reader held a borrow"
        assert view[0] == 7
        r.release()
        t.join(timeout=10)
        assert done
    finally:
        r.close()
        w.close()
        w.unlink()


@pytest.mark.parametrize("leaf", ["numpy", "torch"])
def test_writer_backpressure_stream_integrity(leaf):
    """50 distinct values through one reader cursor: every value arrives
    intact and in order."""
    w = TensorChannel(create=True, capacity=1 << 20)
    r = TensorChannel(w.path)
    got = []

    def reader():
        try:
            while True:
                v = r.read(timeout=20.0)
                got.append(int(v["a"][0]))
                r.release()
        except ChannelClosedError:
            pass

    t = threading.Thread(target=reader)
    t.start()
    try:
        for i in range(50):
            a = np.full(30000, i, np.int64)
            w.write({"a": a if leaf == "numpy" else torch.from_numpy(a)})
            _force_shm_decode(t_ch, w)
        w.close_writer()
        t.join(timeout=30)
        assert got == list(range(50))
    finally:
        r.close()
        w.close()
        w.unlink()


def test_tensor_channel_close_signals_eof():
    w = TensorChannel(create=True, capacity=1 << 16)
    r = TensorChannel(w.path)
    try:
        w.write({"x": 1})
        assert r.read()["x"] == 1
        w.close_writer()
        with pytest.raises(ChannelClosedError):
            r.read(timeout=5.0)
    finally:
        r.close()
        w.close()
        w.unlink()


def test_small_leaves_ride_sidecar_inline():
    """numpy leaves under tensor_channel_inline_bytes stay in the sidecar
    pickle, as in the JAX package; a torch leaf always takes the leaf
    plane (its own pickle is heavier than a descriptor)."""
    w = TensorChannel(create=True, capacity=1 << 16)
    r = TensorChannel(w.path)
    try:
        w.write({"tiny": np.arange(4, dtype=np.int16), "n": 2,
                 "tiny_t": torch.arange(3, dtype=torch.int16)})
        leaves = frame_regions(_frame(w))["leaves"]
        assert [(d["dtype"], d["kind"]) for d in leaves] == [("int16", 1)]
        _force_shm_decode(t_ch, w)
        got = r.read()
        np.testing.assert_array_equal(got["tiny"],
                                      np.arange(4, dtype=np.int16))
        assert torch.equal(got["tiny_t"], torch.arange(3, dtype=torch.int16))
    finally:
        r.close()
        w.close()
        w.unlink()


def test_cuda_leaf_refused_without_a_card(monkeypatch):
    """A frame that carries a CUDA leaf, read in a process that sees no
    card, raises an error naming the leaf, and never hands it out as a
    CPU tensor. (The writer here stages a CPU tensor under the CUDA kind,
    which its D2H path copies the same way.)"""
    assert not torch.cuda.is_available()
    real = t_ch._leaf_kind
    monkeypatch.setattr(t_ch, "_leaf_kind", lambda v: (
        t_ch._KIND_TORCH_CUDA if isinstance(v, torch.Tensor) else real(v)))
    w = TensorChannel(create=True, capacity=1 << 20)
    r = TensorChannel(w.path)
    try:
        w.write({"h": torch.ones(16, 8, dtype=torch.bfloat16)})
        assert frame_regions(_frame(w))["leaves"][0]["kind"] == 2
        _force_shm_decode(t_ch, w)
        with pytest.raises(RuntimeError, match=r"#0 \(bfloat16\[16, 8\]\)"
                           r".*sees no card"):
            r.read(timeout=5.0)
    finally:
        r.close()
        w.close()
        w.unlink()


@pytest.fixture(scope="module")
def port_rt():
    rt.init(num_cpus=2, object_store_memory=64 << 20)
    yield
    rt.shutdown()


def test_tensor_hop_between_processes(port_rt):
    """A worker reads numpy and torch (bf16 too) leaves that this process
    wrote: equal bytes; torch leaves arrive as tensors; a CUDA leaf in a
    worker without a card is refused."""
    w = TensorChannel(create=True, capacity=4 << 20)
    try:
        ref = rt.remote(W.channel_reader).remote(w.path, 2)
        vals = [{"n": np.arange(20000, dtype=np.float64),
                 "b": torch.arange(9000, dtype=torch.float32).to(
                     torch.bfloat16), "s": "x"},
                {"n": np.ones(5000, np.int8),
                 "b": torch.full((3, 3000), -1.5, dtype=torch.bfloat16),
                 "s": "y"}]
        for v in vals:
            w.write(v, timeout=60)
        got = rt.get(ref, timeout=120)
        for v, g in zip(vals, got):
            assert g["n"] == ("ndarray", str(v["n"].dtype),
                              v["n"].tobytes())
            assert g["b"] == ("Tensor", "torch.bfloat16", W._bits(v["b"]))
            assert g["s"] == ("str", "", v["s"])
    finally:
        w.close()
        w.unlink()


def test_cuda_leaf_refused_in_a_worker_without_a_card(port_rt, monkeypatch):
    real = t_ch._leaf_kind
    monkeypatch.setattr(t_ch, "_leaf_kind", lambda v: (
        t_ch._KIND_TORCH_CUDA if isinstance(v, torch.Tensor) else real(v)))
    w = TensorChannel(create=True, capacity=1 << 20)
    try:
        ref = rt.remote(W.cuda_leaf_reader).remote(w.path)
        w.write({"h": torch.ones(4, dtype=torch.float32)}, timeout=60)
        msg = rt.get(ref, timeout=120)
        assert "CUDA tensor" in msg and "sees no card" in msg, msg
    finally:
        w.close()
        w.unlink()


@pytest.fixture()
def two_stores(tmp_path):
    from ray_tpu_torch.core.object_store import SharedMemoryStore
    a = SharedMemoryStore(str(tmp_path / "arena_a"), size=64 << 20,
                          create=True)
    b = SharedMemoryStore(str(tmp_path / "arena_b"), size=64 << 20,
                          create=True)
    yield a, b
    a.close()
    a.unlink()
    b.close()
    b.unlink()


def test_cross_node_tensor_hop_over_objxfer(two_stores):
    """The writer's arena seals the frame; the reader's pulls it over the
    port's peer protocol and rebuilds it: numpy and torch leaves bit for
    bit, the leaf bytes unpickled at their declared offsets."""
    from ray_tpu_torch.core import objxfer
    src, dst = two_stores
    value = {"act": np.arange(200000, dtype=np.float32), "layer": 3,
             "extra": [np.ones(5000, np.int8)],
             "bf": torch.linspace(-2, 2, 70000).to(torch.bfloat16)}
    oid = put_tensor_object(src, value)
    srv = objxfer._start_python_peer_server(src, "127.0.0.1")
    try:
        addr = ("127.0.0.1", srv.port)
        assert objxfer.fetch_from_peer(dst, addr, oid.binary(), timeout=30.0)
        got = get_tensor_object(dst, oid)
        np.testing.assert_array_equal(got["act"], value["act"])
        np.testing.assert_array_equal(got["extra"][0], value["extra"][0])
        assert got["layer"] == 3
        assert got["bf"].dtype == torch.bfloat16
        assert W._bits(got["bf"]) == W._bits(value["bf"])
        data, meta = dst.get_raw(oid, timeout=5.0)
        try:
            assert meta == b"tensor_frame"
            leaf = frame_regions(data)["leaves"][0]
            assert bytes(data[leaf["offset"]:leaf["offset"]
                              + leaf["nbytes"]]) == value["act"].tobytes()
        finally:
            try:
                data.release()
            except BufferError:
                pass
            dst.release(oid)
    finally:
        srv.stop()
        objxfer._conn_cache.clear()


def test_objxfer_conn_cache_reuses_connections(two_stores, monkeypatch):
    """Sequential pulls of tensor objects ride one cached connection."""
    import socket as socket_mod

    from ray_tpu_torch.core import objxfer
    src, dst = two_stores
    objxfer._conn_cache.clear()
    oids = [put_tensor_object(src, {"x": torch.full((1000,), i,
                                                    dtype=torch.int32)})
            for i in range(8)]
    srv = objxfer._start_python_peer_server(src, "127.0.0.1")
    dials = []
    real_connect = socket_mod.create_connection

    def counting_connect(*a, **kw):
        dials.append(a)
        return real_connect(*a, **kw)

    monkeypatch.setattr(objxfer.socket, "create_connection",
                        counting_connect)
    try:
        addr = ("127.0.0.1", srv.port)
        for oid in oids:
            assert objxfer.fetch_from_peer(dst, addr, oid.binary(),
                                           timeout=30.0)
        assert len(dials) == 1, dials
        for i, oid in enumerate(oids):
            assert int(get_tensor_object(dst, oid)["x"][0]) == i
    finally:
        srv.stop()
        objxfer._conn_cache.clear()
