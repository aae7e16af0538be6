"""PyTorch port, the data library's numpy half on the CPU: TFRecord, Avro,
WebDataset and image files, `from_torch`, and the preprocessors, against
the JAX package's `ray_tpu.data` on the same inputs.

One module-scoped runtime of each package in this process. Files are
written by one package and read by the other with equal rows, and the
same rows give the same TFRecord bytes. Rows are compared as in
`tests/test_torch_data.py` (`_same`): integers, strings and bytes
exactly, floats within 1e-12 relative. Every preprocessor is fit on each
package's dataset of the same rows: its fitted state must equal the JAX
package's (floats within 1e-12 relative; categories, vocabularies, bin
edges from the same min and max exactly) and its transformed rows too,
with encoded and hashed columns exact. Nothing is downloaded; each test
writes its own files under tmp_path.
"""

import io
import math
import os
import tarfile

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import data as j_rd
from ray_tpu.data import avro as j_avro
from ray_tpu.data import preprocessors as j_pp
from ray_tpu.data import tfrecord as j_tfr
from ray_tpu_torch import data as t_rd
from ray_tpu_torch.data import avro as t_avro
from ray_tpu_torch.data import preprocessors as t_pp
from ray_tpu_torch.data import tfrecord as t_tfr
from tests import test_torch_dist_workers as W
from tests.test_torch_data import REL, _same


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, object_store_memory=64 << 20)
    rt.init(num_cpus=4, object_store_memory=64 << 20)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def _rows_by(rows, key):
    return sorted(rows, key=lambda r: r[key])


TFR_ROWS = [{"idx": i, "name": f"row-{i}", "score": float(i) / 2,
             "vec": [i, i + 1, i + 2]} for i in range(20)]


def test_tfrecord_roundtrip_and_bytes_equal_jax_package(runtimes, tmp_path):
    """write_tfrecord -> read_tfrecord in each package: the JAX package's
    rows, the same file bytes shard by shard, and each package reads the
    other's files to the same rows."""
    assert t_tfr._crc32c(b"123456789") == 0xE3069283  # RFC 3720 vector
    outs = {}
    for name, rd in (("jax", j_rd), ("port", t_rd)):
        outs[name] = str(tmp_path / name)
        rd.from_items(TFR_ROWS, override_num_blocks=2).write_tfrecord(
            outs[name])
    files = sorted(os.listdir(outs["jax"]))
    assert files == sorted(os.listdir(outs["port"])) == [
        "part-00000.tfrecord", "part-00001.tfrecord"]
    for f in files:
        with open(os.path.join(outs["jax"], f), "rb") as a, open(
                os.path.join(outs["port"], f), "rb") as b:
            assert a.read() == b.read(), f
    want = _rows_by(j_rd.read_tfrecord(outs["jax"]).take_all(), "idx")
    for rd, src in ((t_rd, "port"), (t_rd, "jax"), (j_rd, "port")):
        got = _rows_by(rd.read_tfrecord(outs[src]).take_all(), "idx")
        _same(want, got, f"read {src}")
    for i, r in enumerate(want):
        assert r["name"] == f"row-{i}".encode()  # Example strings: bytes
        assert abs(r["score"] - i / 2) < 1e-6
        assert list(r["vec"]) == [i, i + 1, i + 2]


def test_tfrecord_codec_equals_jax_package():
    """encode_example and parse_example on the same rows: equal bytes and
    equal parses (floats as float32, negative ints, bytes lists)."""
    rows = [{"a": -5, "b": [1.5, -2.25], "c": [b"x", b"yz"], "d": "s"},
            {"a": [2 ** 40, -1], "e": np.arange(3, dtype=np.int32)}]
    for row in rows:
        enc = t_tfr.encode_example(row)
        assert enc == j_tfr.encode_example(row)
        assert t_tfr.parse_example(enc) == j_tfr.parse_example(enc)


def test_tfrecord_crc_detects_corruption(runtimes, tmp_path):
    path = str(tmp_path / "one.tfrecord")
    t_tfr.write_records(path, [t_tfr.encode_example({"x": 1})])
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF  # flip a crc byte (the payload stays parseable)
    open(path, "wb").write(bytes(raw))
    for rd in (j_rd, t_rd):
        with pytest.raises(Exception, match="crc"):
            rd.read_tfrecord(path).take_all()
        # verify_crc=False reads the corrupt record without checking
        rows = rd.read_tfrecord(path, verify_crc=False).take_all()
        assert [r["x"] for r in rows] == [1]


def test_avro_roundtrip_both_ways(runtimes, tmp_path):
    """write_avro -> read_avro: the port's rows equal the JAX package's,
    each reads the other's files, and the inferred schemas agree."""
    rows = [{"id": i, "name": f"row{i}", "score": i * 0.5,
             "ok": i % 2 == 0, "blob": bytes([i])} for i in range(50)]
    outs = {}
    for name, rd in (("jax", j_rd), ("port", t_rd)):
        outs[name] = str(tmp_path / name)
        rd.from_items(rows, override_num_blocks=3).write_avro(outs[name])
        assert all(f.endswith(".avro") for f in os.listdir(outs[name]))
    for f in sorted(os.listdir(outs["jax"])):
        sj, rj = j_avro.read_file(os.path.join(outs["jax"], f))
        sp, rp = t_avro.read_file(os.path.join(outs["port"], f))
        assert sj == sp and rj == rp, f
    want = _rows_by(j_rd.read_avro(outs["jax"]).take_all(), "id")
    assert want[7] == {"id": 7, "name": "row7", "score": 3.5, "ok": False,
                       "blob": b"\x07"}
    for rd, src in ((t_rd, "port"), (t_rd, "jax"), (j_rd, "port")):
        _same(want, _rows_by(rd.read_avro(outs[src]).take_all(), "id"), src)


def test_avro_schema_for_block_equals_schema_for_table():
    import pyarrow as pa
    block = {"i": np.arange(3), "f": np.ones(3, np.float32),
             "d": np.ones(3), "b": np.array([True, False, True]),
             "s": np.array(["a", None, "c"], dtype=object),
             "y": np.array([b"x", b"y", b"z"], dtype=object),
             "i8": np.arange(3, dtype=np.int8),
             "u32": np.arange(3, dtype=np.uint32)}
    table = pa.table({k: list(v) for k, v in block.items()})
    assert t_avro.schema_for_block(block) == j_avro.schema_for_table(table)
    with pytest.raises(ValueError, match="tensor column"):
        t_avro.schema_for_block({"t": np.zeros((2, 3))})


@pytest.mark.parametrize("codec", ["deflate", "null"])
def test_avro_codec_complex_types(tmp_path, codec):
    """Arrays, maps, enums, unions; each package reads the other's."""
    schema = {
        "type": "record", "name": "Rec", "fields": [
            {"name": "tags", "type": {"type": "array", "items": "string"}},
            {"name": "counts", "type": {"type": "map", "values": "long"}},
            {"name": "color", "type": {"type": "enum", "name": "Color",
                                       "symbols": ["RED", "GREEN"]}},
            {"name": "maybe", "type": ["null", "double"]},
        ]}
    records = [
        {"tags": ["a", "b"], "counts": {"x": 1, "y": -2},
         "color": "GREEN", "maybe": 2.5},
        {"tags": [], "counts": {}, "color": "RED", "maybe": None},
    ]
    for writer, reader in ((t_avro, t_avro), (t_avro, j_avro),
                           (j_avro, t_avro)):
        path = str(tmp_path / "c.avro")
        writer.write_file(path, schema, records, codec=codec)
        got_schema, got = reader.read_file(path)
        assert got == records and got_schema["name"] == "Rec"


def test_webdataset_roundtrip(runtimes, tmp_path):
    shard = tmp_path / "shard-000.tar"
    with tarfile.open(shard, "w") as tf:
        for i in range(6):
            for ext, data in (("img", b"IMG%d" % i),
                              ("cls", str(i % 3).encode())):
                if ext == "cls" and i == 4:
                    continue          # a sample without a cls part
                info = tarfile.TarInfo(name=f"sample{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
            info = tarfile.TarInfo(name=f"sub/sample{i:04d}.img")
            info.size = 1
            tf.addfile(info, io.BytesIO(b"s"))
    want = j_rd.read_webdataset(str(shard)).take_all()
    got = t_rd.read_webdataset(str(shard)).take_all()
    _same(want, got)
    assert len(got) == 12
    by_key = {r["__key__"]: r for r in got}
    for i in range(6):
        r = by_key[f"sample{i:04d}"]
        assert r["img"] == b"IMG%d" % i
        assert r["cls"] == (None if i == 4 else str(i % 3).encode())
        assert by_key[f"sub/sample{i:04d}"]["img"] == b"s"


def test_read_images(runtimes, tmp_path):
    """PNG files through both packages: the same rows; decode_image gives
    the pixels written; mode and size convert as the JAX package does."""
    from PIL import Image
    rng = np.random.default_rng(0)
    pixels = [rng.integers(0, 255, (8, 6, 3), dtype=np.uint8)
              for _ in range(3)]
    for i, arr in enumerate(pixels):
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    for kw in ({"include_paths": True}, {"mode": "L", "size": (4, 5)}):
        want = _rows_by(j_rd.read_images(str(tmp_path), **kw).take_all(),
                        "image")
        got = _rows_by(t_rd.read_images(str(tmp_path), **kw).take_all(),
                       "image")
        _same(want, got, str(kw))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(t_rd.decode_image(g),
                                          j_rd.decode_image(w))
    rows = t_rd.read_images(str(tmp_path), include_paths=True).take_all()
    rows.sort(key=lambda r: r["path"])
    for arr, row in zip(pixels, rows):
        np.testing.assert_array_equal(t_rd.decode_image(row), arr)
        assert row["path"].endswith(".png")


def test_from_torch(runtimes):
    """A TensorDataset and a map-style dataset of (tensor, label) pairs:
    the JAX package's rows, read lazily in index ranges."""
    from torch.utils.data import TensorDataset
    td = TensorDataset(torch.arange(4))
    want = j_rd.from_torch(td).take_all()
    got = t_rd.from_torch(td).take_all()
    _same(want, got)
    assert int(got[3]["item"][0]) == 3
    rows = np.random.default_rng(1).integers(0, 300, (10, 17)).astype(
        np.int32)
    ds = t_rd.from_torch(W.TorchRows(rows), override_num_blocks=3)
    assert ds.num_blocks() == 3
    batch = ds.take_batch(10)
    assert batch["item"].dtype == np.int32        # the tensor's dtype kept
    np.testing.assert_array_equal(batch["item"], rows)
    _same(j_rd.from_torch(W.TorchRows(rows)).take_all(),
          ds.take_all())
    # (tensor, label) items, which the JAX package's arrow rows refuse
    # ("cannot mix list and non-list"), become object rows here
    pairs = t_rd.from_torch(W.TorchRows(rows, pair=True)).take_all()
    for i, r in enumerate(pairs):
        np.testing.assert_array_equal(r["item"][0], rows[i])
        assert r["item"][1] == i % 3


def test_pyarrow_half_writers_raise(runtimes, tmp_path):
    ds = t_rd.range(3)
    for name in ("write_parquet", "write_csv", "write_json", "write_hudi",
                 "write_iceberg"):
        with pytest.raises(NotImplementedError, match=r"7 \(e\)2"):
            getattr(ds, name)(str(tmp_path / name))


# ---------------- preprocessors ----------------


NUM_ROWS = [{"a": float(i) * 1.5 - 7.0, "b": i % 3, "c": float((i * 7) % 11),
             "color": ["red", "green", "blue"][i % 3],
             "v": float("nan") if i % 5 == 0 else float(i),
             "tags": [["a", "b"], ["b"], []][i % 3],
             "t": ["red fish blue fish", "one fish", "red red"][i % 3],
             "vec": [float(i % 4), 3.0, -1.0 * (i % 2)],
             "pos": 0.5 + i} for i in range(30)]


def _cases(pp):
    return {
        "StandardScaler": lambda: pp.StandardScaler(["a", "c"]),
        "MinMaxScaler": lambda: pp.MinMaxScaler(["a"]),
        "OneHotEncoder": lambda: pp.OneHotEncoder(["color", "b"]),
        "Concatenator": lambda: pp.Concatenator(["a", "b", "c"],
                                                "features"),
        "LabelEncoder": lambda: pp.LabelEncoder("color"),
        "SimpleImputer-mean": lambda: pp.SimpleImputer(["v"]),
        "SimpleImputer-constant": lambda: pp.SimpleImputer(
            ["v"], strategy="constant", fill_value=-9.0),
        "OrdinalEncoder": lambda: pp.OrdinalEncoder(["color", "b"]),
        "MultiHotEncoder": lambda: pp.MultiHotEncoder(["tags"]),
        "UniformKBinsDiscretizer": lambda: pp.UniformKBinsDiscretizer(
            ["a", "c"], bins=4),
        "CustomKBinsDiscretizer": lambda: pp.CustomKBinsDiscretizer(
            ["a"], {"a": [-3.0, 10.0, 20.0]}),
        "MaxAbsScaler": lambda: pp.MaxAbsScaler(["a"]),
        "RobustScaler": lambda: pp.RobustScaler(["a", "c"]),
        "Normalizer-l2": lambda: pp.Normalizer(["vec"]),
        "Normalizer-l1": lambda: pp.Normalizer(["vec"], norm="l1"),
        "Normalizer-max": lambda: pp.Normalizer(["vec"], norm="max"),
        "Tokenizer": lambda: pp.Tokenizer(["t"]),
        "CountVectorizer": lambda: pp.CountVectorizer(["t"]),
        "CountVectorizer-top2": lambda: pp.CountVectorizer(
            ["t"], max_features=2),
        "FeatureHasher": lambda: pp.FeatureHasher(["t"], num_features=8),
        "HashingVectorizer": lambda: pp.HashingVectorizer(
            ["t"], num_features=16, output_column_name="h"),
        "PowerTransformer-yeo-johnson": lambda: pp.PowerTransformer(
            ["a"], power=0.5),
        "PowerTransformer-yeo-johnson-2": lambda: pp.PowerTransformer(
            ["a"], power=2.0),
        "PowerTransformer-box-cox": lambda: pp.PowerTransformer(
            ["pos"], power=0.0, method="box-cox"),
        "Chain": lambda: pp.Chain(
            pp.StandardScaler(["a"]), pp.OneHotEncoder(["color"]),
            pp.Concatenator(["a", "color_red", "color_green",
                             "color_blue"], "features")),
        "Chain-text": lambda: pp.Chain(
            pp.Tokenizer(["t"]), pp.FeatureHasher(
                ["t"], num_features=16, output_column_name="features")),
    }


STATE = ("stats_", "categories_", "classes_", "edges_", "vocabularies_")


def _state(p):
    out = {k: getattr(p, k) for k in STATE if hasattr(p, k)}
    if hasattr(p, "stages"):
        out["stages"] = [_state(s) for s in p.stages]
    return out


def _same_state(a, b, where):
    if isinstance(a, dict):
        assert list(a) == list(b), (where, a, b)
        for k in a:
            _same_state(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], str)):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float):
        assert a == b or math.isclose(a, b, rel_tol=REL), (where, a, b)
    else:
        assert a == b, (where, a, b)   # categories: str / int, exact


def _nan_free(rows):
    """NaN != NaN: the imputer's input rows compare by their repr."""
    return [{k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
             for k, v in r.items()} for r in rows]


def _nan_free_batch(batch):
    return {k: [("nan" if isinstance(x, float) and math.isnan(x) else x)
                for x in np.asarray(v).tolist()] for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(_cases(t_pp)))
def test_preprocessor_equals_jax_package(runtimes, case):
    """Fit on each package's dataset of the same rows (two blocks): the
    same fitted state, and the same transformed rows."""
    jp, tp = _cases(j_pp)[case](), _cases(t_pp)[case]()
    jds = j_rd.from_items(NUM_ROWS, override_num_blocks=2)
    tds = t_rd.from_items(NUM_ROWS, override_num_blocks=2)
    jp.fit(jds)
    assert tp.fit(tds) is tp
    _same_state(_state(jp), _state(tp), case)
    want = jp.transform(jds).take_all()
    got = tp.transform(tds).take_all()
    assert len(got) == len(NUM_ROWS)
    _same(_nan_free(want), _nan_free(got), case)
    batch = {k: np.asarray([r[k] for r in NUM_ROWS[:5]], dtype=object
                           if k in ("color", "t") else None)
             for k in ("a", "b", "c", "color", "v", "t", "pos", "vec")}
    batch["tags"] = np.empty(5, dtype=object)
    batch["tags"][:] = [r["tags"] for r in NUM_ROWS[:5]]
    _same(_nan_free_batch(jp.transform_batch(dict(batch))),
          _nan_free_batch(tp.transform_batch(dict(batch))),
          f"{case} transform_batch")


def test_preprocessor_refuses_unfit_and_bad_options(runtimes):
    ds = t_rd.from_items(NUM_ROWS)
    with pytest.raises(RuntimeError, match="must be fit"):
        t_pp.StandardScaler(["a"]).transform(ds)
    with pytest.raises(ValueError, match="strategy"):
        t_pp.SimpleImputer(["v"], strategy="median")
    with pytest.raises(ValueError, match="norm"):
        t_pp.Normalizer(["vec"], norm="l3")
    with pytest.raises(ValueError, match="method"):
        t_pp.PowerTransformer(["a"], power=1.0, method="log")
    with pytest.raises(NotImplementedError):
        t_pp.Preprocessor().fit(ds)
    # a transform needing no fit runs unfit, as in the JAX package
    out = t_pp.Concatenator(["a", "b"]).transform(ds).take_batch(3)
    assert out["concat_out"].shape == (3, 2)


def test_feature_hasher_is_hashlib_exact():
    """The hashing trick keys on md5's first 8 bytes, as the JAX package
    does: equal matrices for the same tokens."""
    batch = {"t": np.array([["a", "b", "a"], ["zz"], []], dtype=object)}
    jm = j_pp.FeatureHasher(["t"], num_features=7).transform_batch(
        dict(batch))["hashed_features"]
    tm = t_pp.FeatureHasher(["t"], num_features=7).transform_batch(
        dict(batch))["hashed_features"]
    assert jm.tobytes() == tm.tobytes() and tm.sum() == 4
