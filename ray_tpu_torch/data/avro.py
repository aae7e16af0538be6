"""Dependency-free Avro Object Container File codec (a copy of the JAX
package's `data/avro.py`, whose `schema_for_table` reads a pyarrow Table:
the port's `schema_for_block` reads a numpy block and gives the same
schema for the same columns).

Parity: reference `data/_internal/datasource/avro_datasource.py` (which
wraps fastavro). fastavro is not in this image, so the binary format is
implemented directly: zigzag-varint primitives, records/arrays/maps/
unions/enums/fixed, and the OCF framing (magic, metadata map, sync-marked
deflate/null blocks) per the Avro 1.11 spec.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# Binary primitives
# ---------------------------------------------------------------------------

def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # zigzag decode


def _write_long(out: io.BytesIO, n: int):
    n = (n << 1) ^ (n >> 63)  # zigzag encode
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated avro bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes):
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# Schema-driven value codec
# ---------------------------------------------------------------------------

def _decode(schema, buf: io.BytesIO, named: dict):
    if isinstance(schema, str):
        if schema in named:
            return _decode(named[schema], buf, named)
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            return buf.read(1) != b"\x00"
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "float":
            return struct.unpack("<f", buf.read(4))[0]
        if t == "double":
            return struct.unpack("<d", buf.read(8))[0]
        if t == "bytes":
            return _read_bytes(buf)
        if t == "string":
            return _read_bytes(buf).decode("utf-8")
        raise ValueError(f"unknown avro type {t!r}")
    if isinstance(schema, list):  # union: long index, then value
        idx = _read_long(buf)
        return _decode(schema[idx], buf, named)
    t = schema["type"]
    if t == "record":
        named[schema.get("name", "")] = schema
        return {f["name"]: _decode(f["type"], buf, named)
                for f in schema["fields"]}
    if t == "enum":
        named[schema.get("name", "")] = schema
        return schema["symbols"][_read_long(buf)]
    if t == "fixed":
        named[schema.get("name", "")] = schema
        return buf.read(schema["size"])
    if t == "array":
        out = []
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:  # negative count: block byte-size follows
                count = -count
                _read_long(buf)
            for _ in range(count):
                out.append(_decode(schema["items"], buf, named))
        return out
    if t == "map":
        out = {}
        while True:
            count = _read_long(buf)
            if count == 0:
                break
            if count < 0:
                count = -count
                _read_long(buf)
            for _ in range(count):
                key = _read_bytes(buf).decode("utf-8")
                out[key] = _decode(schema["values"], buf, named)
        return out
    return _decode(t, buf, named)  # {"type": "long", "logicalType": ...}


def _encode(schema, value, out: io.BytesIO, named: dict):
    if isinstance(schema, str):
        if schema in named:
            return _encode(named[schema], value, out, named)
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            out.write(b"\x01" if value else b"\x00")
        elif t in ("int", "long"):
            _write_long(out, int(value))
        elif t == "float":
            out.write(struct.pack("<f", float(value)))
        elif t == "double":
            out.write(struct.pack("<d", float(value)))
        elif t == "bytes":
            _write_bytes(out, bytes(value))
        elif t == "string":
            _write_bytes(out, str(value).encode("utf-8"))
        else:
            raise ValueError(f"unknown avro type {t!r}")
        return None
    if isinstance(schema, list):
        # Union: pick the first branch the value fits ("null" only for None).
        for idx, branch in enumerate(schema):
            bt = branch if isinstance(branch, str) else branch.get("type")
            if (value is None) == (bt == "null"):
                _write_long(out, idx)
                return _encode(branch, value, out, named)
        raise ValueError(f"no union branch for {value!r} in {schema}")
    t = schema["type"]
    if t == "record":
        named[schema.get("name", "")] = schema
        for f in schema["fields"]:
            _encode(f["type"], value[f["name"]], out, named)
    elif t == "enum":
        _write_long(out, schema["symbols"].index(value))
    elif t == "fixed":
        out.write(bytes(value))
    elif t == "array":
        if value:
            _write_long(out, len(value))
            for item in value:
                _encode(schema["items"], item, out, named)
        _write_long(out, 0)
    elif t == "map":
        if value:
            _write_long(out, len(value))
            for k, v in value.items():
                _write_bytes(out, str(k).encode("utf-8"))
                _encode(schema["values"], v, out, named)
        _write_long(out, 0)
    else:
        _encode(t, value, out, named)
    return None


# ---------------------------------------------------------------------------
# Object Container Files
# ---------------------------------------------------------------------------

def read_file(path: str) -> tuple[dict, list[dict]]:
    """Read one OCF; returns (schema, records)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = io.BytesIO(data)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    meta = {}
    while True:
        count = _read_long(buf)
        if count == 0:
            break
        if count < 0:
            count = -count
            _read_long(buf)
        for _ in range(count):
            key = _read_bytes(buf).decode("utf-8")
            meta[key] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = buf.read(16)
    records = []
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, io.SEEK_CUR)
        n = _read_long(buf)
        size = _read_long(buf)
        payload = buf.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        block = io.BytesIO(payload)
        named: dict = {}
        for _ in range(n):
            records.append(_decode(schema, block, named))
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return schema, records


def write_file(path: str, schema: dict, records: list[dict],
               codec: str = "deflate"):
    """Write one OCF with a single data block."""
    body = io.BytesIO()
    named: dict = {}
    for rec in records:
        _encode(schema, rec, body, named)
    payload = body.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        payload = comp.compress(payload) + comp.flush()
    elif codec != "null":
        raise ValueError(f"unsupported avro codec {codec!r}")
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode())
        _write_bytes(out, v)
    _write_long(out, 0)
    sync = os.urandom(16)
    out.write(sync)
    if records:
        _write_long(out, len(records))
        _write_long(out, len(payload))
        out.write(payload)
        out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


_NUMPY_TO_AVRO = {
    "bool": "boolean", "int8": "int", "int16": "int", "int32": "int",
    "int64": "long", "uint8": "int", "uint16": "int", "uint32": "long",
    "uint64": "long", "float16": "float", "float32": "float",
    "float64": "double",
}


def _object_type(name: str, col) -> str:
    """"string" or "bytes" for an object column of str or bytes values
    (None allowed), as pyarrow types such a column."""
    kinds = {type(v) for v in col if v is not None}
    if kinds == {str}:
        return "string"
    if kinds == {bytes}:
        return "bytes"
    raise ValueError(
        f"column {name!r}: values of types {sorted(k.__name__ for k in kinds)}"
        f" have no avro mapping (supported: numbers, booleans, str, bytes)")


def schema_for_block(block: dict) -> dict:
    """Infer an avro record schema from a numpy block. Every column is a
    ["null", T] union, as every field of a pyarrow Table made from Python
    values is nullable (the JAX package's `schema_for_table`)."""
    fields = []
    for name, col in block.items():
        if col.ndim != 1:
            raise ValueError(
                f"column {name!r}: a tensor column (rows of shape "
                f"{col.shape[1:]}) has no avro mapping")
        if col.dtype == object:
            avro_t = _object_type(name, col)
        else:
            avro_t = _NUMPY_TO_AVRO.get(col.dtype.name)
            if avro_t is None:
                raise ValueError(
                    f"column {name!r}: numpy dtype {col.dtype} has no avro "
                    f"mapping (supported: {sorted(_NUMPY_TO_AVRO)})")
        fields.append({"name": name, "type": ["null", avro_t]})
    return {"type": "record", "name": "Row", "fields": fields}
