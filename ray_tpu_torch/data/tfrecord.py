"""TFRecord + tf.train.Example codec, dependency-free (a copy of the JAX
package's `data/tfrecord.py`: the port reads none of that package).

Parity: reference `data/_internal/datasource/tfrecords_datasource.py` —
the binary streaming format TensorFlow input pipelines use. No
tensorflow import: the record framing (length + masked crc32c) and the
Example proto wire format are small enough to implement directly, which
keeps workers free of a TF runtime.

Record framing (TFRecord spec):
    uint64 length | uint32 masked_crc32c(length) |
    bytes data[length] | uint32 masked_crc32c(data)

Example proto (the subset every producer emits):
    Example{1: Features{1: map<string, Feature>}}
    Feature{1: BytesList | 2: FloatList | 3: Int64List}, each with
    repeated field 1 (floats/ints packed).
"""

from __future__ import annotations

import struct

# ---- crc32c (Castagnoli, reflected poly 0x82F63B78) + TFRecord masking ----

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- varint + proto wire helpers ----


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | wire)
    return bytes(out)


def _len_delimited(field: int, payload: bytes) -> bytes:
    out = bytearray(_tag(field, 2))
    _write_varint(out, len(payload))
    out += payload
    return bytes(out)


# ---- tf.train.Example encode ----


def _encode_feature(value) -> bytes:
    out = bytearray()
    if isinstance(value, (bytes, str)):
        value = [value]
    elif hasattr(value, "tolist"):  # numpy array/scalar
        value = value.tolist()
        if not isinstance(value, list):
            value = [value]
    elif not isinstance(value, (list, tuple)):
        value = [value]
    first = value[0] if value else 0
    if hasattr(first, "item"):  # stray numpy scalar inside a python list
        value = [v.item() if hasattr(v, "item") else v for v in value]
        first = value[0]
    if isinstance(first, (bytes, str)):
        bl = bytearray()
        for v in value:
            if isinstance(v, str):
                v = v.encode()
            bl += _len_delimited(1, v)
        out += _len_delimited(1, bytes(bl))          # BytesList
    elif isinstance(first, float):
        packed = struct.pack(f"<{len(value)}f", *value)
        fl = _len_delimited(1, packed)               # packed floats
        out += _len_delimited(2, fl)                 # FloatList
    else:
        il = bytearray(_tag(1, 2))
        ints = bytearray()
        for v in value:
            _write_varint(ints, int(v) & 0xFFFFFFFFFFFFFFFF)
        _write_varint(il, len(ints))
        il += ints
        out += _len_delimited(3, bytes(il))          # Int64List
    return bytes(out)


def encode_example(row: dict) -> bytes:
    """{name: bytes|str|int|float|list-thereof} -> serialized Example."""
    features = bytearray()
    for name, value in row.items():
        entry = (_len_delimited(1, name.encode())
                 + _len_delimited(2, _encode_feature(value)))
        features += _len_delimited(1, entry)         # map entry
    return _len_delimited(1, bytes(features))        # Example.features


# ---- tf.train.Example parse ----


def _parse_list(buf: bytes, kind: int):
    """kind: 1 bytes / 2 float / 3 int64 -> python list."""
    pos, out = 0, []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if kind == 1 and field == 1 and wire == 2:
            n, pos = _read_varint(buf, pos)
            out.append(buf[pos:pos + n])
            pos += n
        elif kind == 2 and field == 1:
            if wire == 2:  # packed
                n, pos = _read_varint(buf, pos)
                out.extend(struct.unpack(f"<{n // 4}f", buf[pos:pos + n]))
                pos += n
            else:          # unpacked fixed32
                out.append(struct.unpack("<f", buf[pos:pos + 4])[0])
                pos += 4
        elif kind == 3 and field == 1:
            if wire == 2:  # packed
                n, pos = _read_varint(buf, pos)
                end = pos + n
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
            else:
                v, pos = _read_varint(buf, pos)
                if v >= 1 << 63:
                    v -= 1 << 64
                out.append(v)
        else:  # unknown field: skip
            pos = _skip(buf, pos, wire)
    return out


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _parse_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2 and field in (1, 2, 3):
            n, pos = _read_varint(buf, pos)
            return _parse_list(buf[pos:pos + n], field)
        pos = _skip(buf, pos, wire)
    return []


def parse_example(data: bytes) -> dict:
    """Serialized Example -> {name: list-of-values}."""
    out: dict = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:                 # Features
            n, pos = _read_varint(data, pos)
            feats, pos = data[pos:pos + n], pos + n
            fpos = 0
            while fpos < len(feats):
                ftag, fpos = _read_varint(feats, fpos)
                if ftag >> 3 == 1 and ftag & 7 == 2:  # map entry
                    en, fpos = _read_varint(feats, fpos)
                    entry = feats[fpos:fpos + en]
                    fpos += en
                    name = value = None
                    epos = 0
                    while epos < len(entry):
                        etag, epos = _read_varint(entry, epos)
                        ef, ew = etag >> 3, etag & 7
                        if ef == 1 and ew == 2:
                            n2, epos = _read_varint(entry, epos)
                            name = entry[epos:epos + n2].decode()
                            epos += n2
                        elif ef == 2 and ew == 2:
                            n2, epos = _read_varint(entry, epos)
                            value = _parse_feature(entry[epos:epos + n2])
                            epos += n2
                        else:
                            epos = _skip(entry, epos, ew)
                    if name is not None:
                        out[name] = value
                else:
                    fpos = _skip(feats, fpos, ftag & 7)
        else:
            pos = _skip(data, pos, wire)
    return out


# ---- record-level IO ----


def write_records(path: str, payloads) -> int:
    """Write an iterable of serialized records to one TFRecord file."""
    n = 0
    with open(path, "wb") as f:
        for data in payloads:
            hdr = struct.pack("<Q", len(data))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
            n += 1
    return n


def read_records(path: str, verify: bool = True):
    """Yield serialized records from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if not hdr:
                return
            if len(hdr) != 8:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", hdr)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if verify and _masked_crc(hdr) != hcrc:
                raise ValueError(f"TFRecord length crc mismatch in {path}")
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify and _masked_crc(data) != dcrc:
                raise ValueError(f"TFRecord data crc mismatch in {path}")
            yield data
