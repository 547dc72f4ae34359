"""TFRecord file framing + ``tf.train.Example`` wire-format codec.

A port of ``tensorflowonspark_tpu/tfrecord.py``: the same framing, the
same hand-rolled ``tf.train.Example`` codec, byte for byte the same files.

- **Framing**: every record is ``uint64le length ║ uint32le masked-crc32c of
  the length bytes ║ payload ║ uint32le masked-crc32c of the payload`` —
  byte-compatible with files written by TF/the Hadoop connector.
- **CRCs**: what differs from the JAX package.  Every CRC (the framed
  writer and reader, :func:`encode_record`, the gzip sniff) comes from the
  native C++ codec (:mod:`tensorflowonspark_torch.native.tfrecord_native`,
  built with ``g++`` at first use), which also takes over bulk encode and
  decode of plain local files.  If the codec cannot be built or loaded the
  call raises with the reason.  Only ``TFOS_DISABLE_NATIVE=1`` selects the
  Python path, whose CRC comes from the ``google_crc32c`` wheel, imported
  there and nowhere else: this module imports where that wheel is absent.
- **Example codec**: hand-rolled protobuf wire format for the fixed, frozen
  ``tf.train.Example`` schema (Features map of BytesList/FloatList/Int64List)
  — ~the only message TFoS ever exchanges, so no proto toolchain is needed.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Iterable, Iterator

from tensorflowonspark_torch import fs

_MASK_DELTA = 0xA282EAD8

#: set to ``1`` to run the Python codec (CRCs from ``google_crc32c``)
DISABLE_NATIVE_ENV = "TFOS_DISABLE_NATIVE"


def _masked_crc(data: bytes) -> int:
    native = _native()
    if native is not None:
        return native.masked_crc(data)
    import google_crc32c

    crc = google_crc32c.value(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


#: gzip stream magic + the deflate CM byte (0x08, the only method gzip
#: ever specifies).  Detection additionally requires the 12-byte header
#: to FAIL TFRecord framing validation: a plain file whose first record
#: length happens to start 1F 8B 08 (length ≡ 0x088B1F mod 2^24) still
#: carries a valid masked-crc32c of its length bytes at offset 8, which
#: a gzip stream matches with probability 2^-32 — the CRC, not the
#: magic, is the decisive bit
_GZIP_MAGIC = b"\x1f\x8b\x08"


def _looks_gzip(head: bytes) -> bool:
    if not head.startswith(_GZIP_MAGIC):
        return False
    if len(head) >= 12:
        (len_crc,) = struct.unpack("<I", head[8:12])
        if _masked_crc(head[:8]) == len_crc:
            return False  # valid TFRecord framing: magic was coincidence
    return True


def write_records(path: str, records: Iterable[bytes],
                  compression: str | None = None) -> int:
    """Write ``records`` to ``path`` in TFRecord framing; returns count.

    ``path`` may carry a filesystem scheme (``hdfs://``, ``gs://``, …) —
    resolved through :mod:`tensorflowonspark_torch.fs`.  The native C++ codec
    is used for plain local uncompressed paths.  ``compression="gzip"``
    wraps the whole framed stream in gzip (the layout TF's
    ``TFRecordOptions(compression_type="GZIP")`` writes — the frame CRCs
    cover the *uncompressed* bytes), which :func:`read_records` detects by
    magic bytes on the way back.
    """
    if compression not in (None, "", "gzip"):
        raise ValueError(
            f"unsupported compression {compression!r} (want 'gzip' or None)")
    local = fs.local_path(path)
    native = _native()
    if not compression and native is not None and local is not None:
        return native.write_records(local, records)
    n = 0
    with fs.open(path, "wb") as raw:
        if compression == "gzip":
            import gzip

            with gzip.GzipFile(fileobj=raw, mode="wb") as f:
                for rec in records:
                    f.write(encode_record(rec))
                    n += 1
        else:
            for rec in records:
                raw.write(encode_record(rec))
                n += 1
    return n


def encode_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return b"".join([
        header,
        struct.pack("<I", _masked_crc(header)),
        payload,
        struct.pack("<I", _masked_crc(payload)),
    ])


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield record payloads from a TFRecord file (scheme paths supported;
    the mmap'd native codec serves plain local paths).

    Gzip'd part files (written with ``compression="gzip"``, by TF's GZIP
    record options, or just ``gzip``-ed afterwards) are detected by magic
    bytes and decompressed transparently.  The sniff happens
    *before* the native-codec dispatch: the mmap parser cannot see through
    a gzip stream.
    """
    with fs.open(path, "rb") as f:
        head = f.read(12)
    if _looks_gzip(head):
        import gzip

        with fs.open(path, "rb") as raw:
            with gzip.GzipFile(fileobj=raw) as f:
                yield from _read_framed(f, path, verify)
        return
    local = fs.local_path(path)
    native = _native()
    if native is not None and local is not None:
        yield from native.read_records(local, verify)
        return
    with fs.open(path, "rb") as f:
        yield from _read_framed(f, path, verify)


def _read_framed(f, path: str, verify: bool) -> Iterator[bytes]:
    """Parse TFRecord framing from an open (possibly decompressing)
    stream."""
    while True:
        header = f.read(12)
        if not header:
            return
        if len(header) < 12:
            raise IOError(f"{path}: truncated record header")
        (length,) = struct.unpack("<Q", header[:8])
        (len_crc,) = struct.unpack("<I", header[8:12])
        if verify and _masked_crc(header[:8]) != len_crc:
            raise IOError(f"{path}: corrupt record length crc")
        payload = f.read(length)
        if len(payload) < length:
            raise IOError(f"{path}: truncated record payload")
        footer = f.read(4)
        if len(footer) < 4:
            raise IOError(f"{path}: truncated record footer")
        (data_crc,) = struct.unpack("<I", footer)
        if verify and _masked_crc(payload) != data_crc:
            raise IOError(f"{path}: corrupt record data crc")
        yield payload


def _native():
    """The C++ codec binding (built and loaded at first use; raises with
    the reason when it cannot be), or None under
    ``TFOS_DISABLE_NATIVE=1``."""
    if os.environ.get(DISABLE_NATIVE_ENV) == "1":
        return None
    from tensorflowonspark_torch.native import tfrecord_native

    tfrecord_native.load()
    return tfrecord_native


# ---------------------------------------------------------------------------
# Protobuf wire-format primitives (for the frozen Example schema)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


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
    return _varint(field << 3 | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


# ---------------------------------------------------------------------------
# tf.train.Example encode
# ---------------------------------------------------------------------------

#: feature kinds (the Feature oneof field numbers)
BYTES_LIST, FLOAT_LIST, INT64_LIST = 1, 2, 3


def encode_example(features: dict[str, tuple[int, list]]) -> bytes:
    """``{name: (kind, values)}`` → serialized ``tf.train.Example`` bytes.

    ``kind`` is one of :data:`BYTES_LIST` / :data:`FLOAT_LIST` /
    :data:`INT64_LIST`; values are python bytes/float/int lists.
    """
    entries = []
    for name, (kind, values) in sorted(features.items()):
        if kind == BYTES_LIST:
            body = b"".join(_len_delimited(1, v) for v in values)
        elif kind == FLOAT_LIST:  # packed repeated float
            packed = struct.pack(f"<{len(values)}f", *values)
            body = _len_delimited(1, packed) if values else b""
        elif kind == INT64_LIST:  # packed repeated varint
            packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF) for v in values)
            body = _len_delimited(1, packed) if values else b""
        else:
            raise ValueError(f"unknown feature kind {kind}")
        feature_msg = _len_delimited(kind, body)
        entry = _len_delimited(1, name.encode()) + _len_delimited(2, feature_msg)
        entries.append(_len_delimited(1, entry))  # Features.feature map entry
    features_msg = b"".join(entries)
    return _len_delimited(1, features_msg)  # Example.features


# ---------------------------------------------------------------------------
# tf.train.Example decode
# ---------------------------------------------------------------------------


def decode_example(data: bytes) -> dict[str, tuple[int, list]]:
    """Serialized ``tf.train.Example`` → ``{name: (kind, values)}``."""
    features_msg = None
    for field, wire, value in _iter_fields(data):
        if field == 1 and wire == 2:
            features_msg = value
    out: dict[str, tuple[int, list]] = {}
    if features_msg is None:
        return out
    for field, wire, entry in _iter_fields(features_msg):
        if field != 1 or wire != 2:
            continue
        name, feature_msg = None, b""
        for efield, ewire, evalue in _iter_fields(entry):
            if efield == 1:
                name = evalue.decode()
            elif efield == 2:
                feature_msg = evalue
        if name is None:
            continue
        out[name] = _decode_feature(feature_msg)
    return out


def _decode_feature(feature_msg: bytes) -> tuple[int, list]:
    for kind, wire, body in _iter_fields(feature_msg):
        if kind == BYTES_LIST:
            return kind, [v for f, w, v in _iter_fields(body) if f == 1]
        if kind == FLOAT_LIST:
            values: list = []
            for f, w, v in _iter_fields(body):
                if f != 1:
                    continue
                if w == 2:  # packed
                    values.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:  # unpacked fixed32
                    values.append(struct.unpack("<f", v)[0])
            return kind, values
        if kind == INT64_LIST:
            values = []
            for f, w, v in _iter_fields(body):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        n, pos = _read_varint(v, pos)
                        values.append(_signed64(n))
                else:
                    values.append(_signed64(v))
            return kind, values
    return BYTES_LIST, []


def _signed64(n: int) -> int:
    return n - (1 << 64) if n >= 1 << 63 else n


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield ``(field, wire_type, value)``; value is bytes for LEN fields,
    int for varint, raw 4/8 bytes for fixed32/64."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            value = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value
