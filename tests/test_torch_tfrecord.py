"""The port's TFRecord codec and ``dfutil`` against the JAX package's.

The ports of ``tests/test_dfutil.py`` run on the port's modules, then
parity: the port's ``write_records``/``encode_example`` write the same
bytes as the JAX package's, each package reads the other's files, the
native CRC equals ``google_crc32c``'s, a corrupt record raises in both,
building the codec writes under ``tensorflowonspark_torch/_build/`` only,
and the port's ``tfrecord`` imports where ``google_crc32c`` and
``pyarrow`` are absent (the card machine has no ``google_crc32c``).
"""

import gzip as gzip_mod
import os
import struct
import subprocess
import sys

import google_crc32c
import numpy as np
import pytest

from tensorflowonspark_torch import dfutil, tfrecord
from tensorflowonspark_torch.models import resnet as port_resnet
from tensorflowonspark_torch.native import tfrecord_native
from tensorflowonspark_torch.sparkapi import LocalSparkContext
from tensorflowonspark_torch.sparkapi.sql import LocalSparkSession
from tensorflowonspark_tpu import tfrecord as ref_tfrecord
from tensorflowonspark_tpu.models import resnet as ref_resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_masked_crc(data: bytes) -> int:
    crc = google_crc32c.value(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Ports of tests/test_dfutil.py
# ---------------------------------------------------------------------------


def test_example_codec_round_trip():
    features = {
        "ints": (tfrecord.INT64_LIST, [1, -2, 3_000_000_000]),
        "floats": (tfrecord.FLOAT_LIST, [0.5, -1.25]),
        "bytes": (tfrecord.BYTES_LIST, [b"ab", b""]),
    }
    data = tfrecord.encode_example(features)
    assert tfrecord.decode_example(data) == features


def test_record_framing_round_trip_and_crc(tmp_path):
    path = str(tmp_path / "f.tfrecord")
    payloads = [b"hello", b"", b"x" * 10_000]
    assert tfrecord.write_records(path, payloads) == 3
    assert list(tfrecord.read_records(path)) == payloads

    # flip a payload byte: crc check must reject the file
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        list(tfrecord.read_records(bad))
    # verify=False skips crc checks (fast path)
    assert len(list(tfrecord.read_records(bad, verify=False))) == 3


def test_gzip_write_and_magic_byte_read(tmp_path):
    """compression="gzip" on write; read detects the magic bytes and
    decompresses transparently."""
    path = str(tmp_path / "f.tfrecord.gz")
    payloads = [b"hello", b"", b"x" * 10_000]
    assert tfrecord.write_records(path, payloads, compression="gzip") == 3
    assert open(path, "rb").read(2) == b"\x1f\x8b"  # actually gzip on disk
    assert list(tfrecord.read_records(path)) == payloads
    # crc verification still applies to the decompressed frames
    assert len(list(tfrecord.read_records(path, verify=False))) == 3


def test_externally_gzipped_plain_file_reads(tmp_path):
    """A plain TFRecord file gzipped after the fact reads identically —
    detection is by content, not name."""
    plain = str(tmp_path / "f.tfrecord")
    payloads = [b"a", b"bb", b"ccc"]
    tfrecord.write_records(plain, payloads)
    zipped = str(tmp_path / "f.tfrecord.gz")
    with open(plain, "rb") as src, gzip_mod.open(zipped, "wb") as dst:
        dst.write(src.read())
    assert list(tfrecord.read_records(zipped)) == payloads
    # and the uncompressed original still reads through the normal path
    assert list(tfrecord.read_records(plain)) == payloads


def test_gzip_corruption_still_caught(tmp_path):
    path = str(tmp_path / "f.tfrecord.gz")
    tfrecord.write_records(path, [b"hello world"], compression="gzip")
    frames = bytearray(gzip_mod.open(path, "rb").read())
    frames[14] ^= 0xFF  # flip a payload byte inside the framing
    rezipped = str(tmp_path / "bad.tfrecord.gz")
    with gzip_mod.open(rezipped, "wb") as f:
        f.write(bytes(frames))
    with pytest.raises(IOError, match="corrupt"):
        list(tfrecord.read_records(rezipped))


def test_plain_record_with_gzip_like_length_not_misread(tmp_path):
    """A first record of 0x088B1F bytes makes the file START with the gzip
    magic 1F 8B 08 — the valid length-CRC at offset 8 must keep it on the
    framed path."""
    path = str(tmp_path / "adversarial.tfrecord")
    payloads = [b"x" * 0x088B1F, b"tail"]
    tfrecord.write_records(path, payloads)
    assert open(path, "rb").read(3) == b"\x1f\x8b\x08"  # looks like gzip
    got = list(tfrecord.read_records(path))
    assert len(got) == 2 and got[0] == payloads[0] and got[1] == b"tail"


def test_unknown_compression_rejected(tmp_path):
    with pytest.raises(ValueError, match="compression"):
        tfrecord.write_records(str(tmp_path / "f"), [b"x"],
                               compression="zstd")


def test_dataframe_tfrecord_round_trip(tmp_path):
    sc = LocalSparkContext("local-cluster[2,1,1024]", "dfutil-rt")
    spark = LocalSparkSession(sc)
    out = str(tmp_path / "tfr")
    try:
        rows = [
            (i, float(i) / 2, f"s{i}", [1.0 * i, 2.0 * i], [i, i + 1])
            for i in range(20)
        ]
        df = spark.createDataFrame(
            rows, ["id", "x", "name", "vec", "idx"]).repartition(2)
        dfutil.saveAsTFRecords(df, out)

        df2 = dfutil.loadTFRecords(sc, out)
        assert dict(df2.dtypes) == {
            "id": "bigint", "x": "float", "name": "string",
            "vec": "array<float>", "idx": "array<bigint>",
        }
        got = sorted(df2.collect(), key=lambda r: r.id)
        for i, r in enumerate(got):
            assert r.id == i
            assert r.x == pytest.approx(i / 2)
            assert r.name == f"s{i}"
            assert r.vec == pytest.approx([1.0 * i, 2.0 * i])
            assert r.idx == [i, i + 1]
    finally:
        sc.stop()


def test_binary_features_stay_bytes(tmp_path):
    sc = LocalSparkContext("local-cluster[2,1,1024]", "dfutil-bin")
    spark = LocalSparkSession(sc)
    out = str(tmp_path / "tfr")
    try:
        rows = [(b"\x00\xffraw", "text")]
        df = spark.createDataFrame(rows, ["blob", "note"])
        dfutil.saveAsTFRecords(df, out)
        df2 = dfutil.loadTFRecords(sc, out, binary_features=["blob"])
        r = df2.collect()[0]
        assert r.blob == b"\x00\xffraw"  # stays bytes
        assert r.note == "text"  # utf-8 decoded
        assert dict(df2.dtypes)["blob"] == "binary"
    finally:
        sc.stop()


def test_masked_crc_reference_value():
    """Pin the crc masking against the TFRecord spec constant so framing
    stays byte-compatible with TF-written files."""
    header = struct.pack("<Q", 0)
    assert tfrecord._masked_crc(header) == _ref_masked_crc(header)


def test_native_codec_matches_python(tmp_path, monkeypatch):
    # crc parity with the C-accelerated reference wheel
    for blob in [b"", b"a", b"hello world" * 100, bytes(range(256))]:
        assert tfrecord_native.masked_crc(blob) == _ref_masked_crc(blob)

    # file written natively reads back identically through the Python path
    payloads = [b"rec%d" % i * (i + 1) for i in range(50)]
    npath = str(tmp_path / "native.tfrecord")
    assert tfrecord_native.write_records(npath, payloads) == 50
    monkeypatch.setenv(tfrecord.DISABLE_NATIVE_ENV, "1")
    assert list(tfrecord.read_records(npath)) == payloads
    # the Python path writes the same bytes
    ppath = str(tmp_path / "py.tfrecord")
    assert tfrecord.write_records(ppath, payloads) == 50
    monkeypatch.delenv(tfrecord.DISABLE_NATIVE_ENV)
    assert open(ppath, "rb").read() == open(npath, "rb").read()

    # native read of a Python-written file
    assert list(tfrecord_native.read_records(ppath)) == payloads

    # corruption detection
    raw = bytearray(open(ppath, "rb").read())
    raw[20] ^= 0x01
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt|truncated"):
        list(tfrecord_native.read_records(bad))


def test_native_index_rejects_garbage_length(tmp_path):
    """A garbage 8-byte length (~2^64) must not wrap the bounds check."""
    bad = str(tmp_path / "garbage.tfrecord")
    open(bad, "wb").write(struct.pack("<Q", 0xFFFFFFFFFFFFFFFD) + b"\x00" * 8)
    for verify in (True, False):
        with pytest.raises(IOError, match="corrupt|truncated"):
            list(tfrecord_native.read_records(bad, verify=verify))


def test_load_skips_empty_part_files(tmp_path):
    sc = LocalSparkContext("local-cluster[2,1,1024]", "dfutil-empty")
    spark = LocalSparkSession(sc)
    out = str(tmp_path / "tfr")
    try:
        os.makedirs(out)
        tfrecord.write_records(os.path.join(out, "part-r-00000"), [])  # empty
        df = spark.createDataFrame([(1, "a")], ["n", "s"])
        dfutil.saveAsTFRecords(df, str(tmp_path / "tmp2"))
        os.rename(os.path.join(str(tmp_path / "tmp2"), "part-r-00000"),
                  os.path.join(out, "part-r-00001"))
        df2 = dfutil.loadTFRecords(sc, out)
        assert [(r.n, r.s) for r in df2.collect()] == [(1, "a")]
    finally:
        sc.stop()


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def _examples(seed: int, n: int = 40) -> list:
    """``{name: (kind, values)}`` dicts of every kind, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "image": (tfrecord.BYTES_LIST,
                      [rng.integers(0, 256, int(rng.integers(0, 300)),
                                    dtype=np.uint8).tobytes()]),
            "floats": (tfrecord.FLOAT_LIST,
                       [float(v) for v in  # f32 values survive the trip
                        rng.standard_normal(i % 7).astype(np.float32)]),
            "ints": (tfrecord.INT64_LIST,
                     [int(v) for v in rng.integers(-2**40, 2**40, i % 5)]),
            "label": (tfrecord.INT64_LIST, [int(rng.integers(0, 1000))]),
        })
    return out


@pytest.mark.parametrize("compression", [None, "gzip"])
def test_files_are_byte_identical_and_read_both_ways(tmp_path, compression):
    examples = _examples(3)
    port_payloads = [tfrecord.encode_example(e) for e in examples]
    ref_payloads = [ref_tfrecord.encode_example(e) for e in examples]
    assert port_payloads == ref_payloads
    port_path = str(tmp_path / "port.tfrecord")
    ref_path = str(tmp_path / "ref.tfrecord")
    assert tfrecord.write_records(port_path, port_payloads,
                                  compression=compression) == len(examples)
    assert ref_tfrecord.write_records(ref_path, ref_payloads,
                                      compression=compression) == len(examples)
    if compression is None:  # gzip headers carry the file's mtime
        assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    else:
        assert (gzip_mod.open(port_path).read()
                == gzip_mod.open(ref_path).read())
    # each package reads the other's file
    assert list(tfrecord.read_records(ref_path)) == ref_payloads
    assert list(ref_tfrecord.read_records(port_path)) == port_payloads
    assert [tfrecord.decode_example(p) for p in
            ref_tfrecord.read_records(port_path)] == examples
    assert [ref_tfrecord.decode_example(p) for p in
            tfrecord.read_records(ref_path)] == examples


def test_synthetic_imagenet_records_are_byte_identical(tmp_path):
    """``write_synthetic_tfrecords`` draws and writes what the JAX
    package's does, and ``tfrecord_parse_fn`` parses it the same way."""
    port_paths = port_resnet.write_synthetic_tfrecords(
        str(tmp_path / "port"), 10, 3, 8, seed=5)
    ref_paths = ref_resnet.write_synthetic_tfrecords(
        str(tmp_path / "ref"), 10, 3, 8, seed=5)
    assert [os.path.basename(p) for p in port_paths] == [
        os.path.basename(p) for p in ref_paths] == [
        "part-00000", "part-00001", "part-00002"]
    for a, b in zip(port_paths, ref_paths):
        assert open(a, "rb").read() == open(b, "rb").read()
    port_parse = port_resnet.tfrecord_parse_fn(8)
    ref_parse = ref_resnet.tfrecord_parse_fn(8)
    for payload in tfrecord.read_records(port_paths[0]):
        got, want = port_parse(payload), ref_parse(payload)
        assert got["image"].dtype == want["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["label"].dtype == want["label"].dtype == np.int32
        assert got["label"] == want["label"]


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 4096, 150_531])
def test_native_crc_equals_google_crc32c(size):
    rng = np.random.default_rng(size)
    for _ in range(4):
        blob = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert tfrecord_native.masked_crc(blob) == _ref_masked_crc(blob)
        assert tfrecord._masked_crc(blob) == _ref_masked_crc(blob)


def _corrupt(path: str, offset: int) -> str:
    raw = bytearray(open(path, "rb").read())
    raw[offset] ^= 0x40
    bad = path + f".bad{offset}"
    open(bad, "wb").write(bytes(raw))
    return bad


@pytest.mark.parametrize("where", ["length", "length_crc", "payload",
                                   "payload_crc", "truncated"])
def test_corrupt_record_raises_in_both_packages(tmp_path, where):
    payloads = [tfrecord.encode_example(e) for e in _examples(4, n=3)]
    path = str(tmp_path / "f.tfrecord")
    tfrecord.write_records(path, payloads)
    first = 16 + len(payloads[0])  # the second record's frame starts here
    if where == "truncated":
        bad = path + ".cut"
        open(bad, "wb").write(open(path, "rb").read()[:-3])
    else:
        offset = {"length": first + 1, "length_crc": first + 9,
                  "payload": first + 13,
                  "payload_crc": first + 12 + len(payloads[1]) + 1}[where]
        bad = _corrupt(path, offset)
    for read in (tfrecord.read_records, ref_tfrecord.read_records):
        with pytest.raises(IOError, match="corrupt|truncated"):
            list(read(bad))


def test_building_the_codec_writes_only_under_the_port_build_dir():
    """The port's codec compiles into ``tensorflowonspark_torch/_build/``
    (through a temporary name, moved into place) and leaves the JAX
    package's ``native/`` directory as it was."""
    ref_native = os.path.join(REPO, "tensorflowonspark_tpu", "native")

    def listing():
        # the codec's files; the JAX package's other native builds (its
        # inference library, run by other tests) may change meanwhile
        return {f: os.stat(os.path.join(ref_native, f)).st_mtime_ns
                for f in os.listdir(ref_native) if "tfrecord" in f}

    ref_tfrecord._native()  # the JAX package builds its own codec there
    before = listing()
    target = tfrecord_native.library_path()
    assert os.path.dirname(target) == os.path.join(
        REPO, "tensorflowonspark_torch", "_build")
    assert os.path.basename(target).startswith("libtfrecord-")
    built = tfrecord_native.compile_library(target)
    assert built == target and os.path.exists(target)
    assert not [f for f in os.listdir(os.path.dirname(target))
                if f.startswith(os.path.basename(target) + ".tmp")]
    assert listing() == before
    # the freshly built library loads and computes the spec's CRC
    proc = subprocess.run(
        [sys.executable, "-c",
         "import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
         "lib.tfr_masked_crc.restype = ctypes.c_uint; "
         "print(lib.tfr_masked_crc(b'abc', 3))", target],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == _ref_masked_crc(b"abc")


def test_a_codec_that_cannot_build_raises(monkeypatch, tmp_path):
    """No silent Python fallback: a failed build raises with the reason."""
    monkeypatch.setattr(tfrecord_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tfrecord_native.compile_library(str(tmp_path / "lib.so"))


_HIDDEN_IMPORT = r"""
import importlib.abc, sys

class Hide(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("google_crc32c", "pyarrow"):
            raise ImportError(f"{name} hidden")
        return None

sys.meta_path.insert(0, Hide())
for m in [m for m in sys.modules if m.split(".")[0] in ("google_crc32c", "pyarrow")]:
    del sys.modules[m]
from tensorflowonspark_torch import dfutil, readers, tfrecord
from tensorflowonspark_torch.examples import criteo_pipeline, resnet_spark
path = sys.argv[1]
payloads = [tfrecord.encode_example({"v": (tfrecord.INT64_LIST, [i])})
            for i in range(5)]
assert tfrecord.write_records(path, payloads) == 5
assert list(tfrecord.read_records(path)) == payloads
got = [int(b["v"][0, 0]) for b in readers.tfrecord_batches([path], 1)]
assert got == list(range(5)), got
try:
    import pyarrow
except ImportError:
    pass
else:
    raise AssertionError("pyarrow was not hidden")
print("ok", sorted(m for m in sys.modules
                   if m.split(".")[0] in ("google_crc32c", "pyarrow")))
"""


def test_tfrecord_imports_and_runs_without_google_crc32c_or_pyarrow(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "TFOS_DISABLE_NATIVE"}
    proc = subprocess.run(
        [sys.executable, "-c", _HIDDEN_IMPORT, str(tmp_path / "f.tfrecord")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok []"


def test_disable_native_is_the_only_python_path(tmp_path, monkeypatch):
    """``TFOS_DISABLE_NATIVE=1`` reads and writes through Python with
    ``google_crc32c``; the bytes are the native path's."""
    payloads = [tfrecord.encode_example(e) for e in _examples(6, n=12)]
    native_path = str(tmp_path / "native.tfrecord")
    tfrecord.write_records(native_path, payloads)
    monkeypatch.setenv(tfrecord.DISABLE_NATIVE_ENV, "1")
    assert tfrecord._native() is None
    py_path = str(tmp_path / "python.tfrecord")
    tfrecord.write_records(py_path, payloads)
    assert list(tfrecord.read_records(native_path)) == payloads
    assert open(py_path, "rb").read() == open(native_path, "rb").read()
    with pytest.raises(IOError, match="corrupt"):
        list(tfrecord.read_records(_corrupt(py_path, 14)))
