"""The port's InputMode.TENSORFLOW readers against the JAX package's.

Ports of ``tests/test_readers.py`` (sharding, interleave, shuffle,
prefetch overlap) and of the Parquet tests of ``tests/test_arrow.py`` run
on the port's ``readers`` and ``dfutil``; then parity: over the same files
and seed, ``tfrecord_batches`` (one reader, seeded shuffle) and
``parquet_batches`` yield the JAX package's batches, key for key and dtype
for dtype, and ``device_put=True`` stages tensors on the selected device.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import dfutil, readers, tfrecord
from tensorflowonspark_torch.models import resnet as port_resnet
from tensorflowonspark_torch.sparkapi import LocalSparkContext
from tensorflowonspark_torch.sparkapi.sql import LocalSparkSession
from tensorflowonspark_tpu import readers as ref_readers
from tensorflowonspark_tpu.models import resnet as ref_resnet


def _write_part(path: str, values: list[int]) -> None:
    tfrecord.write_records(
        path,
        (tfrecord.encode_example({"v": (tfrecord.INT64_LIST, [v])})
         for v in values),
    )


@pytest.fixture()
def parts(tmp_path):
    """4 part files, 8 records each, values encode (file, index)."""
    paths = []
    for f in range(4):
        p = str(tmp_path / f"part-{f:05d}")
        _write_part(p, [f * 100 + i for i in range(8)])
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# Ports of tests/test_readers.py
# ---------------------------------------------------------------------------


def test_shard_files_strided_and_disjoint(parts, tmp_path):
    s0 = readers.shard_files(str(tmp_path / "part-*"), 0, 2)
    s1 = readers.shard_files(str(tmp_path / "part-*"), 1, 2)
    assert sorted(s0 + s1) == sorted(parts)
    assert not set(s0) & set(s1)


def test_batches_cover_all_records_once(parts):
    got = []
    for batch in readers.tfrecord_batches(parts, 5, prefetch=2, readers=2):
        got.extend(int(v[0]) for v in batch["v"])
    expected = sorted(f * 100 + i for f in range(4) for i in range(8))
    assert sorted(got) == expected


def test_multiple_epochs_and_drop_remainder(parts):
    batches = list(readers.tfrecord_batches(parts, 5, num_epochs=2,
                                            drop_remainder=True, prefetch=0))
    # 64 records over 2 epochs → 12 full batches of 5 per epoch
    assert len(batches) == 12
    assert all(len(b["v"]) == 5 for b in batches)


def test_shuffle_changes_order_but_not_content(parts):
    plain = [int(v[0]) for b in readers.tfrecord_batches(parts, 64, prefetch=0)
             for v in b["v"]]
    shuffled = [int(v[0]) for b in readers.tfrecord_batches(
        parts, 64, shuffle_buffer=32, shuffle_files=True, seed=7, prefetch=0)
        for v in b["v"]]
    assert sorted(shuffled) == sorted(plain)
    assert shuffled != plain


@pytest.mark.parametrize("n_readers", [1, 2])
def test_reader_error_surfaces(tmp_path, parts, n_readers):
    bad = str(tmp_path / "part-bad")
    with open(bad, "wb") as f:
        f.write(b"\x12\x34garbage-not-a-tfrecord")
    with pytest.raises(Exception):
        list(readers.tfrecord_batches(parts + [bad], 4, prefetch=2,
                                      readers=n_readers))


def test_slow_consumer_still_gets_end_sentinel(parts):
    """A consumer slower than the pump must still see the end of the
    dataset when the prefetch queue is full at pump completion."""
    got = []
    for batch in readers.tfrecord_batches(parts, 4, prefetch=1, readers=2):
        time.sleep(0.05)  # pump finishes + fills the queue long before us
        got.extend(int(v[0]) for v in batch["v"])
    assert len(got) == 32


def test_abandoned_iterator_stops_threads(parts):
    """Breaking out of the batch iterator must not leak pump/reader threads."""
    before = {t.name for t in threading.enumerate()}
    it = readers.tfrecord_batches(parts, 4, prefetch=2, readers=2)
    next(it)
    it.close()  # GeneratorExit at the yield → finally → stop + join
    deadline = time.time() + 10
    while time.time() < deadline:
        leaked = {t.name for t in threading.enumerate()} - before
        leaked = {n for n in leaked if n.startswith("tfos-")}
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked


def test_prefetched_is_public_and_propagates_producer_errors():
    """A producer exception must re-raise on the consumer side, after the
    items produced before it — no wedge, no silent truncation."""
    def gen():
        yield 1
        yield 2
        raise RuntimeError("pump blew up")

    got = []
    with pytest.raises(RuntimeError, match="pump blew up"):
        for item in readers.prefetched(gen, 2):
            got.append(item)
    assert got == [1, 2]
    # prefetch <= 0 degrades to the plain generator, same contract
    with pytest.raises(RuntimeError, match="pump blew up"):
        list(readers.prefetched(gen, 0))


def test_prefetch_overlaps_feed_and_compute(parts, tmp_path):
    """With prefetch, wall time ≈ max(feed, compute), not their sum."""
    n_batches = 8
    work_s = 0.03
    big = str(tmp_path / "part-big")
    _write_part(big, list(range(n_batches * 4)))

    def slow_parse(payload):
        time.sleep(work_s / 4)  # 4 records per batch → work_s per batch
        return readers.default_parse(payload)

    def consume(prefetch):
        t0 = time.perf_counter()
        for batch in readers.tfrecord_batches([big], 4, parse_fn=slow_parse,
                                              prefetch=prefetch):
            time.sleep(work_s)  # simulated train step
        return time.perf_counter() - t0

    serial = consume(prefetch=0)
    overlapped = consume(prefetch=2)
    # serial ≈ n*(feed+compute); overlapped ≈ n*max(feed,compute) (+ramp).
    # Assert a conservative 25% improvement to stay robust on loaded CI.
    assert overlapped < serial * 0.75, (serial, overlapped)


# ---------------------------------------------------------------------------
# Ports of the Parquet tests of tests/test_arrow.py
# ---------------------------------------------------------------------------


def test_dataframe_parquet_round_trip(tmp_path):
    sc = LocalSparkContext("local-cluster[2,1,1024]", "arrow-rt")
    spark = LocalSparkSession(sc)
    out = str(tmp_path / "pq")
    try:
        rows = [
            (i, float(i) / 2, f"s{i}", [1.0 * i, 2.0 * i], [i, i + 1])
            for i in range(20)
        ]
        df = spark.createDataFrame(
            rows, ["id", "x", "name", "vec", "idx"]).repartition(2)
        dfutil.saveAsParquet(df, out)

        df2 = dfutil.loadParquet(sc, out)
        assert dict(df2.dtypes) == dict(df.dtypes)  # schema survives exactly
        got = sorted(df2.collect(), key=lambda r: r.id)
        for i, r in enumerate(got):
            assert r.id == i
            assert r.x == pytest.approx(i / 2)
            assert r.name == f"s{i}"
            assert list(r.vec) == pytest.approx([1.0 * i, 2.0 * i])
            assert list(r.idx) == [i, i + 1]
    finally:
        sc.stop()


def test_load_parquet_missing_dir(tmp_path):
    sc = LocalSparkContext("local[1]", "arrow-missing")
    try:
        with pytest.raises(FileNotFoundError):
            dfutil.loadParquet(sc, str(tmp_path / "nope"))
    finally:
        sc.stop()


def _write_parquet_files(tmp_path, n_files=3, rows_per_file=10):
    import pyarrow as pa
    import pyarrow.parquet as pq

    files = []
    k = 0
    for f in range(n_files):
        cols = {
            "x": np.arange(k, k + rows_per_file, dtype=np.float32),
            "label": np.arange(k, k + rows_per_file, dtype=np.int64) % 3,
        }
        k += rows_per_file
        path = str(tmp_path / f"part-r-{f:05d}.parquet")
        # two row groups per file to exercise iter_batches chunking
        pq.write_table(pa.table(cols), path, row_group_size=rows_per_file // 2)
        files.append(path)
    return files


def test_parquet_batches_columnar(tmp_path):
    files = _write_parquet_files(tmp_path)
    batches = list(readers.parquet_batches(files, batch_size=8, prefetch=2))
    assert [len(b["x"]) for b in batches] == [8, 8, 8, 6]  # 30 rows total
    all_x = np.concatenate([b["x"] for b in batches])
    np.testing.assert_array_equal(all_x, np.arange(30, dtype=np.float32))
    assert batches[0]["label"].dtype == np.int64


def test_parquet_batches_drop_remainder_columns_epochs(tmp_path):
    files = _write_parquet_files(tmp_path)
    batches = list(readers.parquet_batches(
        files, batch_size=8, drop_remainder=True, columns=["x"],
        num_epochs=2, prefetch=0))
    assert len(batches) == 6  # 3 full batches per epoch, remainder dropped
    assert all(set(b) == {"x"} for b in batches)
    np.testing.assert_array_equal(batches[3]["x"], batches[0]["x"])


def test_parquet_batches_device_put_callable(tmp_path):
    files = _write_parquet_files(tmp_path, n_files=1, rows_per_file=8)
    staged = []

    def stage(batch):
        staged.append(True)
        return {k: v * 2 for k, v in batch.items()}

    batches = list(readers.parquet_batches(files, batch_size=4,
                                           device_put=stage))
    assert staged and len(batches) == 2
    np.testing.assert_array_equal(batches[0]["x"],
                                  np.arange(4, dtype=np.float32) * 2)


def test_parquet_batches_glob_and_shard(tmp_path):
    _write_parquet_files(tmp_path)
    pattern = str(tmp_path / "part-r-*.parquet")
    shard = readers.shard_files(pattern, task_index=1, num_shards=3)
    assert len(shard) == 1 and shard[0].endswith("part-r-00001.parquet")
    batches = list(readers.parquet_batches(shard, batch_size=5))
    np.testing.assert_array_equal(
        np.concatenate([b["x"] for b in batches]),
        np.arange(10, 20, dtype=np.float32))


def test_save_parquet_decimal_column(tmp_path):
    import decimal

    from tensorflowonspark_torch.sparkapi.sql import StructField, StructType

    sc = LocalSparkContext("local[1]", "arrow-dec")
    spark = LocalSparkSession(sc)
    out = str(tmp_path / "pq")
    try:
        rows = [(i, decimal.Decimal(f"{i}.25")) for i in range(4)]
        df = spark.createDataFrame(rows, StructType([
            StructField("id", "bigint"),
            StructField("amount", "decimal(10,2)"),
        ]))
        # decimal columns save as float64; Decimal cells must be converted,
        # not crash pyarrow
        dfutil.saveAsParquet(df, out)
        got = sorted(dfutil.loadParquet(sc, out).collect(),
                     key=lambda r: r.id)
        assert [float(r.amount) for r in got] == [0.25, 1.25, 2.25, 3.25]
    finally:
        sc.stop()


def test_parquet_batches_list_columns_stack_rectangular(tmp_path):
    """array<T> columns (dfutil.saveAsParquet's criteo-style cat vectors)
    must come back as (N, k) numeric arrays, not dtype=object."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "part-r-00000.parquet")
    cats = [[i, i + 1, i + 2] for i in range(9)]
    pq.write_table(
        pa.table({
            "cat": pa.array(cats, type=pa.list_(pa.int32())),
            "vec": pa.array([[float(i)] * 4 for i in range(9)],
                            type=pa.list_(pa.float32())),
            "label": np.arange(9, dtype=np.int64),
        }),
        path, row_group_size=4)  # multiple row groups → sliced list arrays
    batches = list(readers.parquet_batches([path], batch_size=4))
    assert [len(b["label"]) for b in batches] == [4, 4, 1]
    for b in batches:
        assert b["cat"].dtype == np.int32 and b["cat"].ndim == 2
        assert b["cat"].shape[1] == 3
        assert b["vec"].dtype == np.float32 and b["vec"].shape[1] == 4
    np.testing.assert_array_equal(batches[0]["cat"][1], [1, 2, 3])
    np.testing.assert_array_equal(batches[2]["cat"][0], [8, 9, 10])


def test_parquet_batches_ragged_and_null_columns_fail_loudly(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    ragged = str(tmp_path / "ragged.parquet")
    pq.write_table(
        pa.table({"cat": pa.array([[1, 2], [3]], type=pa.list_(pa.int32()))}),
        ragged)
    with pytest.raises(ValueError, match="ragged"):
        list(readers.parquet_batches([ragged], batch_size=2, prefetch=0))

    nulls = str(tmp_path / "nulls.parquet")
    pq.write_table(
        pa.table({"x": pa.array([1.0, None, 3.0], type=pa.float32())}),
        nulls)
    with pytest.raises(ValueError, match="null"):
        list(readers.parquet_batches([nulls], batch_size=2, prefetch=0))


def test_parquet_batches_string_column_fails_loudly(tmp_path):
    """A string scalar column would come back dtype=object from to_numpy;
    it must raise naming the file and column."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    p = str(tmp_path / "strings.parquet")
    pq.write_table(
        pa.table({"x": pa.array([1.0, 2.0], type=pa.float32()),
                  "label": pa.array(["cat", "dog"])}),
        p)
    with pytest.raises(ValueError, match="label.*non-numeric"):
        list(readers.parquet_batches([p], batch_size=2, prefetch=0))


def test_parquet_batches_fixed_size_list_column(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "fixed.parquet")
    vals = pa.array(np.arange(12, dtype=np.float32))
    pq.write_table(
        pa.table({"v": pa.FixedSizeListArray.from_arrays(vals, 3)}), path)
    (batch,) = list(readers.parquet_batches([path], batch_size=4))
    assert batch["v"].shape == (4, 3) and batch["v"].dtype == np.float32
    np.testing.assert_array_equal(batch["v"][2], [6.0, 7.0, 8.0])


def test_parquet_batches_schema_drift_raises(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    a = str(tmp_path / "a.parquet")
    b = str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"x": np.arange(4, dtype=np.float32),
                             "label": np.arange(4)}), a)
    pq.write_table(pa.table({"x": np.arange(4, dtype=np.float32)}), b)
    with pytest.raises(ValueError, match="columns"):
        list(readers.parquet_batches([a, b], batch_size=16, prefetch=0))


# ---------------------------------------------------------------------------
# Parity with the JAX package, and the port's staging
# ---------------------------------------------------------------------------


def _assert_same_batches(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the same keys, in the same order
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_tfrecord_batches_equal_the_jax_packages(tmp_path, drop_remainder):
    """ResNet's records, one reader, a seeded shuffle buffer, shuffled
    files, two epochs: the same batches in the same order."""
    files = port_resnet.write_synthetic_tfrecords(str(tmp_path), 27, 3, 8,
                                                  seed=1)
    kwargs = dict(parse_fn=port_resnet.tfrecord_parse_fn(8), num_epochs=2,
                  readers=1, shuffle_buffer=6, shuffle_files=True, seed=3,
                  drop_remainder=drop_remainder, prefetch=2)
    got = list(readers.tfrecord_batches(files, 4, **kwargs))
    kwargs["parse_fn"] = ref_resnet.tfrecord_parse_fn(8)
    want = list(ref_readers.tfrecord_batches(files, 4, **kwargs))
    _assert_same_batches(got, want)
    assert len(got) == (2 * 6 if drop_remainder else 2 * 7)
    assert got[0]["image"].dtype == np.float32
    assert got[0]["label"].dtype == np.int32


def test_default_parse_batches_equal_the_jax_packages(parts):
    got = list(readers.tfrecord_batches(parts, 5, shuffle_buffer=9, seed=2,
                                        prefetch=0))
    want = list(ref_readers.tfrecord_batches(parts, 5, shuffle_buffer=9,
                                             seed=2, prefetch=0))
    _assert_same_batches(got, want)


def _criteo_parquet(tmp_path) -> list:
    """A criteo-shaped DataFrame saved by the port's ``dfutil`` as two
    Parquet part files."""
    from tensorflowonspark_torch.examples import criteo_pipeline

    sc = LocalSparkContext("local[1]", "parquet-parity")
    out = str(tmp_path / "pq")
    try:
        df = LocalSparkSession(sc).createDataFrame(
            criteo_pipeline.synth_criteo(70, 50, seed=4),
            ["dense", "cat", "label"]).repartition(2)
        dfutil.saveAsParquet(df, out)
    finally:
        sc.stop()
    return readers.shard_files(out + "/part-*.parquet", 0, 1)


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_parquet_batches_equal_the_jax_packages(tmp_path, drop_remainder):
    files = _criteo_parquet(tmp_path)
    assert len(files) == 2
    kwargs = dict(num_epochs=2, shuffle_files=True, seed=5,
                  drop_remainder=drop_remainder, prefetch=2)
    got = list(readers.parquet_batches(files, 16, **kwargs))
    want = list(ref_readers.parquet_batches(files, 16, **kwargs))
    _assert_same_batches(got, want)
    assert got[0]["dense"].shape == (16, 13)
    assert got[0]["cat"].shape == (16, 26)
    assert got[0]["label"].shape == (16,)


def test_device_put_true_stages_tensors_on_the_selected_device(
        parts, monkeypatch):
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    batches = list(readers.tfrecord_batches(parts, 8, device_put=True))
    host = list(readers.tfrecord_batches(parts, 8))
    assert len(batches) == len(host) == 4
    for b, h in zip(batches, host):
        assert isinstance(b["v"], torch.Tensor)
        assert b["v"].device == torch.device("cpu")
        np.testing.assert_array_equal(b["v"].numpy(), h["v"])


def test_device_put_true_raises_without_a_card(parts, monkeypatch):
    """The stager picks its device through ``util.select_device``: a card
    request on a host without one raises, it never stages on the CPU."""
    monkeypatch.delenv("TFOS_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        list(readers.tfrecord_batches(parts, 8, device_put=True))


def test_reader_records_counter_and_epoch_events(parts):
    from tensorflowonspark_torch import obs

    counter = obs.counter("reader_records_total")
    before = counter.value
    t0 = time.time() * 1e6
    batches = list(readers.tfrecord_batches(parts, 5, num_epochs=2,
                                            prefetch=0))
    assert sum(len(b["v"]) for b in batches) == 64
    assert counter.value - before == 64
    epochs = [e for e in obs.get_tracer().snapshot()
              if e.get("name") == "readers.epoch" and e.get("ts", 0) >= t0]
    assert sorted(e["attrs"]["epoch"] for e in epochs) == [0, 1]
    assert all(e["attrs"]["files"] == 4 for e in epochs)


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("skip", [0, 3, 7, 14])
def test_skip_batches_drops_the_first_batches_unparsed(parts, skip,
                                                       drop_remainder):
    """A restart's reader: the stream after its first ``skip`` batches,
    across epochs, shuffle and a partial tail, with no skipped record
    parsed."""
    parsed = []

    def parse(payload):
        parsed.append(payload)
        return readers.default_parse(payload)

    kwargs = dict(num_epochs=2, readers=1, shuffle_buffer=9,
                  shuffle_files=True, seed=4, drop_remainder=drop_remainder,
                  prefetch=2)
    full = list(readers.tfrecord_batches(parts, 5, **kwargs))
    got = list(readers.tfrecord_batches(parts, 5, parse_fn=parse,
                                        skip_batches=skip, **kwargs))
    assert len(full) == (12 if drop_remainder else 14)
    if skip < len(full):
        _assert_same_batches(got, full[skip:])
    else:
        assert got == []
    # each record of a kept batch once (and a dropped tail's, which the
    # full stream parses too); none of a skipped batch's
    kept = sum(len(b["v"]) for b in full[skip:])
    tails = 2 * (32 % 5) if drop_remainder else 0
    assert kept <= len(parsed) <= kept + tails
