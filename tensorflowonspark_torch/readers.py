"""InputMode.TENSORFLOW input pipeline: sharded, parallel, prefetched
TFRecord and Parquet (Arrow columnar) reading.

A port of ``tensorflowonspark_tpu/readers.py``.  Reference anchor: in the
reference this layer *is* ``tf.data`` — ``TFRecordDataset(files).shard(
num_workers, task_index).shuffle(...).interleave(..., num_parallel_reads=
args.readers).batch(...).prefetch(...)`` as hand-written in each example's
``map_fun`` (the ``readers`` knob is ``pipeline.py::HasReaders``).  The
same pipeline is built from threads + queues over
:mod:`tensorflowonspark_torch.tfrecord`:

- **file sharding** by ``task_index`` stride (every node reads a disjoint
  subset of part files);
- **parallel readers**: ``readers`` threads interleave records from several
  files at once (I/O-bound decode overlaps); with one reader the record
  order is deterministic, with more it depends on scheduling;
- **shuffle**: a bounded reservoir of records, files reshuffled per epoch;
- **prefetch**: batches are columnarized (and optionally copied to the
  device) in a pipeline thread ``prefetch`` batches ahead of the consumer,
  so step time approaches ``max(compute, feed)`` instead of their sum.

What differs from the JAX package is the staging (:func:`_stager`):
``device_put=True`` makes each array a tensor on the selected device
through pinned memory and a non-blocking copy; a callable
(``Trainer.shard``) is applied as it is.

:func:`parquet_batches` is the Arrow-columnar sibling: row groups decode
straight to column buffers — no per-row hot loop at all — through the same
prefetch and staging.  ``pyarrow`` is imported inside it only.

Everything is pull-based and bounded; no unbounded buffering.
"""

from __future__ import annotations

import logging
import queue as _queue_mod
import threading
import time as _time_mod
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from tensorflowonspark_torch import fs, tfrecord, util

logger = logging.getLogger(__name__)

_END = object()  # sentinel: a producer finished


def shard_files(
    files: Sequence[str] | str, task_index: int, num_shards: int
) -> list[str]:
    """Deterministic ``task_index``-strided file shard for one node.

    ``files`` may be a list or a glob pattern (scheme paths like
    ``hdfs://…/part-*`` resolve through :mod:`tensorflowonspark_torch.fs`).
    Sorting before striding makes every node's view consistent without
    coordination (same trick the reference's examples used with ``tf.data``
    auto-shard by file).
    """
    if isinstance(files, str):
        files = fs.glob(files)
    ordered = sorted(files)
    if num_shards <= 1:
        return ordered
    return ordered[task_index::num_shards]


def default_parse(payload: bytes) -> dict[str, Any]:
    """Decode a ``tf.train.Example`` into ``{name: list-of-values}``."""
    return {k: v for k, (_, v) in tfrecord.decode_example(payload).items()}


def _columnarize(rows: list[dict[str, Any]]) -> dict[str, np.ndarray]:
    cols: dict[str, np.ndarray] = {}
    for name in rows[0]:
        cols[name] = np.asarray([r[name] for r in rows])
    return cols


class _ReaderPool:
    """``readers`` threads pulling files off a queue, records into a queue."""

    def __init__(self, files: list[str], readers: int, capacity: int):
        self._files: _queue_mod.Queue = _queue_mod.Queue()
        for f in files:
            self._files.put(f)
        self.records: _queue_mod.Queue = _queue_mod.Queue(maxsize=capacity)
        self._n = max(1, readers)
        self._stop = threading.Event()
        # reader exceptions land here; _record_stream re-raises after all
        # producers finish so a corrupt file fails the dataset instead of
        # silently truncating it
        self.errors: list[BaseException] = []
        self._threads = [
            threading.Thread(target=self._read_loop, daemon=True,
                             name=f"tfos-reader-{i}")
            for i in range(self._n)
        ]
        for t in self._threads:
            t.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once the pool is stopped (so producers
        never wedge on a full queue after the consumer has gone away)."""
        while not self._stop.is_set():
            try:
                self.records.put(item, timeout=0.1)
                return True
            except _queue_mod.Full:
                continue
        return False

    def _read_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    path = self._files.get_nowait()
                except _queue_mod.Empty:
                    break
                for payload in tfrecord.read_records(path):
                    if not self._put(payload):
                        return
        except BaseException as e:
            logger.exception("reader thread failed")
            self.errors.append(e)
        finally:
            # after stop() nobody counts sentinels, so dropping it is fine
            self._put(_END)

    @property
    def n_producers(self) -> int:
        return self._n

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)


def _record_stream(files: list[str], readers: int,
                   shuffle_buffer: int, rng) -> Iterator[bytes]:
    """Interleaved (and optionally shuffled) record payloads from files."""
    if readers <= 1 and shuffle_buffer <= 0:
        for path in files:
            yield from tfrecord.read_records(path)
        return

    pool = _ReaderPool(files, readers, capacity=max(64, 2 * shuffle_buffer))
    try:
        live = pool.n_producers
        buf: list[bytes] = []
        while live > 0:
            item = pool.records.get()
            if item is _END:
                live -= 1
                continue
            if shuffle_buffer > 0:
                buf.append(item)
                if len(buf) >= shuffle_buffer:
                    i = rng.integers(0, len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            else:
                yield item
        if pool.errors:  # a reader died: fail, don't silently truncate
            raise pool.errors[0]
        if shuffle_buffer > 0:
            rng.shuffle(buf)
            yield from buf
    finally:
        pool.stop()


def tfrecord_batches(
    files: Sequence[str] | str,
    batch_size: int,
    *,
    parse_fn: Callable[[bytes], dict[str, Any]] | None = None,
    num_epochs: int = 1,
    readers: int = 1,
    shuffle_buffer: int = 0,
    shuffle_files: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    prefetch: int = 2,
    device_put: bool | Callable[[dict[str, Any]], dict[str, Any]] = False,
) -> Iterator[dict[str, Any]]:
    """Yield columnar batches from TFRecord files.

    ``files`` should already be this node's shard (see :func:`shard_files`).
    ``readers`` maps the reference's ``HasReaders`` param; ``prefetch`` is
    the number of ready batches staged ahead (0 = fully synchronous);
    ``device_put=True`` stages each batch onto the selected device from
    the pipeline thread — the double-buffered host→device path (see
    :func:`_stager`).  ``device_put`` may also be a callable applied to
    each columnar batch (e.g. ``Trainer.shard``).
    """
    if isinstance(files, str):
        files = fs.glob(files)
    files = list(files)
    if not files:
        return
    parse = parse_fn or default_parse
    rng = np.random.default_rng(seed)

    def batch_gen() -> Iterator[dict[str, Any]]:
        from tensorflowonspark_torch import obs

        for epoch in range(num_epochs):
            epoch_files = list(files)
            if shuffle_files:
                np.random.default_rng(seed + epoch).shuffle(epoch_files)
            rows: list[dict[str, Any]] = []
            # the epoch is recorded as a manually-timed complete event, NOT
            # a `with obs.span(...)` around the loop: a generator suspends
            # inside the with-block at every yield, which would leave
            # "readers.epoch" on the CONSUMER thread's span stack and
            # mis-parent unrelated spans recorded between batches (and an
            # abandoned iterator might never pop it at all)
            t0_wall, t0 = _time_mod.time(), _time_mod.perf_counter()
            for payload in _record_stream(epoch_files, readers,
                                          shuffle_buffer, rng):
                rows.append(parse(payload))
                if len(rows) == batch_size:
                    obs.counter("reader_records_total").inc(len(rows))
                    yield _stage(_columnarize(rows))
                    rows = []
            if rows and not drop_remainder:
                obs.counter("reader_records_total").inc(len(rows))
                yield _stage(_columnarize(rows))
            obs.get_tracer().record(
                "readers.epoch", "X", t0_wall * 1e6,
                (_time_mod.perf_counter() - t0) * 1e6,
                {"epoch": epoch, "files": len(epoch_files)})

    _stage = _stager(device_put)

    yield from prefetched(batch_gen, prefetch)


def _stager(device_put) -> Callable[[dict[str, Any]], dict[str, Any]]:
    """Batch-staging function from the ``device_put`` option: ``False`` =
    host arrays, ``True`` = each array as a tensor on the selected device
    (:func:`util.select_device`: a pinned, non-blocking copy to a card),
    callable = custom staging (e.g. ``Trainer.shard``).  Runs in the
    pipeline thread, so the host-to-device copy of batch N+1 overlaps the
    step on batch N.  The copies go on that thread's current stream, the
    default stream, which orders them before the step's kernels."""
    if callable(device_put):
        return device_put
    if device_put:
        device = util.select_device()

        def _put(batch: dict[str, Any]) -> dict[str, Any]:
            return {k: util.to_device(v, device) for k, v in batch.items()}

        return _put
    return lambda batch: batch


def prefetched(batch_gen_fn: Callable[[], Iterator[Any]],
               prefetch: int) -> Iterator[Any]:
    """Run ``batch_gen_fn()`` in a pipeline thread, ``prefetch`` items ahead.

    ``prefetch <= 0`` degrades to the plain generator.  Producer exceptions
    re-raise on the consumer side; abandoning the iterator (break /
    GeneratorExit) stops the pump and the underlying generator's cleanup
    (``finally`` blocks, reader pools) runs promptly.

    The serving data plane (``pipeline._RunModel``: batch N+1 assembled and
    copied to the device while batch N computes) double-buffers through it.
    """
    if prefetch <= 0:
        yield from batch_gen_fn()
        return

    out: _queue_mod.Queue = _queue_mod.Queue(maxsize=prefetch)
    err: list[BaseException] = []
    abandoned = threading.Event()  # consumer gave up (break / GeneratorExit)

    def pump() -> None:
        gen = batch_gen_fn()
        try:
            for b in gen:
                while not abandoned.is_set():
                    try:
                        out.put(b, timeout=0.1)
                        break
                    except _queue_mod.Full:
                        continue
                if abandoned.is_set():
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            gen.close()  # runs the source's finally → pool.stop()
            # The sentinel MUST reach a live consumer even when the queue is
            # momentarily full of staged batches; dropping it is only safe
            # once the consumer has abandoned the iterator.
            while True:
                try:
                    out.put(_END, timeout=0.1)
                    break
                except _queue_mod.Full:
                    if abandoned.is_set():
                        break

    t = threading.Thread(target=pump, daemon=True, name="tfos-prefetch")
    t.start()
    try:
        while True:
            item = out.get()
            if item is _END:
                break
            yield item
    finally:
        abandoned.set()
        while True:  # drain so a blocked timed put wakes promptly
            try:
                out.get_nowait()
            except _queue_mod.Empty:
                break
        t.join(timeout=10.0)
    if err:
        raise err[0]


def parquet_batches(
    files: Sequence[str] | str,
    batch_size: int,
    *,
    columns: Sequence[str] | None = None,
    num_epochs: int = 1,
    shuffle_files: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    prefetch: int = 2,
    device_put: bool | Callable[[dict[str, Any]], dict[str, Any]] = False,
) -> Iterator[dict[str, Any]]:
    """Yield columnar batches straight from Parquet row groups.

    The Arrow→device path: row groups decode to Arrow column buffers and
    convert to NumPy without any per-row Python work — there is no
    row-at-a-time hot loop anywhere on this path, unlike the reference's
    pickled-row queues.  Shares the prefetch pipeline thread and
    ``device_put`` staging with :func:`tfrecord_batches`, so batch N+1
    moves to the device while batch N trains.

    ``files`` should already be this node's shard (:func:`shard_files`
    works on ``.parquet`` part files too).  Row-level shuffling is not
    provided here — shuffle at the file/row-group level
    (``shuffle_files=True``) or upstream at write time.
    """
    import pyarrow.parquet as pq

    if isinstance(files, str):
        files = fs.glob(files)
    files = list(files)
    if not files:
        return
    _stage = _stager(device_put)

    def _open_parquet(path: str):
        """Returns (ParquetFile, handle-to-close-or-None): ParquetFile.close
        does not close a caller-supplied source, so remote handles must be
        closed explicitly."""
        local = fs.local_path(path)
        if local is not None:
            return pq.ParquetFile(local), None
        handle = fs.open(path, "rb")
        return pq.ParquetFile(handle), handle

    def batch_gen() -> Iterator[dict[str, Any]]:
        from tensorflowonspark_torch import obs

        for epoch in range(num_epochs):
            epoch_files = list(files)
            if shuffle_files:
                np.random.default_rng(seed + epoch).shuffle(epoch_files)
            pending: dict[str, list[np.ndarray]] = {}
            count = 0
            names: list[str] | None = None
            for path in epoch_files:
                pf, handle = _open_parquet(path)
                try:
                    for rb in pf.iter_batches(columns=list(columns)
                                              if columns else None):
                        if rb.num_rows == 0:
                            continue
                        if names is None:
                            names = list(rb.schema.names)
                        elif list(rb.schema.names) != names:
                            # schema drift across part files would silently
                            # misalign the columnar accumulators
                            raise ValueError(
                                f"{path}: columns {rb.schema.names} != "
                                f"{names} of the first file"
                            )
                        for name, col in zip(rb.schema.names, rb.columns):
                            pending.setdefault(name, []).append(
                                _column_to_numpy(path, name, col)
                            )
                        count += rb.num_rows
                        while count >= batch_size:
                            batch, pending, count = _slice_batch(
                                pending, count, batch_size
                            )
                            obs.counter("reader_records_total").inc(
                                batch_size)
                            yield _stage(batch)
                finally:
                    pf.close()
                    if handle is not None:
                        handle.close()
            if count and not drop_remainder:
                obs.counter("reader_records_total").inc(count)
                batch, pending, count = _slice_batch(pending, count, count)
                yield _stage(batch)

    yield from prefetched(batch_gen, prefetch)


def _column_to_numpy(path: str, name: str, col) -> np.ndarray:
    """One Arrow column → a dense numeric numpy array.

    ``np.asarray`` on a list-typed or null-bearing Arrow column silently
    yields ``dtype=object``, which only fails much later at
    the copy to a tensor — so convert deliberately: scalar columns
    via ``to_numpy``; fixed-length list columns (the ``array<T>`` vectors
    ``dfutil.saveAsParquet`` writes, e.g. criteo ``cat``) stack to
    ``(N, k)``; nulls and ragged lists fail loudly with the file and
    column named.
    """
    import pyarrow as pa

    if col.null_count:
        raise ValueError(
            f"{path}: column {name!r} has {col.null_count} null values — "
            "fill or drop them before the device feed (object arrays cannot "
            "be device_put)"
        )
    t = col.type
    if pa.types.is_fixed_size_list(t):
        flat = col.flatten()
        if flat.null_count:
            raise ValueError(
                f"{path}: column {name!r} has null list elements")
        k = t.list_size
        return flat.to_numpy(zero_copy_only=False).reshape(len(col), k)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        offsets = col.offsets.to_numpy(zero_copy_only=False)
        lengths = np.diff(offsets)
        if len(lengths) and not (lengths == lengths[0]).all():
            raise ValueError(
                f"{path}: column {name!r} is a ragged list column "
                f"(lengths {lengths.min()}..{lengths.max()}); batches "
                "need rectangular arrays — pad it at write time"
            )
        values = col.values
        if values.null_count:
            raise ValueError(
                f"{path}: column {name!r} has null list elements")
        k = int(lengths[0]) if len(lengths) else 0
        flat = values.to_numpy(zero_copy_only=False)
        # offsets may not start at 0 for a sliced array
        flat = flat[offsets[0]:offsets[0] + len(col) * k]
        return flat.reshape(len(col), k)
    if not (pa.types.is_floating(t) or pa.types.is_integer(t)
            or pa.types.is_boolean(t)):
        # string/binary/temporal scalars come back dtype=object from
        # to_numpy — the exact deferred device_put failure this helper
        # exists to prevent
        raise ValueError(
            f"{path}: column {name!r} has non-numeric type {t} — encode it "
            "to a numeric dtype before the device feed (object arrays cannot "
            "be device_put)"
        )
    return col.to_numpy(zero_copy_only=False)


def _slice_batch(pending: dict[str, list[np.ndarray]], count: int,
                 batch_size: int):
    """Take the first ``batch_size`` rows out of columnar accumulators."""
    batch: dict[str, np.ndarray] = {}
    rest: dict[str, list[np.ndarray]] = {}
    for name, chunks in pending.items():
        col = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        batch[name] = col[:batch_size]
        if len(col) > batch_size:
            rest[name] = [col[batch_size:]]
    return batch, rest, count - batch_size
