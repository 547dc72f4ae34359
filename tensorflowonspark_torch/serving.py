"""Serving data plane: bucketed batch shapes, columnar ingest, staging onto
the device, masked emit.

Reference anchor: ``tensorflowonspark_tpu/serving.py``; this is the part
``TFModel.transform`` runs.  The mechanisms carry over:

- **Shape bucketing with pad-and-mask** (:func:`pad_columns`,
  :func:`emit_rows`): every batch is zero-padded up to a ladder bucket and
  the padded rows are sliced off the output.  :func:`note_compile` counts
  the distinct shape signatures handed to each loaded forward in
  :data:`_SEEN_SHAPES` — one per bucket when bucketing works.
- **Columnar partition ingest** (:func:`ingest_chunks`): one C-level
  ``operator.itemgetter`` pass per needed column; pyarrow batches are
  sliced straight from their buffers.
- **Staging** (:func:`stager`): pinned host memory, then an asynchronous
  copy to the card on the prefetch pump thread.  Unlike the reference's
  stager, a failed copy raises: it never hands back host arrays.
- **Masked per-column emission** (:func:`emit_rows`): one host copy and one
  ``tolist()`` per output column per batch.

:func:`observe_compile_seconds` keeps the reference's compile-time
histogram (the decode engine observes into it); the obs counters and
padding-waste gauge of the reference wait for the rest of the serving
plane.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

#: distinct input-shape signatures handed to each loaded forward, keyed by
#: the model-cache key; :func:`forget` drops a key when its model is
#: evicted.
_SEEN_SHAPES: dict[Any, set] = {}


def bucketing_enabled() -> bool:
    """``TFOS_SERVING_BUCKETS=0`` disables pad-and-mask, for forwards whose
    per-example outputs depend on the whole batch (padded zero rows would
    change the real rows' values)."""
    return os.environ.get("TFOS_SERVING_BUCKETS", "1").strip().lower() \
        not in ("0", "false")


def pad_columns(cols: Mapping[str, Any], target: int) -> dict:
    """Zero-pad every column's leading axis out to ``target`` rows: the one
    padding convention, ``saved_model.pad_batch``."""
    from tensorflowonspark_torch import saved_model

    return saved_model.pad_batch(cols, target)


def warm_buckets(fn, params, specs: Mapping[str, tuple[tuple, Any]],
                 buckets: Sequence[int], cache_key: Any,
                 device: torch.device) -> None:
    """Run ``fn`` once on an all-zeros batch of every bucket shape, staged
    as the data plane stages it and waited for, each signature counted
    through :func:`note_compile` under ``cache_key``.  On the card this
    builds the kernels and settles cuDNN's algorithm choice before the
    first real batch."""
    from tensorflowonspark_torch import shapes

    stage = stager(device)
    for b in buckets:
        batch = stage(shapes.zero_batch(specs, b))
        note_compile(cache_key, batch)
        for leaf in _tree_leaves(fn(params, batch)):
            _host(leaf)


def _tree_leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    else:
        yield tree


def note_compile(key: Any, batch: Mapping[str, Any]) -> bool:
    """Record the batch's shape signature for ``key``; True when new."""
    from tensorflowonspark_torch import shapes

    sig = shapes.signature(batch)
    seen = _SEEN_SHAPES.setdefault(key, set())
    if sig in seen:
        return False
    seen.add(sig)
    return True


#: bounds of ``serving_compile_seconds``, the reference's
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
                    120.0, float("inf"))


def observe_compile_seconds(seconds: float) -> None:
    """Record the wall of one first call with a shape signature that
    :func:`note_compile` reported as new, into ``serving_compile_seconds``
    (reference ``serving.py:288``).  PyTorch compiles nothing per shape:
    the decode engine observes a signature's eager call plus its CUDA
    graph capture.  The reference's hit/miss split over its persistent
    XLA cache has no counterpart here."""
    from tensorflowonspark_torch import obs

    obs.histogram(
        "serving_compile_seconds",
        "wall time of first-call forwards with a new shape signature "
        "(the eager call and, on the card, its CUDA graph capture)",
        buckets=_COMPILE_BUCKETS).observe(float(seconds))


def forget(key: Any = None) -> None:
    """Drop shape tracking for one model key (or all, with no argument)."""
    if key is None:
        _SEEN_SHAPES.clear()
    else:
        _SEEN_SHAPES.pop(key, None)


def ingest_chunks(iterator, chunk_rows: int, in_map: Mapping[str, str],
                  columns: Sequence[str]
                  ) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
    """Partition iterator → ``(n_rows, {feature: column array})`` chunks.

    Row-shaped elements (either backend's ``Row``, plain tuples, dicts) are
    buffered to ``chunk_rows`` and columnarized in one pass; pyarrow
    ``RecordBatch``/``Table`` elements are sliced from their column
    buffers.  ``in_map`` maps DataFrame column → model input name;
    ``columns`` names the fields of rows that carry none (plain tuples).
    """
    from tensorflowonspark_torch import sql_compat

    pending: list[Any] = []

    def flush():
        n, cols = _columnarize_rows(pending, in_map, columns)
        pending.clear()
        return n, cols

    for item in iterator:
        arrow = sql_compat.arrow_batch_columns(item, columns=list(in_map))
        if arrow is not None:
            if pending:
                yield flush()
            missing = [c for c in in_map if c not in arrow]
            if missing:
                raise KeyError(
                    f"arrow partition batch lacks input column(s) {missing}; "
                    f"has {sorted(arrow)}")
            total = int(next(iter(arrow.values())).shape[0]) if arrow else 0
            for start in range(0, total, chunk_rows):
                stop = min(start + chunk_rows, total)
                yield stop - start, {feat: arrow[col][start:stop]
                                     for col, feat in in_map.items()}
            continue
        pending.append(item)
        if len(pending) >= chunk_rows:
            yield flush()
    if pending:
        yield flush()


def _columnarize_rows(rows: list, in_map: Mapping[str, str],
                      columns: Sequence[str]
                      ) -> tuple[int, dict[str, np.ndarray]]:
    """One chunk of rows → columns, one ``operator.itemgetter`` pass per
    needed column.  Positional extraction assumes the schema-uniform rows a
    DataFrame partition guarantees; a short row (mixed arity) falls back to
    by-name indexing."""
    import operator

    first = rows[0]
    if isinstance(first, dict):
        return len(rows), {feat: np.asarray([r[col] for r in rows])
                           for col, feat in in_map.items()}
    fields = getattr(first, "__fields__", None)
    if fields is not None:  # pyspark attribute / sparkapi method
        names = list(fields() if callable(fields) else fields)
    else:
        names = list(columns)
    out = {}
    for col, feat in in_map.items():
        try:
            pos = names.index(col)
        except ValueError:
            raise KeyError(
                f"input column {col!r} not found in partition rows "
                f"(row fields: {names})") from None
        try:
            out[feat] = np.asarray(list(map(operator.itemgetter(pos), rows)))
        except IndexError:
            out[feat] = np.asarray([r[col] for r in rows])
    return len(rows), out


def stager(device: torch.device):
    """``batch -> staged batch`` for the prefetch pump thread: numpy
    columns become tensors on ``device``.

    On the card each column is copied into pinned host memory, then to the
    device with ``non_blocking=True`` on the current stream, which the
    forward also runs on, so the forward sees the copy complete.  The
    pinned block is not reused before the copy ends (PyTorch's pinned
    allocator records the copy), and the numpy buffer is free as soon as
    ``pin_memory`` returns.  Every failure raises.  On the CPU the columns
    are wrapped without a copy."""
    if device.type == "cpu":
        return lambda batch: {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()}

    def put(batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(device, non_blocking=True) for k, v in batch.items()}

    return put


def prefetch_depth() -> int:
    """Batches staged ahead by the serving pump (``TFOS_SERVING_PREFETCH``,
    default 2; 0 assembles each batch inline)."""
    try:
        return int(os.environ.get("TFOS_SERVING_PREFETCH", "2"))
    except ValueError:
        return 2


def _host(a: Any) -> np.ndarray:
    """A forward's output as a numpy array (waits for the device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def emit_rows(named: Mapping[str, Any], n_real: int, backend: str,
              fed_rows: int | None = None) -> list:
    """Named output arrays → ``n_real`` Rows, one ``tolist()`` per column.

    Slicing to ``n_real`` masks the rows padding invented.  Every output's
    leading dimension must equal the row count fed (``fed_rows``, the
    bucket for a padded batch; defaults to ``n_real``): anything else is
    not per-example and is rejected instead of being sliced into rows."""
    from tensorflowonspark_torch import sql_compat

    expect = n_real if fed_rows is None else fed_rows
    cols = list(named.keys())
    pylists = []
    for c in cols:
        a = _host(named[c])
        if a.ndim == 0 or a.shape[0] != expect:
            raise ValueError(
                f"serving output {c!r} has shape {np.shape(a)} but the batch "
                f"fed {expect} rows — outputs must be per-example (leading "
                "batch dimension matching the fed batch) to be emitted as "
                "DataFrame rows")
        pylists.append(a[:n_real].tolist())
    make = sql_compat.row_maker(cols, backend)
    if len(pylists) == 1:
        return [make([v]) for v in pylists[0]]
    return [make(values) for values in zip(*pylists)]
