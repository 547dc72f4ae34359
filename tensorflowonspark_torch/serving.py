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

:func:`note_compile` and :func:`observe_compile_seconds` keep the
reference's compile accounting (``serving_compiles_total``, the in-process
hits, the true misses and ``serving_compile_seconds``), and
:func:`note_rows` its row counters and padding-waste gauge;
:func:`cache_health` is the ``compile_cache`` block of ``/healthz``.  On
the card every bucket's forward is one CUDA graph
(``parallel.train.CapturedForward``, one a loaded model:
:func:`captured`), captured by :func:`warm_buckets` or at a signature's
second sighting; a user's ``predict_fn`` runs eagerly, as the reference
runs it (``pipeline._RunModel.captured``).  What the reference calls a
compile is here a signature's first call (eager) and its capture; a
signature warmed before any request (:func:`warm_buckets`,
``warm=True``) is warm, where the reference counts a persistent-cache
disk hit warm.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Iterator, Mapping, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: distinct input-shape signatures handed to each loaded forward, keyed by
#: the model-cache key; :func:`forget` drops a key when its model is
#: evicted.
_SEEN_SHAPES: dict[Any, set] = {}
#: the captured forward of each loaded model (``parallel.train.
#: CapturedForward``), keyed as :data:`_SEEN_SHAPES`; :func:`forget` drops it
_CAPTURED: dict[Any, Any] = {}
_CAPTURED_LOCK = threading.Lock()


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


def captured(key: Any, fn, params, graphs=None, capture: bool = True):
    """The :class:`~tensorflowonspark_torch.parallel.train.CapturedForward`
    of ``fn`` over ``params`` under the model key ``key``: one a loaded
    model and process, so a model's graphs outlive the partition, request
    or handle that captured them.  A new forward under the same key (a
    re-export) replaces it; ``graphs`` replaces the CUDA graph backend of
    a new one (the CPU tests pass a stand-in).  ``capture=False`` (a
    user's ``predict_fn``) runs ``fn`` eagerly on every call, as the
    reference runs it."""
    from tensorflowonspark_torch.parallel.train import CapturedForward

    with _CAPTURED_LOCK:
        fwd = _CAPTURED.get(key)
        if (fwd is None or fwd.fn is not fn or fwd.params is not params
                or fwd.capture != capture):
            fwd = CapturedForward(fn, params, graphs=graphs,
                                  capture=capture)
            _CAPTURED[key] = fwd
        return fwd


def to_host(outputs):
    """``outputs`` (a tensor, or a dict, tuple or list of them) with each
    tensor copied to the host as :func:`_host` copies it, into memory of
    its own: the ``take`` of a caller that reads a captured forward's
    outputs at once."""
    if isinstance(outputs, Mapping):
        return {k: to_host(v) for k, v in outputs.items()}
    if isinstance(outputs, (list, tuple)):
        return type(outputs)(to_host(v) for v in outputs)
    if isinstance(outputs, torch.Tensor) and outputs.device.type == "cpu":
        # a memory of its own, as a copy off the card has
        return _host(outputs).copy()
    return _host(outputs)


def warm_buckets(fwd, specs: Mapping[str, tuple[tuple, Any]],
                 buckets: Sequence[int], cache_key: Any,
                 device: torch.device) -> None:
    """Run the forward ``fwd`` (:func:`captured`'s) once on an all-zeros
    batch of every bucket shape, staged as the data plane stages it, and
    on the card capture it into that bucket's CUDA graph (not a
    ``predict_fn``'s, which runs as given): the one warm loop, shared by
    ``TFModel.warmup`` and the online tier's warm-on-load.  Each
    signature counts through :func:`note_compile` under ``cache_key`` as
    warmed, and its first call's wall (eager call and capture) through
    :func:`observe_compile_seconds`, so the first real batch pays
    neither."""
    from tensorflowonspark_torch import obs, shapes

    stage = stager(device)
    with obs.span("serving.warmup", buckets=list(buckets)):
        for b in buckets:
            batch = stage(shapes.zero_batch(specs, b))
            fresh = note_compile(cache_key, batch, warm=True)
            t0 = time.perf_counter()
            fwd.warm(batch, take=to_host)
            if fresh:
                observe_compile_seconds(time.perf_counter() - t0)


#: bounds of ``serving_compile_seconds``, the reference's
_COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
                    120.0, float("inf"))
#: cached (compiles, misses, hits, warmed, compile_seconds): note_compile
#: runs per serving batch and must not pay registry lookups there
_COMPILE_INSTRUMENTS = None


def _compile_instruments():
    global _COMPILE_INSTRUMENTS
    if _COMPILE_INSTRUMENTS is None:
        from tensorflowonspark_torch import obs

        _COMPILE_INSTRUMENTS = (
            obs.counter(
                "serving_compiles_total",
                "distinct input-shape signatures handed to a serving "
                "forward (on the card: one CUDA graph each)"),
            obs.counter(
                "serving_compile_cache_misses_total",
                "shape signatures first met on the request path: their "
                "first call (and, on the card, its capture) ran inside "
                "a request"),
            obs.counter(
                "serving_compile_cache_hits_total",
                "batches whose shape signature was already seen by the "
                "owning forward (on the card: a graph replay)"),
            obs.counter(
                "serving_compile_warmed_total",
                "shape signatures first met at warm time, before any "
                "request (on the card: captured by the warmup)"),
            obs.histogram(
                "serving_compile_seconds",
                "wall time of first-call forwards with a new shape "
                "signature (the eager call and, on the card, its CUDA "
                "graph capture)", buckets=_COMPILE_BUCKETS))
    return _COMPILE_INSTRUMENTS


#: per-thread pending first-call settlement: whether the fresh signature
#: :func:`note_compile` reported was met at warm time, resolved by
#: :func:`observe_compile_seconds` (or the next note_compile on the thread)
_PENDING = threading.local()


def note_compile(key: Any, batch: Mapping[str, Any],
                 warm: bool = False) -> bool:
    """Record the batch's shape signature; True when it is new for
    ``key`` (reference ``serving.py:214``).  A new signature counts in
    ``serving_compiles_total`` and leaves a pending settlement on this
    thread: :func:`observe_compile_seconds`, called by every data plane
    after the first call, books it as warmed (``warm``: met by a warmup,
    before any request) or as a true miss (met by a request), with its
    wall; one the forward never timed (it raised) settles at the
    thread's next note_compile.  A seen signature is an in-process hit."""
    from tensorflowonspark_torch import shapes

    _settle_pending(None)
    sig = shapes.signature(batch)
    compiles, _misses, hits, _warmed, _ = _compile_instruments()
    seen = _SEEN_SHAPES.setdefault(key, set())
    if sig in seen:
        hits.inc()
        return False
    seen.add(sig)
    compiles.inc()
    _PENDING.warm = bool(warm)
    return True


def _settle_pending(observed: float | None) -> None:
    """Book this thread's pending first call as warmed or as a true miss,
    and observe its wall (reference ``serving.py:261``, where the split
    is the persistent cache's disk hit or a true compile).  A timed wall
    with no pending note keeps the histogram observation (the decode
    tier's legacy callers)."""
    _compiles, misses, _hits, warmed, hist = _compile_instruments()
    warm = getattr(_PENDING, "warm", None)
    if warm is None:
        if observed is not None:
            hist.observe(float(observed))
        return
    _PENDING.warm = None
    (warmed if warm else misses).inc()
    if observed is not None:
        hist.observe(float(observed))


def observe_compile_seconds(seconds: float) -> None:
    """Record the wall of one first call with a shape signature that
    :func:`note_compile` reported as new, into ``serving_compile_seconds``
    (reference ``serving.py:288``), and settle its pending hit/miss
    classification.  PyTorch compiles nothing per shape: the wall is the
    eager call plus, on the card, its CUDA graph capture."""
    _settle_pending(float(seconds))


def cache_health() -> dict[str, Any]:
    """The ``compile_cache`` block of ``/healthz`` (reference
    ``serving.py:295``): the kernel library cache's state
    (``compile_cache.stats()``), the in-process counters and
    ``warm_ratio`` = (hits + warmed) / (hits + warmed + true misses), so a
    router can see a cold replica (a low ratio: requests still pay first
    calls and captures; 1.0: every signature was warmed or seen).  A
    bucket captured by a warmup counts warm.  The store's disk hits are
    kernel libraries, not shape signatures, so they stay out of the
    ratio."""
    from tensorflowonspark_torch import compile_cache

    compiles, misses, hits, warmed, _ = _compile_instruments()
    doc = compile_cache.stats()
    warm = int(hits.value) + int(warmed.value)
    total = warm + int(misses.value)
    doc.update({
        "compiles_total": int(compiles.value),
        "in_process_hits": int(hits.value),
        "warmed": int(warmed.value),
        "true_misses": int(misses.value),
        "warm_ratio": round(warm / total, 4) if total else None,
    })
    return doc


#: padded-row fraction above which the bucket ladder is called bad
#: (``TFOS_SERVING_PAD_WASTE_WARN`` overrides); judged only after
#: ``_PAD_WARN_MIN_ROWS`` forwarded rows so a ragged first batch can't
#: cry wolf
DEFAULT_PAD_WASTE_WARN = 0.5
_PAD_WARN_MIN_ROWS = 256
_PAD_WASTE_WARNED = False
#: cached (rows_counter, padded_counter, waste_gauge): note_rows runs per
#: batch and must not pay registry lookups there
_ROW_INSTRUMENTS = None


def _row_instruments():
    global _ROW_INSTRUMENTS
    if _ROW_INSTRUMENTS is None:
        from tensorflowonspark_torch import obs

        _ROW_INSTRUMENTS = (
            obs.counter("serving_rows_total",
                        "rows scored through the serving data plane"),
            obs.counter("serving_padded_rows_total",
                        "rows invented by bucket padding (masked out of "
                        "the output)"),
            obs.gauge("serving_padding_waste_ratio",
                      "fraction of forwarded rows invented by bucket "
                      "padding (padded / (real + padded))"))
    return _ROW_INSTRUMENTS


def note_rows(n_real: int, bucket: int) -> None:
    """Count scored rows and the padding overhead of their bucket
    (reference ``serving.py:346``).  The ``serving_padding_waste_ratio``
    gauge (padded / forwarded rows: the share of forward compute spent on
    invented rows) is refreshed every batch; the first time it exceeds
    the warn threshold over a meaningful volume, a structured
    ``serving.padding_waste`` event and a log WARNING name the bad
    bucket ladder."""
    global _PAD_WASTE_WARNED

    rows, padded, waste = _row_instruments()
    rows.inc(n_real)
    if bucket > n_real:
        padded.inc(bucket - n_real)
    forwarded = rows.value + padded.value
    ratio = padded.value / forwarded if forwarded else 0.0
    waste.set(ratio)
    if _PAD_WASTE_WARNED or forwarded < _PAD_WARN_MIN_ROWS:
        return
    try:
        threshold = float(os.environ.get("TFOS_SERVING_PAD_WASTE_WARN",
                                         DEFAULT_PAD_WASTE_WARN))
    except ValueError:
        threshold = DEFAULT_PAD_WASTE_WARN
    if ratio > threshold:
        from tensorflowonspark_torch import obs

        _PAD_WASTE_WARNED = True
        logger.warning(
            "serving padding waste %.0f%% exceeds %.0f%% (%d padded vs "
            "%d real rows): the bucket ladder is a bad fit for this "
            "batch-size distribution — add a smaller bucket (each costs "
            "one capture) or lower batch_size",
            ratio * 100, threshold * 100, int(padded.value),
            int(rows.value))
        obs.event("serving.padding_waste", ratio=round(ratio, 4),
                  threshold=threshold, rows=int(rows.value),
                  padded=int(padded.value))


def forget(key: Any = None) -> None:
    """Drop shape tracking and the captured graphs for one model key (or
    all, with no argument)."""
    with _CAPTURED_LOCK:
        if key is None:
            _SEEN_SHAPES.clear()
            _CAPTURED.clear()
        else:
            _SEEN_SHAPES.pop(key, None)
            _CAPTURED.pop(key, None)


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
    device with ``non_blocking=True`` on the current stream: the device's
    default stream on every thread that picks no other, the one the
    forward, a graph's copy into its static inputs and its replay run on
    (``parallel.train.CapturedForward``), so they see the copy complete.  The
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
