"""Helpers used *inside* the user's ``map_fun`` on each cluster node.

Reference anchor: ``tensorflowonspark/TFNode.py`` (``DataFeed``,
``hdfs_path``).  A copy of ``tensorflowonspark_tpu/TFNode.py`` with its
imports rewritten; ``next_batch(device_put=True)`` stages each column
onto the node's torch device (pinned memory, a non-blocking copy) where
the JAX package calls ``jax.device_put``.  ``start_cluster_server`` and
``export_saved_model`` are not ported yet.

The central class is :class:`DataFeed`, the trainer-side endpoint of the
SPARK input mode.  Deliberate TPU-first departure from the reference
(``SURVEY.md §3.2``): the reference's feed was row-at-a-time — one pickled
row per ``queue.get`` — which was its main bottleneck.  Here the feeder ships
**chunks** — preferably pre-columnarized, either as shared-memory segment
descriptors (:class:`tensorflowonspark_torch.shm.ShmChunkRef`, zero-copy) or
pickled :class:`~tensorflowonspark_torch.marker.ColumnarChunk` columns, with
plain row lists as the legacy fallback — and ``next_batch`` returns
**columnar numpy arrays** (optionally already staged onto the device).
Pre-columnarized chunks are assembled with ``np.concatenate`` (a batch
covered by a single chunk is handed out as zero-copy views), so the hot
loop does O(batch/chunk) queue operations, O(columns) assembly work, and
one host→device transfer per batch instead of O(batch) pickled gets
feeding a ``feed_dict``.
"""

from __future__ import annotations

import logging
import queue as _std_queue
import time as _time_mod
from typing import Any, Iterable, Sequence

import numpy as np

from tensorflowonspark_torch import marker, shm

logger = logging.getLogger(__name__)


class FeedInterrupted(Exception):
    """Raised out of ``DataFeed.next_batch`` when the feed's ``interrupt``
    callback reports a pending condition (an elastic regroup) while the
    consumer is blocked on an empty queue.  Buffered data is untouched —
    the caller handles the condition and may keep consuming afterwards."""


class DataFeed:
    """Consume Spark partition data inside ``map_fun``.

    Reference anchor: ``tensorflowonspark/TFNode.py::DataFeed``.

    ``input_mapping`` (optional) names the columns of the incoming rows, e.g.
    ``["image", "label"]``; ``next_batch`` then returns ``{"image": ndarray,
    "label": ndarray}``.  Without it, batches are returned as a list of
    per-column arrays.

    ``prefetch > 0`` double-buffers the feed: a pipeline thread assembles,
    columnarizes, and (with ``device_put``) stages batch N+1 onto the device while
    the caller trains on batch N, so step time approaches
    ``max(compute, feed)`` instead of their sum (``SURVEY.md §3.2`` hard
    part (b)).  Marker semantics and inference-result routing are identical
    to the synchronous path: row provenance is recorded when a batch is
    *handed out*, not when it is staged.
    """

    def __init__(
        self,
        mgr,
        train_mode: bool = True,
        qname_in: str = "input",
        qname_out: str = "output",
        input_mapping: Sequence[str] | None = None,
        prefetch: int = 0,
    ):
        self.mgr = mgr
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.input_mapping = list(input_mapping) if input_mapping else None
        self.prefetch = int(prefetch)
        self.done_feeding = False
        self._queue_in = mgr.get_queue(qname_in)
        self._queue_out = mgr.get_queue(qname_out)
        # not-yet-returned data as FIFO *pieces*: a list of rows (legacy
        # feeders) or a marker.ColumnarChunk of pre-columnarized arrays
        # (shm / pickled-columnar feeders) — split at batch boundaries by
        # numpy views, never row loops
        self._buffer: list[Any] = []
        self._buffered_rows = 0
        # provenance of buffered / handed-out rows, as [tag, count] runs in
        # FIFO order (tag None = untagged feeder). batch_results uses
        # _out_route to send each result to its feeding task's own queue —
        # two concurrent partition tasks on one executor must not interleave
        # (multi-slot executors; see marker.TaggedChunk)
        self._buffer_tags: list[list] = []
        self._out_route: list[list] = []
        self._stop_seen = False  # StopFeed consumed by the assembling side
        #: optional zero-arg callable (``elastic.ElasticWorker.attach``):
        #: when set and truthy while the consumer is BLOCKED on an empty
        #: queue, ``next_batch`` raises :class:`FeedInterrupted` instead of
        #: waiting forever — a starved survivor must still reach its
        #: between-steps regroup check.  Flowing data is never interrupted.
        self.interrupt: Any = None
        self._interrupt_poll_s = 0.5
        self._pf_thread = None
        self._pf_out: _std_queue.Queue | None = None
        self._pf_args: tuple | None = None

    # -- input -------------------------------------------------------------

    def next_batch(self, batch_size: int, device_put: bool = False):
        """Return up to ``batch_size`` rows as columnar arrays.

        Blocks until a full batch accumulated, a partition/stop marker is
        seen (short batch — possibly empty), or the feed terminates.  With
        ``device_put=True`` the arrays become torch tensors on the node's
        device before returning (one pinned, non-blocking host→device copy
        per column); ``device_put`` may also be a callable applied to the
        columnar batch (e.g. ``Trainer.shard``).

        Reference anchor: ``TFNode.py::DataFeed.next_batch`` — same marker
        semantics (``Marker``/``EndPartition`` end a batch early), different
        payload shape (chunked columnar, not row-at-a-time).
        """
        if self.prefetch > 0:
            return self._next_batch_prefetched(batch_size, device_put)
        pieces, runs, stopped = self._assemble(batch_size)
        if stopped:
            self.done_feeding = True
        for tag, count in runs:
            self._note_rows(self._out_route, tag, count)
        return self._columnarize(pieces, device_put)

    def _assemble(self, batch_size: int):
        """Pull queue items until ``batch_size`` rows are buffered, a marker
        ends the batch early, or the stop marker arrives.  Returns
        ``(pieces, provenance_runs, stop_seen)`` — pieces are row lists or
        ``marker.ColumnarChunk`` column sets, already cut to the batch; does
        NOT touch ``_out_route`` — the caller does, at hand-out time.

        Shm descriptors are materialized here (zero-copy views over the
        consumed segment); pickled ``ColumnarChunk`` payloads pass through
        as-is.  ``datafeed_bytes_{shm,pickle}_total`` count the columnar
        payload bytes per transport (plain-row chunks have no cheap byte
        measure and are counted by ``datafeed_rows_total`` only).

        Feed observability (one histogram + two counters per batch, all
        O(1)): ``datafeed_assemble_seconds`` is the time the trainer spent
        *waiting on Spark* for this batch — the number that tells you
        whether the feed or the compute is the bottleneck.  The flight
        recorder splits that further: queue-blocked time is the ``wait``
        stage (starvation evidence), everything else in here is ``ingest``
        (shm read + piece assembly); on the prefetch pump thread both are
        recorded as overlapped — the consumer's own ``wait`` on the staged
        queue is the critical-path number there."""
        from tensorflowonspark_torch import obs

        t0 = _time_mod.perf_counter()
        wait_s = 0.0
        while self._buffered_rows < batch_size and not self._stop_seen:
            tw = _time_mod.perf_counter()
            if self.interrupt is None:
                item = self._queue_in.get()
            else:
                while True:
                    try:
                        item = self._queue_in.get(
                            timeout=self._interrupt_poll_s)
                        break
                    except _std_queue.Empty:
                        if self.interrupt():
                            raise FeedInterrupted(
                                "feed wait interrupted (regroup pending)"
                            ) from None
            wait_s += _time_mod.perf_counter() - tw
            if isinstance(item, marker.StopFeed):
                self._stop_seen = True
            elif isinstance(item, shm.ShmChunkRef):
                cols, tag = shm.read_chunk(item)
                obs.counter("datafeed_bytes_shm_total").inc(item.nbytes)
                self._push_piece(marker.ColumnarChunk(cols), tag,
                                 item.nrows)
                if self._buffered_rows >= batch_size:
                    break
            elif isinstance(item, marker.ColumnarChunk):
                obs.counter("datafeed_bytes_pickle_total").inc(item.nbytes)
                self._push_piece(item, item.tag, item.nrows)
                if self._buffered_rows >= batch_size:
                    break
            elif isinstance(item, marker.TaggedChunk):
                self._push_piece(item.rows, item.tag, len(item.rows))
                if self._buffered_rows >= batch_size:
                    break
            elif isinstance(item, marker.Marker):
                # EndPartition / generic marker: release what we have (the
                # feeder's partition ended); empty buffer yields empty batch
                break
            else:
                rows = item if isinstance(item, list) else [item]
                self._push_piece(rows, None, len(rows))
                if self._buffered_rows >= batch_size:
                    break
        pieces = self._take_pieces(batch_size)
        taken = sum(self._piece_len(p) for p in pieces)
        runs = self._take_tags(taken)
        dt = _time_mod.perf_counter() - t0
        obs.histogram("datafeed_assemble_seconds").observe(dt)
        obs.flight.recorder("feed").add(
            overlapped=self.prefetch > 0,
            wait=wait_s, ingest=max(0.0, dt - wait_s))
        obs.counter("datafeed_batches_total").inc()
        if taken:
            obs.counter("datafeed_rows_total").inc(taken)
        return pieces, runs, self._stop_seen

    def _push_piece(self, piece, tag, nrows: int) -> None:
        if nrows <= 0:
            return
        self._buffer.append(piece)
        self._buffered_rows += nrows
        self._note_rows(self._buffer_tags, tag, nrows)

    @staticmethod
    def _piece_len(piece) -> int:
        return (piece.nrows if isinstance(piece, marker.ColumnarChunk)
                else len(piece))

    def _take_pieces(self, count: int) -> list[Any]:
        """Detach up to ``count`` rows' worth of pieces from the buffer,
        splitting the boundary piece with numpy views (columnar) or a list
        slice (rows) — no per-row work either way."""
        out: list[Any] = []
        while count > 0 and self._buffer:
            piece = self._buffer[0]
            n = self._piece_len(piece)
            if n <= count:
                out.append(self._buffer.pop(0))
                self._buffered_rows -= n
                count -= n
            else:
                if isinstance(piece, marker.ColumnarChunk):
                    out.append(marker.ColumnarChunk(
                        [c[:count] for c in piece.cols], tag=piece.tag))
                    self._buffer[0] = marker.ColumnarChunk(
                        [c[count:] for c in piece.cols], tag=piece.tag)
                else:
                    out.append(piece[:count])
                    self._buffer[0] = piece[count:]
                self._buffered_rows -= count
                count = 0
        return out

    def _next_batch_prefetched(self, batch_size: int, device_put):
        """Double-buffered path: batches staged by a pipeline thread."""
        if self.done_feeding:  # pump already drained; mirror sync behavior
            # post-drain calls are fine with ANY arguments — nothing is in
            # flight to mis-stage, so the consistency guard below must not
            # fire here
            return self._columnarize([], device_put)
        if self._pf_args is not None:
            pf_bs, pf_dp = self._pf_args
            # equality, not identity: `feed.next_batch(bs, obj.method)`
            # builds a fresh bound-method object per call, and bound
            # methods compare equal while never being identical
            try:
                dp_same = device_put is pf_dp or bool(device_put == pf_dp)
            except Exception:
                dp_same = False
            if batch_size != pf_bs or not dp_same:
                # the pump stages batches with the FIRST call's arguments;
                # a change mid-stream would silently hand out wrong-sized
                # or wrongly-staged batches already in flight
                raise ValueError(
                    f"DataFeed(prefetch={self.prefetch}): batch_size/"
                    f"device_put changed after the prefetch pump started "
                    f"(pump has batch_size={pf_bs}, got {batch_size}; "
                    f"device_put {'unchanged' if dp_same else 'changed'}). "
                    "Keep them constant across next_batch calls, or use a "
                    "new DataFeed (or prefetch=0) for the new "
                    "configuration.")
        if self._pf_thread is None:
            self._start_prefetch(batch_size, device_put)
        from tensorflowonspark_torch import obs

        tw = _time_mod.perf_counter()
        item = self._pf_out.get()
        # consumer-side starvation: the pump's own wait/ingest overlap and
        # are recorded as such; blocking HERE is the critical-path wait
        obs.flight.recorder("feed").add(
            wait=_time_mod.perf_counter() - tw)
        if isinstance(item, BaseException):
            if isinstance(item, FeedInterrupted):
                # the pump thread died delivering this — reset so the
                # NEXT call restarts it (the interrupt contract promises
                # the caller may keep consuming after handling the
                # condition; a dead pump would block that call forever on
                # an empty staging queue).  Buffered pieces stay intact.
                self._pf_thread = None
                self._pf_out = None
                self._pf_args = None
            raise item
        batch, runs, stopped = item
        if stopped:
            self.done_feeding = True
        for tag, count in runs:
            self._note_rows(self._out_route, tag, count)
        return batch

    def _start_prefetch(self, batch_size: int, device_put) -> None:
        import threading

        self._pf_args = (batch_size, device_put)
        self._pf_out = _std_queue.Queue(maxsize=self.prefetch)

        def pump() -> None:
            try:
                while True:
                    pieces, runs, stopped = self._assemble(batch_size)
                    batch = self._columnarize(pieces, device_put)
                    self._pf_out.put((batch, runs, stopped))
                    if stopped:
                        return
            except BaseException as e:  # re-raised in next_batch
                self._pf_out.put(e)

        self._pf_thread = threading.Thread(
            target=pump, daemon=True, name="tfos-datafeed-prefetch"
        )
        self._pf_thread.start()

    def should_stop(self) -> bool:
        """True once the stop marker has been consumed (end of feeding)."""
        return self.done_feeding

    # -- output ------------------------------------------------------------

    def batch_results(self, results: Iterable[Any]) -> None:
        """Push one batch of inference results back to the Spark side.

        Reference anchor: ``TFNode.py::DataFeed.batch_results``.  Results
        are routed positionally back to the task that fed the matching input
        rows (one result per row, the reference's inference contract): the
        i-th result goes to the queue of the i-th consumed row's feeder.
        """
        results = list(results)
        i = 0
        while i < len(results) and self._out_route:
            tag, count = self._out_route[0]
            n = min(count, len(results) - i)
            if tag is None:
                self._queue_out.put(results[i:i + n])
            else:
                # server-side conditional put: if the feeding task timed out
                # and deleted its queue, its late results are dropped instead
                # of re-creating an orphan queue nobody reads.  A live-but-
                # slow task's full queue raises Full per put_route timeout —
                # keep back-pressuring (the pre-routing behavior), because
                # only queue *deletion* means the consumer is gone.
                while True:
                    try:
                        delivered = self.mgr.put_route(
                            f"{self.qname_out}:{tag}", results[i:i + n],
                            timeout=60.0,
                        )
                        break
                    except _std_queue.Full:
                        continue
                if not delivered:
                    logger.warning(
                        "dropping %d late results for departed task %s", n, tag
                    )
            i += n
            if n == count:
                self._out_route.pop(0)
            else:
                self._out_route[0][1] = count - n
        if i < len(results):  # surplus (no matching inputs): default queue
            self._queue_out.put(results[i:])

    def terminate(self) -> None:
        """Drain remaining input so blocked feeder tasks can finish.

        Reference anchor: ``TFNode.py::DataFeed.terminate``.  With an active
        prefetch thread the staged batches are discarded too; the (daemon)
        pipeline thread exits with the trainer process.
        """
        logger.info("DataFeed terminating: draining input queue")
        from tensorflowonspark_torch import obs

        obs.event("datafeed.terminate", qname=self.qname_in)
        self.done_feeding = True
        self._stop_seen = True
        if self._pf_out is not None:
            while True:  # discard staged batches so the pump can finish
                try:
                    self._pf_out.get_nowait()
                except _std_queue.Empty:
                    break
        while True:
            try:
                item = self._queue_in.get(timeout=1.0)
            except _std_queue.Empty:
                return
            except (EOFError, BrokenPipeError):
                return
            if isinstance(item, shm.ShmChunkRef):
                # a drained descriptor is never read: unlink its segment
                # here or nothing will until the orphan sweep
                try:
                    shm.unlink_ref(item)
                except Exception:
                    pass

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _note_rows(runs: list[list], tag, count: int) -> None:
        """Append a [tag, count] run, merging with the tail run of the same
        tag (keeps the untagged training path at O(1) bookkeeping)."""
        if count <= 0:
            return
        if runs and runs[-1][0] == tag:
            runs[-1][1] += count
        else:
            runs.append([tag, count])

    def _take_tags(self, count: int) -> list[list]:
        """Detach ``count`` rows' provenance runs from the buffered side."""
        runs: list[list] = []
        while count > 0 and self._buffer_tags:
            tag, c = self._buffer_tags[0]
            n = min(c, count)
            self._note_rows(runs, tag, n)
            count -= n
            if n == c:
                self._buffer_tags.pop(0)
            else:
                self._buffer_tags[0][1] = c - n
        return runs

    @staticmethod
    def _rows_to_cols(rows: list[Any]) -> list[np.ndarray]:
        """Legacy per-row columnarization of ONE rows piece (the loop the
        columnar transports moved to the feeder side).  Delegates to
        :func:`shm.columnarize` — the ONE place the row→column convention
        lives — and keeps the permissive local loop only for rows that
        cannot columnarize (object-dtype payloads the legacy path has
        always accepted as object arrays)."""
        cols = shm.columnarize(rows)
        if cols is not None:
            return cols
        first = rows[0]
        if isinstance(first, (list, tuple)) and not np.isscalar(first):
            return [np.asarray([r[c] for r in rows])
                    for c in range(len(first))]
        return [np.asarray(rows)]

    def _columnarize(self, pieces: list[Any], device_put):
        """Assemble one batch's pieces into columnar arrays.

        Pre-columnarized pieces concatenate per column (``np.concatenate``
        — one memcpy per column); a batch covered by a single columnar
        piece is handed out as-is: zero-copy views over the (already
        unlinked) shm segment, from which ``device_put`` transfers
        directly.  Flight attribution: the column assembly is ``collate``
        (distinct from ``_assemble``'s ``ingest`` so each stage histogram
        keeps one observation per batch), an in-feed ``device_put`` is
        ``stage`` (all overlapped when the prefetch pump runs this)."""
        if not pieces:
            return {} if self.input_mapping else []
        from tensorflowonspark_torch import obs

        rec = obs.flight.recorder("feed")
        bg = self.prefetch > 0
        t0 = _time_mod.perf_counter()
        col_sets = [piece.cols if isinstance(piece, marker.ColumnarChunk)
                    else self._rows_to_cols(piece) for piece in pieces]
        ncols = len(col_sets[0])
        if any(len(cs) != ncols for cs in col_sets):
            raise ValueError(
                "inconsistent column arity across feed chunks in one batch: "
                f"{sorted({len(cs) for cs in col_sets})} columns")
        if len(col_sets) == 1:
            cols = list(col_sets[0])
        else:
            cols = [np.concatenate([cs[i] for cs in col_sets])
                    for i in range(ncols)]
        if self.input_mapping and len(self.input_mapping) != len(cols):
            raise ValueError(
                f"input_mapping has {len(self.input_mapping)} names but rows "
                f"have {len(cols)} columns"
            )
        t1 = _time_mod.perf_counter()
        rec.add(overlapped=bg, collate=t1 - t0)
        if callable(device_put):
            out = device_put(
                dict(zip(self.input_mapping, cols)) if self.input_mapping
                else cols
            )
            rec.add(overlapped=bg, stage=_time_mod.perf_counter() - t1)
            return out
        if device_put:
            from tensorflowonspark_torch import util

            device = util.select_device()
            cols = [util.to_device(c, device) for c in cols]
            rec.add(overlapped=bg, stage=_time_mod.perf_counter() - t1)
        if self.input_mapping:
            return dict(zip(self.input_mapping, cols))
        return cols


def hdfs_path(ctx, path: str) -> str:
    """Resolve ``path`` against the cluster's default filesystem.

    Reference anchor: ``tensorflowonspark/TFNode.py::hdfs_path``:
    scheme-qualified paths pass through; absolute paths are prefixed with the
    default FS authority; relative paths resolve under the working dir.
    """
    for scheme in ("hdfs://", "gs://", "s3://", "s3a://", "file://", "viewfs://"):
        if path.startswith(scheme):
            return path
    default_fs = getattr(ctx, "defaultFS", "file://")
    working_dir = getattr(ctx, "working_dir", "/")
    local = default_fs.startswith("file://") or default_fs == ""
    if path.startswith("/"):
        # local default FS → keep a plain filesystem path (consumers like
        # orbax/numpy open it directly); remote FS → prefix the authority
        return path if local else default_fs.rstrip("/") + path
    joined = working_dir.rstrip("/") + "/" + path
    return joined if local else default_fs.rstrip("/") + joined

