"""Queue sentinels for the SPARK-mode data plane.

A copy of ``tensorflowonspark_tpu/marker.py`` with its imports rewritten.

Reference anchor: ``tensorflowonspark/marker.py::Marker`` /
``tensorflowonspark/marker.py::EndPartition``.

These objects are placed on the feed queues between the Spark task process and
the long-lived trainer process.  ``DataFeed.next_batch`` treats them as batch
boundaries: a ``Marker`` ends the current batch (possibly short), and an
``EndPartition`` additionally records that a whole Spark partition has been
consumed so the feeder task can unblock.
"""


class Marker:
    """Generic queue sentinel — terminates the in-flight batch."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "<Marker>"


class EndPartition(Marker):
    """Sentinel marking the end of one Spark partition on the feed queue."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "<EndPartition>"


class StopFeed(Marker):
    """Sentinel ending the feed entirely — ``DataFeed.should_stop`` becomes
    True once consumed.  The reference signalled this with a bare ``Marker``
    put by ``TFSparkNode.py::shutdown``; a distinct type is unambiguous."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "<StopFeed>"


class TaggedChunk:
    """A chunk of rows tagged with the feeding task's identity.

    Not in the reference: its inference path pulled results off ONE shared
    ``output`` queue, which interleaves predictions when Spark runs two
    partition tasks concurrently on an executor (>1 core/slot).  Tagging the
    input lets ``DataFeed.batch_results`` route each row's result to the
    per-task queue ``output:<tag>``, making multi-slot executors safe.
    """

    __slots__ = ("tag", "rows")

    def __init__(self, tag: str, rows: list):
        self.tag = tag
        self.rows = rows

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"<TaggedChunk {self.tag} n={len(self.rows)}>"


class ColumnarChunk:
    """A chunk already columnarized on the feeder side.

    ``cols`` is one contiguous numpy array per column, all sharing the same
    leading (row) dimension.  This is the pickled FALLBACK of the zero-copy
    transport (:mod:`tensorflowonspark_torch.shm`): when shared memory is
    unavailable or opted out, the columns ride the manager queue as one
    pickle — still a single feeder-side columnarization, still O(columns)
    consumer-side assembly, just not zero-copy.  ``tag`` carries the
    feeding task's identity exactly like :class:`TaggedChunk` (None for the
    untagged training path).  ``nbytes`` is what the byte-aware queue bound
    accounts (descriptor-side accounting).
    """

    __slots__ = ("cols", "tag")

    def __init__(self, cols: list, tag: str | None = None):
        self.cols = cols
        self.tag = tag

    @property
    def nrows(self) -> int:
        return int(self.cols[0].shape[0]) if self.cols else 0

    @property
    def nbytes(self) -> int:
        return int(sum(int(c.nbytes) for c in self.cols))

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return (f"<ColumnarChunk tag={self.tag} rows={self.nrows} "
                f"cols={len(self.cols)}>")
