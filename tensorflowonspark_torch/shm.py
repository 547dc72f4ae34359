"""Zero-copy columnar chunk transport over POSIX shared memory.

A copy of ``tensorflowonspark_tpu/shm.py`` with its imports rewritten and
its own segment-name prefix (:data:`SEG_PREFIX`).

The SPARK-mode data plane used to ship every chunk as a Python list of rows
that was pickled TWICE across the TFManager proxy sockets (feeder → manager
server process → trainer) and then re-columnarized with a per-row Python
loop on the consumer.  That serialization wall is the dominant non-compute
cost the distributed-input-pipeline literature keeps re-finding
(TF-Replicator, arXiv:1902.00465; CUDA-aware-MPI characterization,
arXiv:1810.11112).  This module removes it:

- **Feeder-side columnarization** (:func:`columnarize` /
  :func:`encode_chunk`): the Spark-task process columnarizes each chunk
  ONCE into contiguous numpy column arrays — the per-row loop runs exactly
  once, on the side that already owns the rows.
- **Shared-memory transport** (:func:`write_chunk` / :func:`read_chunk`):
  fixed-dtype columns are copied into one ``multiprocessing.shared_memory``
  segment per chunk; only a tiny :class:`ShmChunkRef` descriptor (segment
  name, per-column shape/dtype/offset, row count, tag) rides the manager
  queue, so the manager server process never touches the payload.
- **Lifecycle**: the feeder creates a segment, the consumer unlinks it at
  read time (copy-or-consume).  Segment names encode the creator's
  ``(pid, start tick)`` — the same pid-reuse-proof identity the TFManager
  orphan watch uses — so :func:`sweep_orphans` can reap segments whose
  creator died without handing them off, and ``/dev/shm`` never leaks.
- **Raw ``/dev/shm`` files**, not ``multiprocessing.shared_memory``: POSIX
  shm objects ARE tmpfs files on Linux, and going direct (a) sidesteps the
  resource tracker, which would unlink in-flight segments when the
  short-lived feeder task exits (bpo-38119), and (b) lets the writer use
  ``pwrite`` through the fd — on sandboxed kernels (gVisor-style, like CI
  containers) storing through a fresh mmap pays a page-fault per 4 KiB
  that makes it ~10× slower than the write syscall path.
- **Fallbacks**: ragged / object-dtype rows fall back to the pickled-rows
  path; columnarizable rows with shm unavailable (or ``TFOS_FEED_SHM=0``)
  ride as a pickled :class:`~tensorflowonspark_torch.marker.ColumnarChunk`
  (still one columnarization, still O(columns) consumer work).

The consumer side (``TFNode.DataFeed``) concatenates pre-columnarized
chunks with ``np.concatenate`` — or hands out a single chunk's columns as
zero-copy views over the (already-unlinked, still-mapped) segment — so
``device_put`` transfers straight from the shm-backed arrays while the
prefetch thread overlaps the next batch.
"""

from __future__ import annotations

import logging
import os
import secrets
import time
from typing import Any, Iterable, Sequence

import numpy as np

logger = logging.getLogger(__name__)

#: segment-name prefix; full names are
#: ``tfos_torch_feed_<creator_pid>_<creator_start_tick>_<random>`` so the
#: orphan sweep can recover the creator's pid-reuse-proof identity from the
#: name.  The JAX package's segments are ``tfos_feed_*``: each package's
#: sweeps and leak checks see only its own segments on a shared host.
SEG_PREFIX = "tfos_torch_feed"

_SHM_DIR = "/dev/shm"

#: default age below which :func:`sweep_orphans` never touches a segment —
#: covers the dequeue→attach window of a consumer whose feeder just exited
DEFAULT_SWEEP_GRACE_S = 60.0

#: column offsets are aligned to this (cache-line / DMA friendly)
_ALIGN = 64

_START_TICK: list[int | None] = [None]


def _my_start_tick() -> int:
    if _START_TICK[0] is None:
        from tensorflowonspark_torch import TFManager

        _START_TICK[0] = TFManager.proc_start_time(os.getpid()) or 0
    return _START_TICK[0]


def shm_available() -> bool:
    """Can this host back the transport (POSIX shm present and writable)?"""
    return os.path.isdir(_SHM_DIR) and os.access(_SHM_DIR, os.W_OK)


def enabled() -> bool:
    """shm transport selected: available AND not opted out
    (``TFOS_FEED_SHM=0``)."""
    if os.environ.get("TFOS_FEED_SHM", "1").strip().lower() in ("0", "false"):
        return False
    return shm_available()


class ShmChunkRef:
    """Descriptor of a columnar chunk parked in a shared-memory segment.

    This is what actually rides the TFManager queue: a few hundred bytes
    regardless of payload size.  ``cols`` is ``((shape, dtype_str, offset),
    ...)`` per column; ``nbytes`` is the segment size — the number the
    byte-aware queue bound (``TFOS_FEED_MAX_INFLIGHT_MB``) accounts, since
    the referenced payload stays pinned in ``/dev/shm`` until the consumer
    unlinks it.
    """

    __slots__ = ("name", "cols", "nrows", "tag", "nbytes")

    def __init__(self, name: str, cols: tuple, nrows: int,
                 tag: str | None, nbytes: int):
        self.name = name
        self.cols = cols
        self.nrows = nrows
        self.tag = tag
        self.nbytes = nbytes

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return (f"<ShmChunkRef {self.name} rows={self.nrows} "
                f"cols={len(self.cols)} bytes={self.nbytes}>")

    def __reduce__(self):
        return (ShmChunkRef,
                (self.name, self.cols, self.nrows, self.tag, self.nbytes))


def _seg_path(name: str) -> str:
    return os.path.join(_SHM_DIR, name)


def _pwrite_all(fd: int, buf, offset: int) -> None:
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    if mv.format != "B":
        mv = mv.cast("B")
    while mv.nbytes:
        n = os.pwrite(fd, mv, offset)
        mv = mv[n:]
        offset += n


def transpose_rows(rows: Sequence[Any]) -> list[tuple] | None:
    """Equal-arity tuple-like rows → per-column value tuples, or None.

    ONE C-level pass (``zip(*rows)``) instead of a per-column, per-row
    indexing loop — the transpose behind :func:`columnarize`'s feeder-side
    columnarization.  (The serving ingest, ``serving.ingest_chunks``,
    extracts per needed column with ``operator.itemgetter`` instead: a
    partition often carries more columns than the model reads, so a full
    transpose would touch fields serving never uses.)  Returns None on
    mixed arity or rows without a length (the caller falls back to its
    per-row path)."""
    if not rows:
        return None
    try:
        ncols = len(rows[0])
        if any(len(r) != ncols for r in rows):
            return None  # mixed arity: don't silently truncate rows
    except TypeError:
        return None
    return list(zip(*rows))


def columnarize(rows: Sequence[Any]) -> list[np.ndarray] | None:
    """Rows → contiguous fixed-dtype column arrays, or None.

    EXACTLY the consumer's row→column convention (``DataFeed``): tuple/list
    rows become one array per field, anything else becomes a single column.
    Returns None — caller falls back to the pickled-rows path — for empty
    input, ragged rows, or object-dtype columns (arbitrary Python payloads
    must keep riding pickle, which can serialize them)."""
    if not rows:
        return None
    first = rows[0]
    try:
        if isinstance(first, (list, tuple)) and not np.isscalar(first):
            transposed = transpose_rows(rows)
            if transposed is None:
                return None
            cols = [np.asarray(col) for col in transposed]
        else:
            cols = [np.asarray(rows)]
    except Exception:
        return None  # ragged shapes (numpy >= 1.24 raises) or mixed arity
    for c in cols:
        if c.dtype.hasobject:
            return None
    return cols


def write_chunk(cols: Sequence[np.ndarray], tag: str | None = None
                ) -> ShmChunkRef | None:
    """Park columns in one fresh segment; return its descriptor.

    Written with ``pwrite`` through the fd — no mapping on the writer side,
    so the feeder never pays fresh-mmap page faults (the cost that dominates
    on sandboxed kernels) and holds no state that could dangle.  Returns
    None on ANY failure (``/dev/shm`` full, permissions, exotic dtype) —
    the caller falls back to the pickled columnar path, so a degraded host
    degrades throughput, never correctness."""
    metas: list[tuple] = []
    offset = 0
    contig = []
    for c in cols:
        c = np.ascontiguousarray(c)
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
        metas.append((c.shape, c.dtype.str, offset))
        offset += c.nbytes
        contig.append(c)
    total = max(offset, 1)
    name = (f"{SEG_PREFIX}_{os.getpid()}_{_my_start_tick()}_"
            f"{secrets.token_hex(6)}")
    path = _seg_path(name)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    except OSError as e:
        logger.warning("shm segment create failed (%r); falling back to "
                       "pickled columnar transport", e)
        return None
    try:
        os.ftruncate(fd, total)
        for c, (shape, dt, off) in zip(contig, metas):
            try:
                buf = memoryview(c).cast("B")
            except (TypeError, ValueError):
                buf = c.tobytes()  # exotic dtypes that won't cast flat
            _pwrite_all(fd, buf, off)
        nrows = int(contig[0].shape[0]) if contig else 0
        return ShmChunkRef(name, tuple(metas), nrows, tag, total)
    except Exception as e:
        logger.warning("shm chunk write failed (%r); falling back", e)
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    finally:
        os.close(fd)


def read_chunk(ref: ShmChunkRef, copy: bool = False
               ) -> tuple[list[np.ndarray], str | None]:
    """Consume a descriptor: attach, build the columns, unlink.

    With ``copy=False`` (the zero-copy default) the returned arrays are
    views over the mapped segment; the segment name is unlinked immediately
    (the mapping stays valid until the views die — POSIX semantics), the fd
    is closed (mappings don't need it, and thousands of chunks would
    exhaust descriptors), and the pages are freed by the ``mmap`` object's
    own destructor once the last view's base chain (ndarray → mmap) drops —
    nothing further is owed to ``/dev/shm``.  ``copy=True`` reads through
    the fd into fresh arrays instead (no mapping at all).  Either way the
    segment is consumed — a descriptor is read-once."""
    import mmap as _mmap_mod

    path = _seg_path(ref.name)
    try:
        fd = os.open(path, os.O_RDONLY if copy else os.O_RDWR)
    except FileNotFoundError:
        raise RuntimeError(
            f"shm chunk {ref.name!r} vanished before it was consumed — "
            "its creator died and the orphan sweep reaped it, or something "
            "else unlinked /dev/shm out from under the feed") from None
    if copy:
        try:
            out = []
            for shape, dt, off in ref.cols:
                nbytes = int(np.prod(shape, dtype=np.int64)
                             * np.dtype(dt).itemsize)
                raw = np.empty(nbytes, dtype=np.uint8)
                mv = memoryview(raw)
                read = 0
                while read < nbytes:
                    n = os.preadv(fd, [mv[read:]], off + read)
                    if n <= 0:
                        raise RuntimeError(
                            f"short read from shm chunk {ref.name!r}")
                    read += n
                out.append(raw.view(dt).reshape(shape))
        finally:
            os.close(fd)
            try:
                os.unlink(path)
            except OSError:
                pass
        return out, ref.tag
    try:
        # MAP_POPULATE pre-faults the whole segment in one syscall — on
        # sandboxed kernels per-access minor faults cost ~3× the read
        # itself (measured on this container: 33 ms vs 10 ms per 16 MiB)
        flags = _mmap_mod.MAP_SHARED | getattr(_mmap_mod, "MAP_POPULATE", 0)
        mm = _mmap_mod.mmap(fd, max(ref.nbytes, 1), flags=flags)
    finally:
        os.close(fd)
    buf = None
    try:
        buf = memoryview(mm)
        views = [np.ndarray(shape, dtype=dt, buffer=buf, offset=off)
                 for shape, dt, off in ref.cols]
        del buf
    except Exception:
        # a corrupt descriptor (bad shape/offset/dtype) must surface ITS
        # error: close() with live exports raises BufferError, which would
        # mask it — release what we can, let GC reap the rest
        try:
            if buf is not None:
                buf.release()
            mm.close()
        except BufferError:
            pass
        raise
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    return views, ref.tag


def unlink_ref(ref: ShmChunkRef) -> bool:
    """Discard an unconsumed descriptor's segment (terminate-drain path)."""
    try:
        os.unlink(_seg_path(ref.name))
    except OSError:
        return False
    return True


def maybe_unlink_payload(payload: Any) -> None:
    """Best-effort cleanup of a queue payload that failed to enqueue."""
    if isinstance(payload, ShmChunkRef):
        try:
            unlink_ref(payload)
        except Exception:
            pass


def encode_chunk(rows: list[Any], tag: str | None = None,
                 transport: str | None = None) -> Any:
    """Feeder-side one-stop: columnarize ONCE and pick the transport.

    Returns the queue payload — :class:`ShmChunkRef` (shm), a
    :class:`~tensorflowonspark_torch.marker.ColumnarChunk` (pickled columnar),
    or the legacy rows payload (``TaggedChunk`` / plain list) when the rows
    cannot be columnarized.  ``transport`` forces a path for benchmarking:
    ``"shm"``, ``"pickle"`` (columnar, no shm), ``"rows"`` (legacy) or
    None = auto (:func:`enabled`)."""
    from tensorflowonspark_torch import marker

    def legacy():
        return marker.TaggedChunk(tag, rows) if tag is not None else rows

    if transport == "rows":
        return legacy()
    cols = columnarize(rows)
    if cols is None:
        return legacy()
    use_shm = enabled() if transport is None else (
        transport == "shm" and shm_available())
    if use_shm:
        ref = write_chunk(cols, tag=tag)
        if ref is not None:
            return ref
    return marker.ColumnarChunk(cols, tag=tag)


def resident_stats() -> tuple[int, int]:
    """``(live_segments, resident_bytes)`` of this host's feed segments.

    One ``/dev/shm`` directory scan over ``tfos_torch_feed_*`` names — the
    ground truth a leak is measured against, independent of any queue's
    own accounting.  Segments raced away mid-scan are skipped."""
    if not os.path.isdir(_SHM_DIR):
        return 0, 0
    count = nbytes = 0
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return 0, 0
    for fn in names:
        if not fn.startswith(SEG_PREFIX + "_"):
            continue
        try:
            st = os.stat(os.path.join(_SHM_DIR, fn))
        except OSError:
            continue
        count += 1
        nbytes += st.st_size
    return count, nbytes


def update_gauges() -> tuple[int, int]:
    """Refresh the ``shm_segments_live`` / ``shm_bytes_resident`` gauges
    from :func:`resident_stats`; returns the stats.

    Called from every TFManager server's watch thread (each executor host
    polices and *reports* its own ``/dev/shm``) and by the leak checks in
    ``tests/test_shm.py`` — a transport that leaks shows up as a nonzero
    gauge on the very next watch cycle, not as a mystery OOM later."""
    count, nbytes = resident_stats()
    from tensorflowonspark_torch import obs

    obs.gauge("shm_segments_live",
              "feed segments currently resident in /dev/shm").set(
        count)
    obs.gauge("shm_bytes_resident",
              "bytes pinned by feed segments in /dev/shm").set(
        nbytes)
    return count, nbytes


def keepalive(names: "Iterable[str]") -> None:
    """Refresh the mtime of in-flight segments (sweep keep-alive).

    Exclusion lists only protect segments from the excluding sweeper — but
    a host can run several TFManager servers (one per executor), and each
    only knows ITS OWN queues.  Touching the file makes the protection
    host-visible: every sweeper judges age from mtime, so a descriptor's
    owner re-touching its segments each watch cycle (30 s, against a 60 s
    grace) keeps them safe from every other manager's sweep — and from the
    TOCTOU where a consumer dequeues between a sweeper's queue snapshot and
    its unlink (the last touch still covers the dequeue→attach window).
    Best-effort: a segment consumed mid-iteration is simply skipped."""
    for name in names:
        try:
            os.utime(_seg_path(name))
        except OSError:
            pass


def sweep_orphans(grace_s: float = DEFAULT_SWEEP_GRACE_S,
                  exclude: "frozenset[str] | set[str] | tuple" = ()) -> int:
    """Reap feed segments whose creator process is dead.

    A feeder that is SIGKILLed (or a whole executor that dies) between
    ``write_chunk`` and the consumer's ``read_chunk`` leaves a named
    segment nobody will ever unlink.  Names carry the creator's ``(pid,
    start tick)``; a segment older than ``grace_s`` whose creator is
    provably gone (``TFManager._pid_alive`` — pid-reuse-proof) is
    unlinked.  Indeterminate liveness keeps the segment (same bias as the
    manager orphan watch).  Returns the number reaped.  Runs periodically
    inside every TFManager server's orphan-watch thread, so each executor
    host polices its own ``/dev/shm``.

    ``exclude`` holds segment names that are known to still be in flight
    and must never be reaped regardless of age — the manager passes the
    names referenced by descriptors currently sitting in its queues, since
    a feeder pid exiting NORMALLY after a successful handoff (short-lived
    Spark task workers) says nothing about whether the trainer has gotten
    to the chunk yet; ``grace_s`` then only needs to cover the
    dequeue→attach window, not total queue residency."""
    if not os.path.isdir(_SHM_DIR):
        return 0
    from tensorflowonspark_torch import TFManager

    reaped = 0
    now = time.time()
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return 0
    for fn in names:
        if not fn.startswith(SEG_PREFIX + "_") or fn in exclude:
            continue
        parts = fn[len(SEG_PREFIX) + 1:].split("_")
        if len(parts) != 3:
            continue
        try:
            pid, tick = int(parts[0]), int(parts[1])
        except ValueError:
            continue
        path = os.path.join(_SHM_DIR, fn)
        try:
            age = now - os.stat(path).st_mtime
        except OSError:
            continue  # raced another sweeper / the consumer
        if age < grace_s:
            continue
        if TFManager._pid_alive(pid, tick or None) is not False:
            continue  # alive or indeterminate: keep serving it
        try:
            os.unlink(path)
            reaped += 1
            logger.warning("reaped orphaned shm feed segment %s "
                           "(creator pid %d is gone)", fn, pid)
        except OSError:
            pass
    return reaped
