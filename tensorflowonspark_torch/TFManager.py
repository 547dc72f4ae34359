"""Per-executor shared-state manager: feed queues + key/value dict.

A copy of ``tensorflowonspark_tpu/TFManager.py`` with its imports rewritten.

Reference anchor: ``tensorflowonspark/TFManager.py::TFManager.start`` /
``TFManager.connect`` / ``_get`` / ``_set`` / ``_get_queue``.

This is the *data plane* between the short-lived Spark task processes (which
push partition data) and the long-lived trainer process (which consumes it
through :class:`tensorflowonspark_torch.TFNode.DataFeed`).  A
``multiprocessing.managers.BaseManager`` server process owns a dict of named
``queue.Queue`` objects plus a kv dict; any process on the host (or, in
``remote`` mode, on the network) can connect with the address + authkey that
the node runtime published into ``cluster_info``.

Departures from the reference:

- Queue payloads in the TPU rebuild are **columnar chunks**, not single
  pickled rows — the row-at-a-time queue was the reference's main
  bottleneck (``SURVEY.md §3.2``).  On the zero-copy path
  (:mod:`tensorflowonspark_torch.shm`) the queue carries only small
  ``ShmChunkRef`` descriptors and this server never touches the payload.
  The manager itself is payload-agnostic.
- Queues are **byte-bounded** as well as chunk-bounded
  (:class:`_ByteBoundedQueue`, ``TFOS_FEED_MAX_INFLIGHT_MB``): with
  columnar chunks, a chunk-count bound alone can pin gigabytes.
- The orphan watch doubles as the ``/dev/shm`` janitor: it periodically
  runs :func:`tensorflowonspark_torch.shm.sweep_orphans` so segments from
  killed feeder tasks are reclaimed.
- kv get/set round-trips go through one proxied dict (method calls on a proxy
  return plain values), avoiding the reference's proxy-wrapped scalars.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import queue as _queue_mod
import time as _time_mod
from multiprocessing.managers import BaseManager
from typing import Any, Iterable

# Module-level state — lives in the *manager server process* (spawn re-imports
# this module there; the callables below close over these globals).
_queues: dict[str, _queue_mod.Queue] = {}
_kv: dict[str, Any] = {}
_maxsize: list[int] = [1024]
_max_bytes: list[int] = [0]

#: default in-flight payload bound per queue, MB (``TFOS_FEED_MAX_INFLIGHT_MB``
#: overrides; 0 disables).  The chunk-count bound alone stopped meaning much
#: once chunks went columnar: 1024 queued 256-row float image chunks is
#: gigabytes of pinned host (or /dev/shm) memory.
DEFAULT_MAX_INFLIGHT_MB = 512


def _payload_nbytes(item: Any) -> int:
    """Descriptor-side byte accounting: columnar payloads (ShmChunkRef /
    ColumnarChunk / raw ndarray) declare ``nbytes``; legacy row lists and
    markers count 0 and stay bounded by chunk count alone."""
    try:
        return int(getattr(item, "nbytes", 0) or 0)
    except Exception:
        return 0


def _note_queue_delta(chunks: int, nbytes: int) -> None:
    """Continuous queue-residency telemetry: ``feed_queue_chunks`` /
    ``feed_queue_bytes`` gauges track what is sitting in this process's
    byte-bounded queues RIGHT NOW (summed across queues; incremented at
    ``put``, decremented at ``get``).

    Residency accounting only — a consumer holding a dequeued shm
    descriptor between ``get`` and ``read_chunk`` has already left these
    gauges (the documented ``_ByteBoundedQueue`` headroom caveat); the
    ``shm_bytes_resident`` gauge from the /dev/shm scan is the one that
    still sees those bytes.  Best-effort: telemetry must never break the
    data plane."""
    try:
        global _QUEUE_GAUGES
        if _QUEUE_GAUGES is None:
            from tensorflowonspark_torch import obs

            # handles cached: the data plane must not pay a registry
            # lookup per queue operation (same rule as the flight
            # recorder's instrument cache)
            _QUEUE_GAUGES = (
                obs.gauge("feed_queue_chunks",
                          "chunks currently queued in this process's "
                          "feed queues"),
                obs.gauge("feed_queue_bytes",
                          "payload bytes currently queued in this "
                          "process's feed queues (descriptor-side "
                          "accounting)"))
        _QUEUE_GAUGES[0].inc(chunks)
        _QUEUE_GAUGES[1].inc(nbytes)
    except Exception:
        pass


_QUEUE_GAUGES: "tuple | None" = None


class _ByteBoundedQueue(_queue_mod.Queue):
    """``queue.Queue`` with an additional in-flight payload-byte bound.

    ``put`` blocks (or raises ``Full``) while admitting the item would push
    queued payload bytes past ``max_bytes`` — ON TOP of the chunk-count
    bound, which remains as floor.  A single item larger than ``max_bytes``
    is admitted when the queue is byte-empty (otherwise it could never be
    fed at all); the byte bound is back-pressure, not a message-size limit.
    Shm descriptors are accounted at their referenced segment size, and
    bytes are held from ``put`` until ``get`` — queue residency.  The true
    ``/dev/shm`` high-water mark can therefore exceed the bound by what the
    consumer holds between dequeue and ``read_chunk``'s unlink (at most the
    DataFeed buffer plus ``prefetch`` staged batches), so size the bound
    with that headroom in mind; it is back-pressure on the unbounded term,
    not a hard memory cap.
    """

    def __init__(self, maxsize: int, max_bytes: int = 0):
        super().__init__(maxsize)
        self.max_bytes = int(max_bytes)
        self._queued_bytes = 0
        self._nbytes_fifo: collections.deque = collections.deque()
        # set (under mutex) by _del_queue when it releases this queue's
        # remaining gauge residency: an op completing AFTER the release
        # must not touch the gauges again (double-decrement would drive
        # the process-wide residency negative forever)
        self._gauges_released = False

    def _over(self, nb: int) -> bool:
        if 0 < self.maxsize <= self._qsize():
            return True
        return (self.max_bytes > 0 and self._queued_bytes > 0
                and self._queued_bytes + nb > self.max_bytes)

    def put(self, item, block=True, timeout=None):
        nb = _payload_nbytes(item)
        with self.not_full:
            if not block:
                if self._over(nb):
                    raise _queue_mod.Full
            elif timeout is None:
                while self._over(nb):
                    self.not_full.wait()
            elif timeout < 0:
                raise ValueError("'timeout' must be a non-negative number")
            else:
                endtime = _time_mod.monotonic() + timeout
                while self._over(nb):
                    remaining = endtime - _time_mod.monotonic()
                    if remaining <= 0.0:
                        raise _queue_mod.Full
                    self.not_full.wait(remaining)
            self._put(item)
            self._nbytes_fifo.append(nb)
            self._queued_bytes += nb
            self.unfinished_tasks += 1
            self.not_empty.notify()
            # gauge delta INSIDE the mutex: the _gauges_released check and
            # the update must be atomic against _del_queue's flag+snapshot,
            # or an op completing between them double-counts (registry
            # locks nest safely under the queue mutex — nothing acquires
            # them in the other order)
            if not self._gauges_released:
                _note_queue_delta(1, nb)

    def get(self, block=True, timeout=None):
        with self.not_empty:
            if not block:
                if not self._qsize():
                    raise _queue_mod.Empty
            elif timeout is None:
                while not self._qsize():
                    self.not_empty.wait()
            elif timeout < 0:
                raise ValueError("'timeout' must be a non-negative number")
            else:
                endtime = _time_mod.monotonic() + timeout
                while not self._qsize():
                    remaining = endtime - _time_mod.monotonic()
                    if remaining <= 0.0:
                        raise _queue_mod.Empty
                    self.not_empty.wait(remaining)
            item = self._get()
            nb = self._nbytes_fifo.popleft() if self._nbytes_fifo else 0
            self._queued_bytes -= nb
            self.not_full.notify()
            if not self._gauges_released:  # atomic with put()'s rationale
                _note_queue_delta(-1, -nb)
        return item

    def inflight_bytes(self) -> int:
        with self.mutex:
            return self._queued_bytes


def _configured_max_bytes() -> int:
    raw = os.environ.get("TFOS_FEED_MAX_INFLIGHT_MB")
    try:
        mb = float(raw) if raw not in (None, "") else DEFAULT_MAX_INFLIGHT_MB
    except ValueError:
        mb = DEFAULT_MAX_INFLIGHT_MB
    return int(max(0.0, mb) * 1e6)


def proc_start_time(pid: int) -> int | None:
    """Kernel start tick of ``pid`` (clock ticks since boot), or None.

    Field 22 of ``/proc/<pid>/stat`` — the (pid, start_time) pair is the
    kernel's own unique process identity, immune to pid reuse.  Parsed
    from after the last ``)`` because the comm field may itself contain
    spaces and parens.  None off-Linux or for a dead pid (callers treat
    None as indeterminate).
    """
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            data = f.read()
        fields = data[data.rfind(b")") + 2:].split()
        return int(fields[19])  # stat field 22, 0-indexed after comm/state
    except Exception:
        return None


def _pid_alive(pid: int, recorded_start: int | None) -> bool | None:
    """Is ``pid`` the SAME process that recorded ``recorded_start``?

    False when the pid is gone or its start tick changed (a recycled pid
    now names an unrelated process — the pid-reuse hole: a
    busy host recycles pids fast enough that the orphan watch would keep
    a dead trainer's manager alive forever).  ``PermissionError`` means
    the pid EXISTS but belongs to another user — on a multi-tenant host
    that is itself evidence of reuse, and ``/proc/<pid>/stat`` stays
    world-readable, so the tick check still runs.  None = indeterminate
    (no /proc and signaling inconclusive): callers keep serving.
    """
    exists: bool | None = True
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # pid exists (someone else's process) — tick decides below
    except Exception:
        exists = None
    if recorded_start is not None:
        current = proc_start_time(pid)
        if current is not None and current != recorded_start:
            return False
    # a ZOMBIE is dead: a SIGKILLed spawned trainer lingers as a zombie
    # child of its (still-running) executor worker, passes signal-0, and
    # keeps its start tick — without this check the orphan watch (and the
    # elastic trainer-death detection) would consider it alive forever
    if _proc_state(pid) in (b"Z", b"X"):
        return False
    return exists


def _proc_state(pid: int) -> bytes | None:
    """One-letter kernel state of ``pid`` (``/proc/<pid>/stat`` field 3:
    R/S/D/Z/...), or None off-Linux / for a vanished pid."""
    try:
        with open(f"/proc/{int(pid)}/stat", "rb") as f:
            data = f.read()
        return data[data.rfind(b")") + 2:].split()[0]
    except Exception:
        return None


def _setup(qnames: Iterable[str], maxsize: int,
           parent_pid: int | None = None) -> None:
    _maxsize[0] = maxsize
    _max_bytes[0] = _configured_max_bytes()  # spawn child inherits env
    for name in qnames:
        _queues[name] = _ByteBoundedQueue(maxsize, _max_bytes[0])
    _start_orphan_watch(parent_pid)


def _start_orphan_watch(parent_pid: int | None) -> None:
    """Exit the manager server once every process it serves is gone.

    A node process that dies abruptly (e.g. the mid-run wedge watchdog's
    ``os._exit``, or a SIGKILL) orphans this server.  Beyond the leak, the
    orphan pins the multiprocessing ``resource_tracker`` pipe it inherited,
    which blocks the *driver's* interpreter exit in
    ``resource_tracker._stop`` (observed: a driver that handled the failure
    cleanly then hung forever at shutdown).

    "Everyone it serves" is NOT just the starting parent: in SPARK mode the
    bootstrap worker that started the manager may legitimately be reaped
    mid-job (``spark.python.worker.reuse=false``) while the spawned trainer
    still depends on the data plane — the node runtime publishes that
    trainer's pid as kv ``trainer_pid``, and the watch keeps serving while
    it is alive.  Only when the parent is gone AND no registered trainer is
    alive does the server exit, after a short grace that lets the driver
    drain the error/kv queues attributing the failure.  On any
    indeterminate liveness check it keeps serving (the pre-watch behavior).
    """
    if not parent_pid:
        return
    import threading
    import time

    grace = float(os.environ.get("TFOS_MANAGER_ORPHAN_GRACE_S", "15"))

    def _trainer_alive() -> bool:
        owner = _kv.get("trainer_pid")  # same-process global (server side)
        if not owner:
            return False
        # compare (pid, start tick), not pid alone: a recycled pid naming
        # an unrelated process must read as DEAD, or this server leaks
        # forever on a busy host (the pid-reuse hole).  The
        # node runtime records the tick beside the pid; None (off-Linux /
        # legacy writer) degrades to the old pid-only check.
        alive = _pid_alive(int(owner), _kv.get("trainer_pid_start"))
        return True if alive is None else alive  # indeterminate: serve

    def _sweep_shm(do_sweep: bool = True) -> None:
        # each executor host polices its own /dev/shm: feed segments whose
        # creator (a Spark task pid, identified by the same (pid, start
        # tick) pair as the trainer liveness check) died without handing
        # off are reaped so killed tasks never leak host memory.  Segments
        # referenced by descriptors still sitting in OUR queues are in
        # flight no matter how old — a short-lived feeder pid exits the
        # moment its put() returns, long before a slow trainer drains the
        # (possibly hundreds-of-MB) backlog — so they are excluded AND
        # mtime-touched: the touch is what protects them from OTHER
        # managers' sweeps on the same host (one server per executor, each
        # blind to the others' queues) and from the snapshot→unlink race.
        try:
            from tensorflowonspark_torch import shm

            queued: set[str] = set()
            for q in list(_queues.values()):
                try:
                    with q.mutex:
                        items = list(q.queue)
                except Exception:
                    continue
                for it in items:
                    if isinstance(it, shm.ShmChunkRef):
                        queued.add(it.name)
            # keepalive runs EVERY watch cycle (2 s against the 60 s sweep
            # grace — a 30× margin): the touch cadence, not the sweep
            # cadence, is what a throttled/stalled watch thread must not
            # let slip past a sibling manager's grace window
            shm.keepalive(queued)
            if do_sweep:
                shm.sweep_orphans(exclude=queued)
        except Exception:
            pass  # the watch must never die to a sweep hiccup

    def _publish_pipeline_stats() -> None:
        # live queue-occupancy + /dev/shm residency, refreshed every watch
        # cycle: the gauges land in THIS server process's registry, and the
        # same numbers go onto the kv blackboard (``pipeline_stats``) where
        # the driver's /pipeline endpoint reads them — the manager server
        # has no MetricsReporter of its own to ship through
        try:
            from tensorflowonspark_torch import shm

            qstats: dict[str, dict[str, int]] = {}
            for qname, q in list(_queues.items()):
                try:
                    with q.mutex:
                        qstats[qname] = {
                            "chunks": q._qsize(),
                            "bytes": int(getattr(q, "_queued_bytes", 0)),
                            "max_bytes": int(getattr(q, "max_bytes", 0)),
                            "maxsize": int(q.maxsize),
                        }
                except Exception:
                    continue
            segs, seg_bytes = shm.update_gauges()
            _kv["pipeline_stats"] = {
                "queues": qstats,
                "shm_segments_live": segs,
                "shm_bytes_resident": seg_bytes,
                "ts": _time_mod.time(),
            }
        except Exception:
            pass  # telemetry must never kill the watch

    def _drain_dead_node_queues() -> None:
        # chunks staged for a corpse will never be consumed, and their shm
        # segments would be keepalive-pinned by THIS manager's own sweep
        # exclusion forever (leaked host memory until every manager on the
        # host is gone).  Runs EVERY watch cycle while the node is lost:
        # a feeder mid-partition when the trainer died keeps delivering
        # until it notices the state, and a one-shot drain would strand
        # everything it enqueues after the first pass.
        from tensorflowonspark_torch import shm as _shm

        for qname, q in list(_queues.items()):
            if qname == "error":
                continue  # the attribution must stay drainable
            while True:
                try:
                    item = q.get(block=False)
                except Exception:
                    break
                try:
                    _shm.maybe_unlink_payload(item)
                except Exception:
                    pass

    def _mark_lost_if_trainer_vanished() -> None:
        # elastic membership: a trainer that VANISHES while its
        # node still reads "running" was killed from outside (SIGKILL,
        # preemption) — no code path of its own could report.  Mark the
        # node "lost" and leave an attributed error, so the driver's
        # anomaly detection confirms the death even where this manager
        # itself survives (a persistent executor worker keeps the parent
        # alive, so the reaping below never fires).
        if _kv.get("state") == "lost":
            _drain_dead_node_queues()
            return
        if _kv.get("state") != "running" or not _kv.get("trainer_pid"):
            return
        if _trainer_alive():
            return
        pid = _kv.get("trainer_pid")
        _kv["state"] = "lost"
        try:
            _get_queue("error").put(
                f"trainer process (pid {pid}) vanished without reporting "
                "(SIGKILL / preemption?) — node marked lost")
        except Exception:
            pass
        _drain_dead_node_queues()

    def watch() -> None:
        last_sweep = 0.0
        while True:
            time.sleep(2.0)
            now = time.monotonic()
            do_sweep = now - last_sweep >= 30.0
            if do_sweep:
                last_sweep = now
            _sweep_shm(do_sweep)
            _publish_pipeline_stats()
            _mark_lost_if_trainer_vanished()
            if os.getppid() == parent_pid:
                continue
            if _trainer_alive():
                continue
            time.sleep(grace)
            if not _trainer_alive():
                os._exit(0)

    threading.Thread(target=watch, name="tfos-manager-orphan-watch",
                     daemon=True).start()


def _get_queue(qname: str) -> _queue_mod.Queue:
    # Per-partition-task result queues ("output:<tag>") are named by
    # short-lived Spark tasks after the manager has started, so ":"-suffixed
    # names create on demand.  Plain names keep the fail-fast KeyError — a
    # typo ('inputs') must not become a silent empty queue that hangs get().
    q = _queues.get(qname)
    if q is None:
        if ":" not in qname:
            raise KeyError(qname)
        q = _queues.setdefault(qname,
                               _ByteBoundedQueue(_maxsize[0], _max_bytes[0]))
    return q


def _get_kv() -> dict[str, Any]:
    return _kv


def _del_queue(qname: str) -> bool:
    """Drop a dynamically-created queue (per-task result queues would
    otherwise accumulate in the server process forever).  Items still
    enqueued leave the residency gauges with the dropped queue — without
    the release here a failed task's undrained queue would read as
    phantom residency for the rest of the process."""
    q = _queues.pop(qname, None)
    if q is None:
        return False
    try:
        # flag + snapshot under ONE mutex hold: an op that pops/pushes
        # after this sees the flag and skips the gauges, an op that ran
        # before is already reflected in the snapshot — no double count
        # in either interleaving
        with q.mutex:
            q._gauges_released = True
            n, nb = q._qsize(), int(getattr(q, "_queued_bytes", 0))
        if n or nb:
            _note_queue_delta(-n, -nb)
    except Exception:
        pass
    return True


class _Router:
    """Server-side delivery to per-task result queues.

    Exposed as a proxied object (method calls on a proxy return plain
    pickled values — a registered *callable*'s return would be AutoProxy-
    wrapped, turning ``False`` into a truthy proxy).
    """

    def put(self, qname: str, item: Any, timeout: float = 300.0) -> bool:
        """Put onto a per-task result queue ONLY if it still exists.

        The trainer routes results through this instead of ``get_queue`` so
        a task that timed out and deleted its queue gets its late results
        dropped (returns False) — ``get_queue`` would silently re-create an
        orphan queue nobody reads, leaking in the server and eventually
        wedging the trainer on a full queue.  Existence is re-checked every
        second while blocked so a deletion mid-put also unblocks.  Raises
        ``queue.Full`` if the queue still exists but stayed full past
        ``timeout`` (callers back-pressuring a live consumer should retry).
        """
        import time

        deadline = time.monotonic() + timeout
        while True:
            q = _queues.get(qname)
            if q is None:
                return False
            try:
                q.put(item,
                      timeout=min(1.0, max(0.01, deadline - time.monotonic())))
                return True
            except _queue_mod.Full:
                if time.monotonic() >= deadline:
                    raise


_router = _Router()


def _get_router() -> _Router:
    return _router


class _TFManagerBase(BaseManager):
    pass


_TFManagerBase.register("get_queue", callable=_get_queue)
_TFManagerBase.register("get_kv", callable=_get_kv)
_TFManagerBase.register("del_queue", callable=_del_queue)
_TFManagerBase.register("get_router", callable=_get_router)


class TFManager:
    """Handle over the manager server, exposing the reference API shape."""

    def __init__(self, manager: _TFManagerBase, owns_server: bool):
        self._manager = manager
        self._owns_server = owns_server
        self._kv_proxy = None
        self._router_proxy = None

    # -- reference API -----------------------------------------------------

    def get_queue(self, qname: str):
        """Proxy to the named queue (``put/get/task_done/join/qsize``)."""
        return self._manager.get_queue(qname)

    def get(self, key: str, default: Any = None) -> Any:
        """kv read. Reference anchor: ``TFManager.py::_get``."""
        return self._kv().get(key, default)

    def set(self, key: str, value: Any) -> None:
        """kv write. Reference anchor: ``TFManager.py::_set``."""
        self._kv().update({key: value})

    def kv_snapshot(self) -> dict[str, Any]:
        """Full copy of the kv blackboard in one round-trip.

        Used by the driver's trace collection (``TFCluster.dump_trace``),
        which must *enumerate* the per-process ``trace:<node>:<pid>`` keys
        each node's processes published — ``get`` alone cannot.  ``copy()``
        (not ``keys()``/``items()``) because a dict is picklable across the
        proxy while dict views are not.
        """
        return dict(self._kv().copy())

    def del_queue(self, qname: str) -> None:
        """Remove a dynamically-created queue from the server."""
        self._manager.del_queue(qname)

    def put_route(self, qname: str, item: Any, timeout: float = 300.0) -> bool:
        """Deliver ``item`` to a per-task result queue if it still exists.

        Returns False (item dropped) when the queue was deleted — the
        feeding task timed out and is gone.
        """
        if self._router_proxy is None:
            self._router_proxy = self._manager.get_router()
        return bool(self._router_proxy.put(qname, item, timeout))

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        """Routable ``(host, port)`` of the manager server.

        A ``remote``-mode server binds ``''`` and reports ``0.0.0.0``, which
        is useless when published to other hosts via cluster_info — replace
        it with this host's routable IP (same as ``reservation.Server``).
        """
        host, port = self._manager.address  # type: ignore[misc]
        if host in ("", "0.0.0.0"):
            from tensorflowonspark_torch import util

            host = util.get_ip_address()
        return (host, port)

    def shutdown(self) -> None:
        if self._owns_server:
            self._manager.shutdown()

    def _kv(self):
        if self._kv_proxy is None:
            self._kv_proxy = self._manager.get_kv()
        return self._kv_proxy


def start(
    authkey: bytes,
    queues: Iterable[str],
    mode: str = "local",
    maxsize: int = 1024,
) -> TFManager:
    """Start the manager server process for this executor.

    Reference anchor: ``tensorflowonspark/TFManager.py::start``.  ``mode`` is
    ``"local"`` (bind loopback — SPARK input mode, all clients on-host) or
    ``"remote"`` (bind all interfaces — TENSORFLOW input mode, reachable from
    other processes/hosts).  ``maxsize`` bounds each queue so a fast feeder
    cannot balloon host memory (the reference's queues are unbounded *per
    item* but TFoS bounds via ``qsize`` checks; a bounded queue is simpler and
    gives the same back-pressure).
    """
    if mode not in ("local", "remote"):
        raise ValueError(f"mode must be 'local' or 'remote', got {mode!r}")
    host = "127.0.0.1" if mode == "local" else ""
    # spawn, not fork: the caller typically has live JAX threads, and forking
    # a multithreaded process deadlocks (JAX warns loudly about this).
    import os

    ctx = multiprocessing.get_context("spawn")
    mgr = _TFManagerBase(address=(host, 0), authkey=authkey, ctx=ctx)
    mgr.start(initializer=_setup,
              initargs=(list(queues), maxsize, os.getpid()))
    return TFManager(mgr, owns_server=True)


def connect(address: tuple[str, int] | list, authkey: bytes) -> TFManager:
    """Connect to an executor's manager from another process.

    Reference anchor: ``tensorflowonspark/TFManager.py::connect``.
    """
    # authkey must also be set on the *current* process for the connection
    # handshake digest to match.
    multiprocessing.current_process().authkey = authkey
    mgr = _TFManagerBase(address=(address[0], int(address[1])), authkey=authkey)
    mgr.connect()
    return TFManager(mgr, owns_server=False)
