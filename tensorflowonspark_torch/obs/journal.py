"""Causally-ordered fleet event journal + black-box crash dumps.

The fleet plane (:mod:`.fleet`) says *what* is happening; nothing says
*why, or in what order*.  Placement flips, generation-fenced regroups,
admission sheds and ``slo.burn`` firings were scattered over per-process
trace rings that die with their process — a SIGKILLed replica took the
whole story to the grave, and the characterization literature the flight
recorder was built on (arXiv:1810.11112, and the TensorFlow system
paper's debugging story, arXiv:1605.08695) argues attribution, not
aggregates, is what explains incidents.  This module is the audit
substrate: a typed, structured event journal every control-plane
transition appends to, durable enough to outlive its writer.

Three pieces:

- **the journal** (:class:`Journal`): a bounded per-process ring of
  typed events (:data:`EVENT_TYPES`), each stamped with a **hybrid
  ordering key** ``(gen, ts, node, pid, seq)``: the membership
  generation is the causal fence (a regroup's barrier guarantees every
  gen-N event happened before any gen-N+1 event, no matter whose clock
  is skewed), wall clock orders within a generation (clamped monotonic
  per process, so a local clock step cannot reorder a process against
  itself), and ``(node, pid, seq)`` is the deterministic tie-break that
  preserves per-process program order.  One total order,
  :func:`order_key`-sortable, survives clock skew ACROSS the fence —
  skew within a generation is bounded only by honesty, which is why the
  key leads with the fence.
- **durability**: events are cadence-flushed as JSON lines through the
  :mod:`tensorflowonspark_torch.fs` seam to a spool directory
  (``TFOS_JOURNAL_DIR``), one file per process — an append every
  ``flush_interval_s`` on the appending thread, so a SIGKILL loses at
  most one cadence of tail, never the story.  :func:`read_spool` merges
  every process's file back (torn trailing lines from a mid-write kill
  are skipped, not fatal); ``GET /fleet/events`` serves the merged
  order with since-cursor pagination (:func:`encode_cursor`).
- **black-box dumps** (:func:`blackbox_dump`): on crash / SIGTERM /
  anomaly-finding, bundle the last-N journal events + trace ring +
  retained request traces + flight records + metrics snapshot into one
  digest-sidecar-verified JSON in the spool dir (the compile-cache
  write discipline: payload first, sidecar second — a reader accepts a
  bundle only when its digest matches, so a half-written crash dump is
  skipped, never half-loaded).  The router's death handling stamps the
  corpse's last flushed spool state (:func:`corpse_bundle`) into the
  ``replica.death`` event — the death record names exactly what the
  dead process managed to say.

``TFOS_JOURNAL=0`` disables recording (the enabled check is memoized on
the raw env string — no parse on the hot path, the trace.py
discipline).  Emission sites are control-plane transitions (placement,
membership, shed verdicts, SLO fire/clear, decode slot lifecycle,
compile-cache spool), not per-row data paths: the bench ``--incident``
round holds the A/B cost at the noise floor.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import signal as _signal
import threading
import time
from collections import deque
from typing import Any, Iterable, Mapping

logger = logging.getLogger(__name__)

#: the typed vocabulary: an unknown type is a programming error, not a
#: log line — callers are all in-tree, and ``tools/check_trace.py
#: --journal`` validates emitted files against this same set
EVENT_TYPES = frozenset({
    # placement control loop (mesh.py)
    "placement.publish",      # version flip published to the kv
    "placement.applied",      # a replica confirmed a placement version
    # membership (mesh.py / elastic.py / reservation.py)
    "replica.join",           # member registered / join absorbed
    "replica.death",          # membership authority declared it dead
    "replica.fenced",         # the corpse observed its own fencing
    "mesh.regroup",           # serving-mesh generation bump
    "elastic.regroup",        # training-cluster generation bump
    "generation.begin",       # rendezvous server opened a generation
    # admission + SLO judgment (online.py / mesh.py)
    "admission.shed",         # a request refused at the byte bound
    "slo.fire",               # slo.burn finding newly firing
    "slo.clear",              # a previously-firing objective cleared
    # cost accounting (obs/ledger.py / mesh.py)
    "cost.skew",              # fleet.cost_skew finding newly firing
    "cost.skew_clear",        # a previously-firing cost skew cleared
    # artifact/spool lifecycle (compile_cache.py)
    "compile_cache.spool",    # entries pushed to the shared namespace
    # decode slot lifecycle (decode.py)
    "decode.admit",           # pending request admitted to a slot
    "decode.prefill",         # prompt fully in cache, first token out
    "decode.cow_copy",        # shared page copied before divergent write
    "decode.retire",          # slot retired (ok / error)
    "decode.cancel",          # cancelled mid-stream
    # the journal's own lifecycle
    "journal.start",          # process configured its journal
    "blackbox.dump",          # a black-box bundle was written
})

#: per-process ring depth (``TFOS_JOURNAL_RING`` overrides)
DEFAULT_RING = 1024
#: seconds between spool appends; a SIGKILL loses at most this much tail
DEFAULT_FLUSH_INTERVAL_S = 1.0
#: spool directory env var (the fs.py seam: any registered scheme works)
JOURNAL_DIR_ENV = "TFOS_JOURNAL_DIR"
#: black-box bundle schema tag
BLACKBOX_SCHEMA = "tfos.blackbox/1"

_ENABLED_CACHE: tuple[str | None, bool] = (None, True)


def enabled() -> bool:
    """``TFOS_JOURNAL`` gate, memoized on the raw env string."""
    global _ENABLED_CACHE
    raw = os.environ.get("TFOS_JOURNAL", "1")
    cached = _ENABLED_CACHE
    if raw == cached[0]:
        return cached[1]
    on = raw.strip().lower() not in ("0", "false", "no", "off")
    _ENABLED_CACHE = (raw, on)
    return on


def _ring_default() -> int:
    raw = os.environ.get("TFOS_JOURNAL_RING", "").strip()
    if raw:
        try:
            v = int(raw)
            if v >= 16:
                return v
            logger.warning("TFOS_JOURNAL_RING=%r below the minimum of "
                           "16; using default %d", raw, DEFAULT_RING)
        except ValueError:
            logger.warning("TFOS_JOURNAL_RING=%r unparseable; using "
                           "default %d", raw, DEFAULT_RING)
    return DEFAULT_RING


def order_key(ev: Mapping[str, Any]) -> tuple:
    """The hybrid total-order key: ``(gen, ts, node, pid, seq)``.

    Generation first — the causal fence that survives clock skew (module
    doc); wall clock within a generation; ``(node, pid, seq)`` as the
    deterministic tie-break preserving per-process program order."""
    return (int(ev.get("gen") or 0), float(ev.get("ts") or 0.0),
            str(ev.get("node") or ""), int(ev.get("pid") or 0),
            int(ev.get("seq") or 0))


def encode_cursor(ev: Mapping[str, Any]) -> str:
    """Opaque pagination cursor naming one event's position in the
    total order (``GET /fleet/events?since=<cursor>``).  ``ts`` is
    encoded with ``repr`` — an exact float round trip; a truncating
    format would re-serve the boundary event on every page."""
    gen, ts, node, pid, seq = order_key(ev)
    return f"{gen}:{ts!r}:{node}:{pid}:{seq}"


def decode_cursor(cursor: str) -> tuple | None:
    """Cursor → order key; None when malformed (a bad cursor reads from
    the start rather than erroring — pagination must be forgiving)."""
    try:
        gen_s, ts_s, node, pid_s, seq_s = cursor.split(":", 4)
        # node itself may not contain ":" (configure() enforces it)
        return (int(gen_s), float(ts_s), node, int(pid_s), int(seq_s))
    except (ValueError, AttributeError):
        return None


def merge_events(*event_lists: Iterable[Mapping[str, Any]]
                 ) -> list[dict[str, Any]]:
    """Merge event lists from many processes into ONE total order.

    Deduplicates on ``(node, pid, seq)`` — a replica's events can arrive
    both via the shared spool and via a scrape, and must count once —
    then sorts by :func:`order_key`.  Deterministic: a pure function of
    the event sets."""
    seen: set[tuple] = set()
    out: list[dict[str, Any]] = []
    for events in event_lists:
        for ev in events or []:
            if not isinstance(ev, Mapping):
                continue
            ident = (str(ev.get("node") or ""), int(ev.get("pid") or 0),
                     int(ev.get("seq") or 0))
            if ident in seen:
                continue
            seen.add(ident)
            out.append(dict(ev))
    out.sort(key=order_key)
    return out


class Journal:
    """Per-process typed event journal: bounded ring + cadence spool.

    Thread-safe; :meth:`append` is the one write path.  ``seq`` is a
    GIL-atomic ``itertools.count`` (the trace-id PRNG discipline), the
    instruments are cached handles (no registry lookup per event), and a
    spool failure increments a counter and keeps serving — observability
    must never kill the control plane it observes.
    """

    def __init__(self, node: str = "driver",
                 capacity: int | None = None,
                 spool_dir: str | None = None,
                 flush_interval_s: float = DEFAULT_FLUSH_INTERVAL_S):
        self.node = str(node)
        cap = int(capacity) if capacity is not None else _ring_default()
        self._ring: deque = deque(maxlen=cap)
        #: appended-but-not-yet-spooled events; bounded like the ring so
        #: a wedged filesystem cannot grow memory without limit (overflow
        #: is counted, not silent)
        self._pending: deque = deque(maxlen=cap)
        self._seq = itertools.count()
        self._gen = 0
        self._lock = threading.Lock()
        self._spool_dir = spool_dir
        self.flush_interval_s = float(flush_interval_s)
        self._last_flush = 0.0
        self._last_ts = 0.0
        self._flush_errors = 0
        self._dropped = 0
        self._instruments = None

    # -- configuration -------------------------------------------------------

    def configure(self, node: str | None = None,
                  spool_dir: str | None = None,
                  capacity: int | None = None,
                  flush_interval_s: float | None = None) -> "Journal":
        """Set identity / spool; returns self.  Emits ``journal.start``
        when a spool is (re)configured so the spool file itself records
        who wrote it and since when."""
        if node:
            if ":" in node:
                # the cursor encoding and spool filenames use ":" and the
                # node name verbatim; a colon would corrupt both
                raise ValueError(f"journal node {node!r} must not "
                                 "contain ':'")
            self.node = node
        if capacity is not None:
            cap = int(capacity)
            with self._lock:
                self._ring = deque(self._ring, maxlen=cap)
                self._pending = deque(self._pending, maxlen=cap)
        if flush_interval_s is not None:
            self.flush_interval_s = float(flush_interval_s)
        if spool_dir is not None:
            self._spool_dir = spool_dir or None
        if self._spool_dir:
            self.append("journal.start", pid_start=True,
                        spool=self._spool_dir)
        return self

    @property
    def spool_dir(self) -> str | None:
        return self._spool_dir

    def spool_path(self) -> str | None:
        """This process's spool file (``journal-<node>-<pid>.jsonl``)."""
        if not self._spool_dir:
            return None
        from tensorflowonspark_torch import fs

        return fs.join(self._spool_dir,
                       f"journal-{self.node}-{os.getpid()}.jsonl")

    def set_generation(self, gen: int) -> None:
        """Advance the causal fence every subsequent event carries.
        Never moves backwards: a stale caller cannot un-fence."""
        with self._lock:
            self._gen = max(self._gen, int(gen))

    @property
    def generation(self) -> int:
        return self._gen

    def _metrics(self):
        if self._instruments is None:
            from tensorflowonspark_torch.obs import registry as _registry

            reg = _registry.get_registry()
            self._instruments = (
                reg.counter("journal_events_total",
                            "control-plane events appended to the "
                            "journal"),
                reg.counter("journal_flush_errors_total",
                            "journal spool appends that failed (events "
                            "kept in the ring, durability degraded)"),
                reg.counter("journal_dropped_total",
                            "journal events evicted before they could "
                            "be spooled (pending ring overflow)"),
            )
        return self._instruments

    # -- write path ----------------------------------------------------------

    def append(self, etype: str, ts: float | None = None,
               gen: int | None = None,
               **attrs: Any) -> dict[str, Any] | None:
        """Append one typed event; returns it (None when disabled).

        ``ts`` defaults to wall clock clamped monotonic per process (a
        backwards clock step cannot reorder this process against its own
        earlier events — the per-process half of the ordering claim).
        ``gen`` defaults to the journal's current generation fence.
        ``attrs`` must be JSON-able; they ride the event verbatim.
        """
        if etype not in EVENT_TYPES:
            raise ValueError(f"unknown journal event type {etype!r} "
                             f"(one of {sorted(EVENT_TYPES)})")
        if not enabled():
            return None
        events_total, flush_errors, dropped = self._metrics()
        now = time.time() if ts is None else float(ts)
        flush_due = False
        with self._lock:
            now = max(now, self._last_ts)
            self._last_ts = now
            ev = {"type": etype, "ts": now,
                  "gen": self._gen if gen is None else int(gen),
                  "seq": next(self._seq), "node": self.node,
                  "pid": os.getpid(), "attrs": attrs}
            self._ring.append(ev)
            if self._spool_dir:
                if len(self._pending) == self._pending.maxlen:
                    self._dropped += 1
                    dropped.inc()
                self._pending.append(ev)
                flush_due = (now - self._last_flush
                             >= self.flush_interval_s)
        events_total.inc()
        if flush_due:
            self.flush()
        return ev

    def flush(self) -> bool:
        """Append pending events to the spool file (JSON lines).

        Returns True when everything pending landed.  Never raises: a
        failed append puts the batch back at the front of the pending
        queue (bounded — repeated failure eventually counts drops) and
        increments ``journal_flush_errors_total``."""
        path = self.spool_path()
        if path is None:
            return True
        with self._lock:
            if not self._pending:
                self._last_flush = time.time()
                return True
            batch = list(self._pending)
            self._pending.clear()
            self._last_flush = time.time()
        payload = "".join(
            json.dumps(ev, sort_keys=True, default=str) + "\n"
            for ev in batch)
        try:
            from tensorflowonspark_torch import fs

            try:
                fs.makedirs(self._spool_dir)
            except Exception:
                pass  # exists / scheme without mkdir semantics
            with fs.open(path, "ab") as f:
                f.write(payload.encode("utf-8"))
            return True
        except Exception as e:
            _, flush_errors, _ = self._metrics()
            flush_errors.inc()
            self._flush_errors += 1
            with self._lock:
                # put the batch back ahead of anything appended since;
                # the deque bound applies (a dead filesystem costs the
                # oldest events, counted, never unbounded memory)
                for ev in reversed(batch):
                    self._pending.appendleft(ev)
            logger.debug("journal flush to %s failed: %s", path, e)
            return False

    # -- read path -----------------------------------------------------------

    def snapshot(self, since: str | tuple | None = None,
                 limit: int | None = None) -> list[dict[str, Any]]:
        """Ring events in total order, strictly after ``since`` (a
        cursor string or decoded key), at most ``limit``."""
        with self._lock:
            events = [dict(e) for e in self._ring]
        events.sort(key=order_key)
        if since is not None:
            key = (decode_cursor(since) if isinstance(since, str)
                   else tuple(since))
            if key is not None:
                events = [e for e in events if order_key(e) > key]
        if limit is not None:
            events = events[:int(limit)]
        return events

    def tail(self, n: int) -> list[dict[str, Any]]:
        """Last ``n`` events in total order (the black-box slice)."""
        events = self.snapshot()
        return events[-int(n):] if n else []

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"node": self.node, "gen": self._gen,
                    "ring": len(self._ring),
                    "pending": len(self._pending),
                    "spool": self.spool_path(),
                    "flush_errors": self._flush_errors,
                    "dropped": self._dropped}


# ---------------------------------------------------------------------------
# process-default journal
# ---------------------------------------------------------------------------

_JOURNAL = Journal(node="driver",
                   spool_dir=os.environ.get(JOURNAL_DIR_ENV) or None)


def get_journal() -> Journal:
    return _JOURNAL


def configure(node: str | None = None, spool_dir: str | None = None,
              capacity: int | None = None,
              flush_interval_s: float | None = None) -> Journal:
    """Configure the process-default journal.  ``spool_dir`` defaults to
    ``TFOS_JOURNAL_DIR`` when unset at import; pass it explicitly to
    (re)point the spool."""
    return _JOURNAL.configure(node=node, spool_dir=spool_dir,
                              capacity=capacity,
                              flush_interval_s=flush_interval_s)


def emit(etype: str, **attrs: Any) -> dict[str, Any] | None:
    """Append one event to the process-default journal."""
    return _JOURNAL.append(etype, **attrs)


# ---------------------------------------------------------------------------
# spool reads (the federation / forensics side)
# ---------------------------------------------------------------------------


def read_spool_file(path: str) -> list[dict[str, Any]]:
    """Events from one spool JSONL file.  A torn trailing line (the
    writer was SIGKILLed mid-append) or any unparseable line is skipped:
    forensics reads everything the corpse managed to say, not nothing."""
    from tensorflowonspark_torch import fs

    events: list[dict[str, Any]] = []
    try:
        with fs.open(path, "rb") as f:
            raw = f.read()
    except Exception as e:
        logger.debug("journal: cannot read spool %s: %s", path, e)
        return events
    for line in raw.decode("utf-8", "replace").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            continue  # torn tail / corruption: skip, keep reading
        if isinstance(ev, dict) and ev.get("type") in EVENT_TYPES:
            events.append(ev)
    return events


def spool_files(spool_dir: str, node: str | None = None) -> list[str]:
    """Journal spool files under ``spool_dir`` (``node`` filters to one
    process identity's files), name-sorted for determinism."""
    from tensorflowonspark_torch import fs

    try:
        names = fs.listdir(spool_dir)
    except Exception:
        return []
    want = f"journal-{node}-" if node else "journal-"
    return [fs.join(spool_dir, n) for n in sorted(names)
            if n.startswith(want) and n.endswith(".jsonl")]


def read_spool(spool_dir: str, node: str | None = None
               ) -> list[dict[str, Any]]:
    """Every process's spooled events under ``spool_dir``, merged into
    the one total order (:func:`merge_events`)."""
    return merge_events(*[read_spool_file(p)
                          for p in spool_files(spool_dir, node)])


# ---------------------------------------------------------------------------
# black-box dumps
# ---------------------------------------------------------------------------


def _digest(payload: bytes) -> str:
    import hashlib

    return hashlib.sha256(payload).hexdigest()


def blackbox_dump(reason: str, journal: Journal | None = None,
                  spool_dir: str | None = None, last_n: int = 256,
                  **attrs: Any) -> str | None:
    """Bundle the process's observability state into one crash dump.

    ``{"schema", "reason", "ts", "node", "pid", "gen", "events"
    (last-N journal), "trace" (tracer ring tail), "requests" (retained
    request traces), "flight" (flight-recorder report), "metrics"
    (registry snapshot)}`` written to
    ``<spool>/blackbox-<node>-<pid>-<ms>.json`` with a ``.sha256``
    sidecar (payload first, sidecar second — the compile-cache
    discipline, so a dump interrupted mid-write is rejected by
    :func:`read_blackbox`, never half-loaded).  Returns the path, or
    None without a spool.  Never raises — a failing dump must not mask
    the crash being dumped."""
    j = journal or _JOURNAL
    spool = spool_dir or j.spool_dir or os.environ.get(JOURNAL_DIR_ENV)
    if not spool:
        return None
    try:
        from tensorflowonspark_torch import fs
        from tensorflowonspark_torch.obs import flight as _flight
        from tensorflowonspark_torch.obs import registry as _registry
        from tensorflowonspark_torch.obs import trace as _trace

        ev = j.append("blackbox.dump", reason=str(reason)[:200], **attrs)
        doc = {
            "schema": BLACKBOX_SCHEMA,
            "reason": str(reason)[:200],
            "ts": time.time(),
            "node": j.node,
            "pid": os.getpid(),
            "gen": j.generation,
            "events": j.tail(last_n),
            "trace": _trace.get_tracer().snapshot()[-last_n:],
            "requests": _trace.get_trace_store().recent(limit=50),
            "flight": _flight.local_report(),
            "metrics": _registry.get_registry().snapshot(),
        }
        if ev is not None:
            doc["cursor"] = encode_cursor(ev)
        payload = json.dumps(doc, sort_keys=True, default=str
                             ).encode("utf-8")
        name = f"blackbox-{j.node}-{os.getpid()}-{int(time.time()*1000)}"
        path = fs.join(spool, name + ".json")
        try:
            fs.makedirs(spool)
        except Exception:
            pass
        with fs.open(path, "wb") as f:
            f.write(payload)
        with fs.open(path + ".sha256", "wb") as f:
            f.write(_digest(payload).encode("ascii"))
        j.flush()  # the dump event itself must reach the spool too
        return path
    except Exception as e:  # pragma: no cover - crash-path best effort
        logger.warning("journal: black-box dump (%s) failed: %s",
                       reason, e)
        return None


def read_blackbox(path: str) -> dict[str, Any] | None:
    """One digest-verified bundle; None when missing/corrupt/truncated
    (the sidecar contract: a bundle without a matching digest was
    interrupted mid-write and carries no trustworthy story)."""
    from tensorflowonspark_torch import fs

    try:
        with fs.open(path, "rb") as f:
            payload = f.read()
        with fs.open(path + ".sha256", "rb") as f:
            want = f.read().decode("ascii").strip()
    except Exception:
        return None
    if _digest(payload) != want:
        logger.warning("journal: black-box %s rejected (digest "
                       "mismatch: truncated or damaged)", path)
        return None
    try:
        doc = json.loads(payload.decode("utf-8"))
    except ValueError:
        return None
    return doc if isinstance(doc, dict) \
        and doc.get("schema") == BLACKBOX_SCHEMA else None


def blackbox_files(spool_dir: str, node: str | None = None) -> list[str]:
    """Black-box bundle paths under ``spool_dir`` (newest last)."""
    from tensorflowonspark_torch import fs

    try:
        names = fs.listdir(spool_dir)
    except Exception:
        return []
    want = f"blackbox-{node}-" if node else "blackbox-"
    return [fs.join(spool_dir, n) for n in sorted(names)
            if n.startswith(want) and n.endswith(".json")]


def corpse_bundle(spool_dir: str, node: str) -> dict[str, Any] | None:
    """What a dead process last managed to flush: its newest spooled
    journal state + newest valid black-box bundle, as a compact stamp
    the membership authority's ``replica.death`` event carries.

    ``{"spool": path|None, "last_event_ts", "last_cursor",
    "events_flushed", "blackbox": path|None, "blackbox_reason"}`` —
    None when the corpse never flushed anything (then the death event
    says exactly that)."""
    if not spool_dir:
        return None
    events = read_spool(spool_dir, node=node)
    bb_path = None
    bb_doc = None
    for path in reversed(blackbox_files(spool_dir, node=node)):
        bb_doc = read_blackbox(path)
        if bb_doc is not None:
            bb_path = path
            break
    if not events and bb_path is None:
        return None
    out: dict[str, Any] = {
        "spool": (spool_files(spool_dir, node=node) or [None])[-1],
        "events_flushed": len(events),
        "last_event_ts": events[-1]["ts"] if events else None,
        "last_cursor": encode_cursor(events[-1]) if events else None,
        "blackbox": bb_path,
    }
    if bb_doc is not None:
        out["blackbox_reason"] = bb_doc.get("reason")
    return out


def install_signal_dump(journal: Journal | None = None,
                        signums: Iterable[int] = (_signal.SIGTERM,)
                        ) -> None:
    """Chain a black-box dump onto ``signums`` (SIGTERM by default):
    the dump runs first, then any previously-installed handler — or,
    when the previous disposition was the default, the default action is
    restored and the signal re-raised so the process still dies (a
    black-box recorder that accidentally immortalizes its process would
    break every orchestrator's kill path).  SIGKILL is uncatchable by
    design — that case is exactly what the cadence flush exists for."""
    j = journal or _JOURNAL

    def _make(prev):
        def handler(signum, frame):  # pragma: no cover - signal path
            blackbox_dump(f"signal {signum}", journal=j)
            if callable(prev):
                prev(signum, frame)
            elif prev == _signal.SIG_DFL:
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)
        return handler

    for signum in signums:
        prev = _signal.getsignal(signum)
        _signal.signal(signum, _make(prev))
