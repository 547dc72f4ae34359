"""Tracing layer: spans + structured event log + blackboard shipping.

One event model serves all three observability layers (SURVEY.md §5 names
the reference's gap: "Python logging ... no metrics registry"; TF-Replicator
and the TensorFlow paper treat lifecycle tracing as first-class):

- a **span** is a timed phase (``with obs.span("reserve"): ...`` or the
  ``@obs.span("reserve")`` decorator) — it records one *complete* event
  with a wall-clock timestamp, a monotonic-derived duration, the node
  identity, thread id, and the enclosing span's name (nesting);
- an **instant event** (:func:`event`) marks a point occurrence (a stall,
  a collapsed MoE group, a dropped batch) with arbitrary attrs;
- every process keeps its events in a bounded **ring buffer**
  (:class:`Tracer`) — tracing must never grow memory or kill the hot loop;
- executor-side tracers **ship** their buffer to the driver through the
  existing TFManager kv blackboard (each process owns one kv key,
  ``trace:<node>:<pid>``, so concurrent writers never race), where
  ``TFCluster.dump_trace`` merges all nodes into a single
  Chrome-trace-format file (:mod:`tensorflowonspark_torch.obs.chrome`).

Event record (plain dict, JSON- and pickle-serializable)::

    {"name": str,          # phase name, dot-namespaced ("node.health_probe")
     "ph": "X" | "i",      # complete span | instant event
     "ts": float,          # µs since the epoch (wall clock, merge-coherent)
     "dur": float,         # µs (spans only)
     "node": "driver" | "<job_name>:<task_index>" | ...,
     "pid": int, "tid": int,
     "trace_id": str,       # 32-hex request/step identity (spans; W3C size)
     "span_id": str,        # 16-hex, unique per span
     "parent_span_id": str, # 16-hex, the enclosing/propagated span
     "attrs": {...}}       # including "parent": enclosing span name

**Trace identity**: every span carries a
``trace_id``/``span_id``/``parent_span_id`` — nesting links by span *id*,
not just the enclosing span's name.  The thread-local span stack still
cannot cross threads, so a :class:`TraceContext` minted where a request
enters (``OnlineServer.submit``, a W3C ``traceparent`` header) is handed
across queue/thread hops explicitly: :func:`with_context` installs it as
the ambient parent on the receiving thread, :func:`trace_context` reads
the current one for handoff.  Request-scoped span *trees* (the online
tier's per-request forensics) are collected by :class:`RequestTrace` and
tail-sampled into the bounded :class:`TraceStore` ring — complete trees
kept only for SLO breaches / sheds / errors plus a small uniform sample,
everything else dropped at commit.

Env knobs: ``TFOS_TRACE=0`` disables recording entirely (the record path
then costs one attribute check); ``TFOS_TRACE_CAPACITY`` sizes the ring
buffer (default 4096 events per process).  Request tracing has its own
knobs: ``TFOS_TRACE_REQUESTS=0`` disables per-request span trees,
``TFOS_TRACE_ARM`` sets the fraction of (uniform-population) requests
armed for capture (default 0.05 — explicit inbound contexts always arm,
sheds and invalid requests are always captured; see :func:`arm_rate`),
``TFOS_TRACE_SAMPLE`` sets the uniform keep fraction for unremarkable
armed requests (default 0.01), ``TFOS_TRACE_REQUESTS_CAPACITY`` bounds
the retained-trace ring (default 256 traces).
"""

from __future__ import annotations

import collections
import functools
import logging
import os
import random
import re
import threading
import time
from typing import Any, Callable

logger = logging.getLogger(__name__)

#: kv-blackboard key prefix under which each process publishes its events
TRACE_KV_PREFIX = "trace:"

_DEFAULT_CAPACITY = 4096


def _enabled_by_env() -> bool:
    return os.environ.get("TFOS_TRACE", "1") not in ("0", "", "false", "no")


def _capacity_from_env() -> int:
    try:
        return int(os.environ.get("TFOS_TRACE_CAPACITY", _DEFAULT_CAPACITY))
    except ValueError:
        return _DEFAULT_CAPACITY


# ---------------------------------------------------------------------------
# Trace identity + context propagation
# ---------------------------------------------------------------------------

#: W3C trace-context ``traceparent`` header: version-traceid-spanid-flags
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: longest header worth inspecting: the 55-char version-00 form plus
#: generous room for future-version members; anything longer is hostile
_TRACEPARENT_MAX_LEN = 512

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")
_SPAN_ID_RE = re.compile(r"^[0-9a-f]{16}$")

#: id generator: a private PRNG seeded from the OS once — ids are minted
#: on the request hot path, where an os.urandom syscall per id is real
#: overhead (measured; these are correlation ids, not secrets).
#: getrandbits on one instance is a single C call, atomic under the GIL.
_ID_RNG = random.Random()


def new_trace_id() -> str:
    """A fresh 128-bit lowercase-hex trace id (W3C size, never all-zero)."""
    v = _ID_RNG.getrandbits(128)
    while not v:  # pragma: no cover - 2^-128
        v = _ID_RNG.getrandbits(128)
    return f"{v:032x}"


def new_span_id() -> str:
    """A fresh 64-bit lowercase-hex span id (never all-zero)."""
    v = _ID_RNG.getrandbits(64)
    while not v:  # pragma: no cover - 2^-64
        v = _ID_RNG.getrandbits(64)
    return f"{v:016x}"


class TraceContext:
    """Immutable ``(trace_id, span_id)`` pair — the unit of propagation.

    Minted where a request enters the system (or parsed from an inbound
    W3C ``traceparent``), then handed across queue/thread hops the
    thread-local span stack cannot cross: the receiving side either opens
    spans under :func:`with_context` or stamps the ids explicitly.  The
    ``span_id`` names the span that is the *parent* of whatever the
    receiver records.
    """

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(new_trace_id(), new_span_id())

    def traceparent(self) -> str:
        """This context as a W3C ``traceparent`` header value."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))

    def __repr__(self) -> str:  # pragma: no cover - debug only
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


def parse_traceparent(header: str | None) -> TraceContext | None:
    """Parse a W3C ``traceparent`` header; None for anything malformed.

    Lenient by design (tracing must never fail a request): bad version,
    all-zero ids, wrong field sizes all return None — the request simply
    starts a fresh trace instead of erroring.  Oversized headers are
    rejected outright (bounded work on hostile input); future-version
    headers with extra dash-separated members parse their first four
    fields per the W3C forward-compatibility rule.
    """
    if not header or not isinstance(header, str):
        return None
    if len(header) > _TRACEPARENT_MAX_LEN:  # bound work on hostile input
        return None
    value = header.strip().lower()
    # W3C forward compatibility: versions above 00 may append extra
    # dash-separated members — parse the first four fields, ignore the
    # rest.  Version 00 is exactly four fields; trailing data rejects.
    head, _, rest = value.partition("-")
    if head != "00" and rest.count("-") > 2:
        value = "-".join([head] + rest.split("-")[:3])
    m = _TRACEPARENT_RE.match(value)
    if not m or m.group(1) == "ff":
        return None
    trace_id, span_id = m.group(2), m.group(3)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id)


def format_traceparent(ctx: TraceContext) -> str:
    """``TraceContext`` → W3C ``traceparent`` header value."""
    return ctx.traceparent()


class _AmbientContext:
    """Installs a :class:`TraceContext` as a thread's ambient parent —
    the explicit half of context propagation (see :func:`with_context`).
    Re-entrant: the previous ambient context is restored on exit."""

    __slots__ = ("_tracer", "_ctx", "_prev")

    def __init__(self, tracer: "Tracer", ctx: TraceContext | None):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self) -> TraceContext | None:
        local = self._tracer._local
        self._prev = getattr(local, "ctx", None)
        local.ctx = self._ctx
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._local.ctx = self._prev


class Tracer:
    """Per-process event recorder: bounded ring buffer + optional shipping.

    ``node`` is the identity stamped on every event (``"driver"`` until
    :meth:`configure` names it).  ``mgr`` (a
    :class:`tensorflowonspark_torch.TFManager.TFManager` handle) enables
    shipping: :meth:`flush` publishes the current buffer snapshot under
    this process's own kv key — idempotent full-snapshot overwrite, so a
    crash between flushes loses at most ``flush_interval`` events and two
    processes never contend on one key.  Recording is cheap (deque append
    under a lock); shipping is throttled (every ``flush_interval`` events
    or ``flush_interval_s`` seconds, whichever comes first) and never
    raises into the instrumented code path.
    """

    def __init__(self, node: str = "driver", capacity: int | None = None):
        self.node = node
        self.enabled = _enabled_by_env()
        self.capacity = capacity or _capacity_from_env()
        self.dropped = 0
        self.flush_interval = 64
        self.flush_interval_s = 2.0
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()  # per-thread span stack
        self._mgr = None
        self._since_flush = 0
        # from construction, not 0.0: monotonic() is machine uptime, and
        # "uptime > flush_interval_s" must not make the first event flush
        self._last_flush = time.monotonic()

    # -- configuration -----------------------------------------------------

    def configure(self, node: str | None = None, mgr: Any = None,
                  capacity: int | None = None) -> "Tracer":
        """Set node identity / blackboard manager; returns self."""
        if node:
            self.node = node
        if mgr is not None:
            self._mgr = mgr
        if capacity and capacity != self.capacity:
            with self._lock:
                self.capacity = capacity
                self._events = collections.deque(self._events,
                                                 maxlen=capacity)
        return self

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        """Per-thread stack of ``(name, span_id, trace_id)`` entries."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- context propagation -------------------------------------------------

    def current_context(self) -> TraceContext | None:
        """The context a hop should carry: the innermost open span on this
        thread, else the ambient context installed by :meth:`with_context`,
        else None (nothing to propagate)."""
        st = getattr(self._local, "stack", None)
        if st:
            _, span_id, trace_id = st[-1]
            return TraceContext(trace_id, span_id)
        return getattr(self._local, "ctx", None)

    def with_context(self, ctx: TraceContext | None) -> _AmbientContext:
        """Context manager installing ``ctx`` as this thread's ambient
        parent: spans opened inside (with an empty span stack) join
        ``ctx``'s trace as children of ``ctx.span_id`` — the hop the
        thread-local span stack cannot make on its own.  ``None`` is
        accepted and clears the ambient context (propagating "no trace"
        is a valid handoff)."""
        return _AmbientContext(self, ctx)

    def record(self, name: str, ph: str, ts_us: float,
               dur_us: float | None = None,
               attrs: dict[str, Any] | None = None, *,
               trace_id: str | None = None,
               span_id: str | None = None,
               parent_span_id: str | None = None) -> None:
        if not self.enabled:
            return
        ev: dict[str, Any] = {
            "name": name,
            "ph": ph,
            "ts": ts_us,
            "node": self.node,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if dur_us is not None:
            ev["dur"] = dur_us
        if trace_id:
            ev["trace_id"] = trace_id
            if span_id:
                ev["span_id"] = span_id
            if parent_span_id:
                ev["parent_span_id"] = parent_span_id
        if attrs:
            ev["attrs"] = attrs
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)
            self._since_flush += 1
            want_flush = self._mgr is not None and (
                self._since_flush >= self.flush_interval
                or time.monotonic() - self._last_flush > self.flush_interval_s
            )
        if want_flush:
            self.flush()

    def span(self, name: str, **attrs: Any) -> "_Span":
        """Context manager *and* decorator timing one phase."""
        return _Span(self, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant (point-in-time) event.  Like span exits, it
        names the enclosing span (``parent``) so the structured log keeps
        its nesting context — and links to it by id (``trace_id`` +
        ``parent_span_id``), falling back to the ambient context when no
        span is open on this thread."""
        stack = self._stack()
        trace_id = parent_sid = None
        if stack:
            pname, parent_sid, trace_id = stack[-1]
            attrs = {**attrs, "parent": pname}
        else:
            ctx = getattr(self._local, "ctx", None)
            if ctx is not None:
                trace_id, parent_sid = ctx.trace_id, ctx.span_id
        self.record(name, "i", time.time() * 1e6, attrs=attrs or None,
                    trace_id=trace_id, parent_span_id=parent_sid)

    # -- reading / shipping ------------------------------------------------

    def snapshot(self) -> list[dict[str, Any]]:
        """Copy of the buffered events, oldest first."""
        with self._lock:
            return [dict(e) for e in self._events]

    def clear(self) -> None:
        """Empty the buffer AND detach any configured blackboard manager.

        clear() marks a run boundary (a reused worker bootstrapping a new
        cluster): keeping the old manager would let the next recorded
        event auto-flush the new run's spans onto the PREVIOUS cluster's
        blackboard, clobbering its shipped trace.  The new run must
        :meth:`configure` its own manager.
        """
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._since_flush = 0
            self._mgr = None

    def kv_key(self) -> str:
        return f"{TRACE_KV_PREFIX}{self.node}:{os.getpid()}"

    def flush(self, mgr: Any = None) -> bool:
        """Publish the buffer snapshot to the kv blackboard.

        Returns True on success.  Never raises — observability must not
        kill training (same contract as ``MetricsReporter.publish``).
        """
        mgr = mgr if mgr is not None else self._mgr
        if mgr is None or not self.enabled:
            return False
        payload = {
            "node": self.node,
            "pid": os.getpid(),
            "events": self.snapshot(),
            "dropped": self.dropped,
            "flushed_at": time.time(),
        }
        try:
            mgr.set(self.kv_key(), payload)
        except Exception as e:
            logger.warning("trace flush failed: %s", e)
            with self._lock:
                # throttle retries to the normal flush cadence — a dead
                # manager must not add one failing RPC per recorded event
                self._since_flush = 0
                self._last_flush = time.monotonic()
            return False
        with self._lock:
            self._since_flush = 0
            self._last_flush = time.monotonic()
        return True


class _Span:
    """One timed phase; context manager and decorator in one object.

    Decorator use creates a fresh timing per call (the instance holds only
    the static name/attrs; per-entry state lives on an internal stack, so
    reentrant/nested use of the same instance is safe).
    """

    __slots__ = ("_tracer", "name", "attrs", "_starts")

    def __init__(self, tracer: Tracer, name: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._starts: list[tuple[float, float]] = []

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        if stack:
            # nested: inherit the trace, parent by span id
            _, parent_sid, trace_id = stack[-1]
        else:
            ctx = getattr(self._tracer._local, "ctx", None)
            if ctx is not None:  # propagated from another thread/process
                trace_id, parent_sid = ctx.trace_id, ctx.span_id
            else:  # a root span starts its own trace
                trace_id, parent_sid = new_trace_id(), None
        span_id = new_span_id()
        self._starts.append((time.time(), time.perf_counter(), span_id,
                             trace_id, parent_sid))
        stack.append((self.name, span_id, trace_id))
        return self

    def context(self) -> TraceContext | None:
        """This (open) span's context, for explicit cross-thread handoff."""
        if not self._starts:
            return None
        _, _, span_id, trace_id, _ = self._starts[-1]
        return TraceContext(trace_id, span_id)

    def __exit__(self, exc_type, exc, tb) -> None:
        wall_t0, perf_t0, span_id, trace_id, parent_sid = self._starts.pop()
        dur_us = (time.perf_counter() - perf_t0) * 1e6
        stack = self._tracer._stack()
        if stack and stack[-1][1] == span_id:
            stack.pop()
        attrs = dict(self.attrs) if self.attrs else {}
        if stack:
            attrs["parent"] = stack[-1][0]
        if exc_type is not None:
            attrs["error"] = f"{exc_type.__name__}: {exc}"[:300]
        self._tracer.record(self.name, "X", wall_t0 * 1e6, dur_us,
                            attrs or None, trace_id=trace_id,
                            span_id=span_id, parent_span_id=parent_sid)

    def set(self, **attrs: Any) -> "_Span":
        """Attach attrs discovered mid-span (e.g. an outcome)."""
        self.attrs = {**self.attrs, **attrs}
        return self

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Span(self._tracer, self.name, self.attrs):
                return fn(*args, **kwargs)

        return wrapped


# ---------------------------------------------------------------------------
# Request-scoped tracing: span trees + tail-based sampling
# ---------------------------------------------------------------------------

_DEFAULT_SAMPLE = 0.01
_DEFAULT_STORE_CAPACITY = 256


#: fraction of requests ARMED for span capture when nothing else decides
#: (``TFOS_TRACE_ARM``).  Arming every request costs real throughput on
#: a GIL-bound server (A/B-measured at 8-12% of the online closed loop
#: on this 2-core box — and most of that is second-order: the per-request
#: perturbation shifts the coalescing equilibrium itself), so the
#: uniform population is head-sampled Dapper-style; an explicit inbound
#: context (``traceparent`` header / ``submit(trace_ctx=...)``) always
#: arms (the caller asked), and sheds/invalid requests are always
#: captured on their cold paths regardless of arming.
_DEFAULT_ARM = 0.05

# env parses memoized on the raw string: these run per request on the
# serving hot path, where strip/lower/float per call is measurable —
# toggling the env var (the bench A/B does) still takes effect at once
_REQ_ENABLED_CACHE: tuple[str, bool] = ("\x00", True)
_SAMPLE_CACHE: tuple[str, float] = ("\x00", _DEFAULT_SAMPLE)
_ARM_CACHE: tuple[str, float] = ("\x00", _DEFAULT_ARM)


def requests_enabled() -> bool:
    """Per-request span trees on?  ``TFOS_TRACE_REQUESTS=0`` opts out
    (re-read per request so the bench's tracing-overhead A/B can toggle
    it live, like ``flight.enabled``)."""
    global _REQ_ENABLED_CACHE
    raw = os.environ.get("TFOS_TRACE_REQUESTS", "1")
    cached = _REQ_ENABLED_CACHE
    if raw == cached[0]:
        return cached[1]
    val = raw.strip().lower() not in ("0", "false", "no")
    _REQ_ENABLED_CACHE = (raw, val)
    return val


def sample_rate() -> float:
    """Uniform keep fraction for unremarkable requests
    (``TFOS_TRACE_SAMPLE``, default 0.01, clamped to [0, 1])."""
    global _SAMPLE_CACHE
    raw = os.environ.get("TFOS_TRACE_SAMPLE", "")
    cached = _SAMPLE_CACHE
    if raw == cached[0]:
        return cached[1]
    try:
        v = max(0.0, min(1.0, float(raw))) if raw else _DEFAULT_SAMPLE
    except ValueError:
        v = _DEFAULT_SAMPLE
    _SAMPLE_CACHE = (raw, v)
    return v


def arm_rate() -> float:
    """Fraction of (otherwise-undecided) requests armed for span capture
    (``TFOS_TRACE_ARM``, default 0.05, clamped to [0, 1]).  Requests
    carrying an explicit inbound context always arm; sheds and invalid
    requests are captured regardless — this rate governs only the
    uniform population, bounding tracing's hot-path cost (set 1.0 to
    capture every request where the throughput budget allows)."""
    global _ARM_CACHE
    raw = os.environ.get("TFOS_TRACE_ARM", "")
    cached = _ARM_CACHE
    if raw == cached[0]:
        return cached[1]
    try:
        v = max(0.0, min(1.0, float(raw))) if raw else _DEFAULT_ARM
    except ValueError:
        v = _DEFAULT_ARM
    _ARM_CACHE = (raw, v)
    return v


def sample_roll(rate: float | None = None) -> bool:
    """One uniform-sample keep/drop roll (shared PRNG — cheap)."""
    s = sample_rate() if rate is None else rate
    return s >= 1.0 or (s > 0.0 and _ID_RNG.random() < s)


def arm_roll() -> bool:
    """One head-armed capture roll at :func:`arm_rate` — the decision a
    request entry point makes when no inbound context forces capture."""
    return sample_roll(arm_rate())


class RequestTrace:
    """Span-tree collector for ONE request, safe to hand across threads.

    Unlike :class:`Tracer` spans (thread-local nesting, shared ring), a
    request's spans are recorded by *different* threads — the submitting
    caller, the coalescer, the compute thread — each holding the request
    object.  They :meth:`add` completed child spans under the request's
    root; :meth:`finish` closes the root exactly once (first caller wins
    — a compute-thread reply racing a caller-side timeout must not commit
    the tree twice), after which the tree is immutable and ready for the
    :class:`TraceStore` retention decision.

    ``ctx`` is the inbound parent (e.g. a parsed ``traceparent``): the
    request joins that trace and the root span's ``parent_span_id`` names
    the remote caller's span; without it the request starts a new trace.

    ``trace_id`` forces the identity for a trace built *retroactively*
    (the hot path records raw fields and only constructs the tree for
    the retained minority — the id was shared with batch-mates long
    before retention was decided); ``started=(wall, perf)`` back-dates
    the root to when the request actually entered.
    """

    __slots__ = ("ctx", "parent_span_id", "name", "node", "attrs", "status",
                 "duration_s", "_t0_wall", "_t0_perf", "_spans", "_lock",
                 "_done")

    def __init__(self, name: str, ctx: TraceContext | None = None,
                 node: str | None = None, trace_id: str | None = None,
                 started: tuple[float, float] | None = None,
                 **attrs: Any):
        self.name = name
        self.node = node or _TRACER.node
        self.ctx = TraceContext(
            ctx.trace_id if ctx is not None else (trace_id
                                                  or new_trace_id()),
            new_span_id())
        self.parent_span_id = ctx.span_id if ctx is not None else None
        self.attrs: dict[str, Any] = dict(attrs)
        self.status: str | None = None
        self.duration_s: float | None = None
        if started is not None:
            self._t0_wall, self._t0_perf = started
        else:
            self._t0_wall = time.time()
            self._t0_perf = time.perf_counter()
        self._spans: list[dict[str, Any]] = []
        self._lock = threading.Lock()
        self._done = False

    def add(self, name: str, dur_s: float, *,
            end_wall: float | None = None,
            parent_span_id: str | None = None, **attrs: Any) -> bool | None:
        """Append one completed child span (``dur_s`` seconds, ending at
        ``end_wall`` or now); returns True, or None after :meth:`finish`
        (a late add — e.g. a reply landing after a caller-side timeout
        committed the tree — is dropped, not an error).

        Hot-path discipline: only a small tuple is stored here — full
        span dicts (and child span ids) materialize in :meth:`to_doc`,
        which runs only for the retained minority.  Most requests drop
        their whole tree at commit and never pay the dict build.
        """
        end = time.time() if end_wall is None else end_wall
        rec = (name, end, dur_s, threading.get_ident() & 0xFFFFFFFF,
               parent_span_id, attrs or None)
        with self._lock:
            if self._done:
                return None
            self._spans.append(rec)
        return True

    def add_lazy(self, provider: Callable[[], Any]) -> bool | None:
        """Register a deferred span source: ``provider()`` runs only at
        :meth:`to_doc` — i.e. only for the retained minority — and
        returns an iterable of ``(name, end_wall, dur_s, tid,
        parent_span_id, attrs)`` tuples.

        This is how per-BATCH state (one record shared by every request
        that rode the batch) expands into per-request spans without the
        hot path paying per-request×per-span dict work: the coalescer
        registers one closure per request, O(1), and the expansion cost
        exists only for traces that survive tail sampling.  A provider
        that raises contributes nothing (observability never throws).
        """
        with self._lock:
            if self._done:
                return None
            self._spans.append(provider)
        return True

    def set(self, **attrs: Any) -> "RequestTrace":
        """Attach attrs to the root span (outcome, latency, batch id)."""
        with self._lock:
            if not self._done:
                self.attrs.update(attrs)
        return self

    def finish(self, status: str = "ok", **attrs: Any) -> bool:
        """Close the root span (merging any final ``attrs`` — outcome,
        latency — under the same lock); True for the (single) caller that
        won.

        The loser of a finish race (reply vs timeout, error vs stop) gets
        False and must NOT commit the trace — whoever finishes owns the
        retention decision.
        """
        with self._lock:
            if self._done:
                return False
            self._done = True
            self.status = status
            if attrs:
                self.attrs.update(attrs)
            self.duration_s = time.perf_counter() - self._t0_perf
        return True

    def to_doc(self) -> dict[str, Any]:
        """Materialize the JSON-able span tree (the ``/debug/requests``
        entry shape).  Child span ids are minted HERE (nothing references
        them before retention), so call once and reuse the doc — the
        :class:`TraceStore` stores exactly one materialization."""
        with self._lock:
            recs = list(self._spans)
            status, duration_s = self.status, self.duration_s
            attrs = dict(self.attrs)
        trace_id, root_sid = self.ctx.trace_id, self.ctx.span_id
        pid = os.getpid()
        spans: list[dict[str, Any]] = []
        flat: list[tuple] = []
        for rec in recs:
            if callable(rec):  # deferred provider (add_lazy)
                try:
                    flat.extend(rec())
                except Exception:  # pragma: no cover - never raises out
                    continue
            else:
                flat.append(rec)
        for name, end, dur_s, tid, parent, a in flat:
            ev: dict[str, Any] = {
                "name": name,
                "ph": "X",
                "ts": (end - dur_s) * 1e6,
                "dur": dur_s * 1e6,
                "node": self.node,
                "pid": pid,
                "tid": int(tid or 0),
                "trace_id": trace_id,
                "span_id": new_span_id(),
                "parent_span_id": parent or root_sid,
            }
            if a:
                ev["attrs"] = dict(a)
            spans.append(ev)
        if status is not None:
            attrs["status"] = status
            root: dict[str, Any] = {
                "name": self.name,
                "ph": "X",
                "ts": self._t0_wall * 1e6,
                "dur": (duration_s or 0.0) * 1e6,
                "node": self.node,
                "pid": pid,
                "tid": threading.get_ident() & 0xFFFFFFFF,
                "trace_id": trace_id,
                "span_id": root_sid,
                "attrs": attrs,
            }
            if self.parent_span_id:
                root["parent_span_id"] = self.parent_span_id
            spans.append(root)
        return {
            "trace_id": trace_id,
            "root_span_id": root_sid,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "status": status,
            "ts": self._t0_wall,
            "duration_ms": (round(duration_s * 1000, 3)
                            if duration_s is not None else None),
            "spans": spans,
        }


class TraceStore:
    """Bounded ring of *retained* request traces (tail-based sampling).

    Every finished :class:`RequestTrace` is offered via :meth:`commit`
    with the caller's retention reason (``slo_breach`` / ``shed`` /
    ``error`` / ``timeout``) or None; unremarkable requests additionally
    get one uniform-sample roll (:func:`sample_rate`).  Whatever is not
    retained is DROPPED — whole tree, at commit, no partial residue — so
    the store's memory is bounded by ``capacity`` complete trees of
    interesting requests, not by traffic volume.  Counters
    (``trace_requests_total`` / ``trace_retained_total``) ride the
    registry so retention itself is observable.
    """

    def __init__(self, capacity: int | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(
                    "TFOS_TRACE_REQUESTS_CAPACITY",
                    _DEFAULT_STORE_CAPACITY))
            except ValueError:
                capacity = _DEFAULT_STORE_CAPACITY
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._retained: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.committed = 0
        self.retained_total = 0
        self._counters = None  # lazy: avoid registry work at import

    def _instruments(self) -> tuple:
        if self._counters is None:
            from tensorflowonspark_torch.obs import registry

            self._counters = (
                registry.counter(
                    "trace_requests_total",
                    "request traces offered to the tail-sampling store"),
                registry.counter(
                    "trace_retained_total",
                    "request traces retained (SLO breach / shed / error / "
                    "uniform sample)"))
        return self._counters

    def _count(self, retained: bool) -> None:
        offered, kept = self._instruments()
        offered.inc()
        if retained:
            kept.inc()

    def commit(self, rt: RequestTrace, *, retain: str | None = None,
               sample: float | None = None) -> str | None:
        """Offer a finished trace; returns the retention reason or None.

        ``retain`` is the tail signal (SLO breach, shed, error, timeout);
        with none, a uniform roll at ``sample`` (default
        :func:`sample_rate`) may still keep it as ``"sampled"``.
        """
        reason = retain
        if reason is None and sample_roll(sample):
            reason = "sampled"
        with self._lock:
            self.committed += 1
            if reason:
                self.retained_total += 1
                doc = rt.to_doc()
                doc["retained"] = reason
                self._retained.append(doc)
        try:
            self._count(bool(reason))
        except Exception:  # pragma: no cover - observability never raises
            pass
        return reason

    def note_dropped(self, n: int = 1) -> None:
        """Count ``n`` requests whose traces were dropped WITHOUT being
        materialized — the hot path's batched accounting (one call per
        coalesced batch, not per request)."""
        if n <= 0:
            return
        with self._lock:
            self.committed += n
        try:
            self._instruments()[0].inc(n)
        except Exception:  # pragma: no cover - observability never raises
            pass

    def recent(self, limit: int = 50) -> list[dict[str, Any]]:
        """Retained traces, slowest-first (the debugging order: the
        breach you are hunting is at the top)."""
        with self._lock:
            docs = list(self._retained)
        docs.sort(key=lambda d: -(d.get("duration_ms") or 0.0))
        return docs[:limit]

    def events(self) -> list[dict[str, Any]]:
        """Every retained trace's spans as flat tracer-shaped events —
        what ``TFCluster.dump_trace`` merges into the Chrome timeline."""
        with self._lock:
            docs = list(self._retained)
        out: list[dict[str, Any]] = []
        for doc in docs:
            out.extend(dict(ev) for ev in doc.get("spans", ()))
        return out

    def to_doc(self, limit: int = 50) -> dict[str, Any]:
        """The ``/debug/requests`` body."""
        with self._lock:
            committed, retained = self.committed, self.retained_total
        return {
            "capacity": self.capacity,
            "committed": committed,
            "retained_total": retained,
            "dropped_total": committed - retained,
            "sample_rate": sample_rate(),
            "retained": self.recent(limit),
        }

    def clear(self) -> None:
        with self._lock:
            self._retained.clear()
            self.committed = 0
            self.retained_total = 0


def merge_request_docs(docs: list, limit: int = 50) -> dict[str, Any]:
    """Merge several trace stores' ``/debug/requests`` documents into one,
    joining retained entries that share a ``trace_id`` into a single tree.

    This is how one request renders as ONE span tree across processes:
    the serving-mesh router propagates its context over the router→replica
    hop as a ``traceparent`` header, so the replica's retained
    ``online.request`` tree carries the router's trace id and its root
    names the router's span as parent — concatenating the two entries'
    spans yields the full tree.  The merged entry keeps the
    upstream-most member's identity/latency (the one whose
    ``parent_span_id`` is not supplied by any other member — for a
    router+replica pair, the router's, which covers the whole hop) and
    lists the contributing ``nodes``.  Entries retained by only one side
    (e.g. a replica-side SLO breach the router sampled away) pass through
    unmerged — a partial view beats none.
    """
    committed = retained_total = dropped = 0
    by_tid: dict[str, list[dict]] = {}
    stores = 0
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        stores += 1
        committed += int(doc.get("committed") or 0)
        retained_total += int(doc.get("retained_total") or 0)
        dropped += int(doc.get("dropped_total") or 0)
        for entry in doc.get("retained") or ():
            tid = entry.get("trace_id") if isinstance(entry, dict) else None
            if not tid:
                continue
            group = by_tid.setdefault(tid, [])
            # two docs can carry the SAME materialized tree (co-resident
            # stores, a store scraped twice): the root span id identifies
            # it — merge distinct trees, don't duplicate one
            if any(e.get("root_span_id") == entry.get("root_span_id")
                   for e in group):
                continue
            group.append(entry)
    merged: list[dict[str, Any]] = []
    for entries in by_tid.values():
        if len(entries) == 1:
            merged.append(entries[0])
            continue
        roots = {e.get("root_span_id") for e in entries}
        # upstream-most member first: its root's parent lies OUTSIDE the
        # group (the external caller, or nothing) — ties break oldest-first
        primary = min(entries, key=lambda e: (
            e.get("parent_span_id") in roots, e.get("ts") or 0.0))
        spans: list[dict] = []
        seen: set = set()
        for e in entries:
            for sp in e.get("spans") or ():
                sid = sp.get("span_id")
                if sid is None or sid not in seen:
                    seen.add(sid)
                    spans.append(sp)
        out = dict(primary)
        out["spans"] = spans
        out["merged_entries"] = len(entries)
        out["nodes"] = sorted({sp.get("node") for sp in spans
                               if sp.get("node")})
        merged.append(out)
    merged.sort(key=lambda d: -(d.get("duration_ms") or 0.0))
    return {
        "merged": True,
        "stores": stores,
        "committed": committed,
        "retained_total": retained_total,
        "dropped_total": dropped,
        "retained": merged[:limit],
    }


# -- module-level default tracer (one per process) --------------------------

_TRACER = Tracer()
_TRACE_STORE = TraceStore()


def get_tracer() -> Tracer:
    return _TRACER


def get_trace_store() -> TraceStore:
    """The process-default retained-request-trace store."""
    return _TRACE_STORE


def configure(node: str | None = None, mgr: Any = None,
              capacity: int | None = None) -> Tracer:
    """Configure the process-default tracer (identity / blackboard)."""
    return _TRACER.configure(node=node, mgr=mgr, capacity=capacity)


def span(name: str, **attrs: Any) -> _Span:
    return _TRACER.span(name, **attrs)


def event(name: str, **attrs: Any) -> None:
    _TRACER.event(name, **attrs)


def trace_context() -> TraceContext | None:
    """The calling thread's current context (innermost open span, else
    ambient) — what a hop across a queue/thread should carry."""
    return _TRACER.current_context()


def with_context(ctx: TraceContext | None) -> _AmbientContext:
    """Install a propagated context as this thread's ambient parent."""
    return _TRACER.with_context(ctx)


def flush(mgr: Any = None) -> bool:
    return _TRACER.flush(mgr)


def collect_blackboard(kv_snapshot: dict[str, Any]) -> dict[str, list[dict]]:
    """Extract shipped trace payloads from one node's kv snapshot.

    Returns ``{node_name: [events...]}`` — a node may have several
    publishing processes (bootstrap task, spawned trainer); their events
    merge under the node name, ordered by timestamp.
    """
    by_node: dict[str, list[dict]] = {}
    for key, payload in kv_snapshot.items():
        if not (isinstance(key, str) and key.startswith(TRACE_KV_PREFIX)):
            continue
        if not isinstance(payload, dict) or "events" not in payload:
            continue
        node = payload.get("node") or key[len(TRACE_KV_PREFIX):].rsplit(
            ":", 1)[0]
        by_node.setdefault(node, []).extend(payload["events"])
    for events in by_node.values():
        events.sort(key=lambda e: (e.get("ts", 0), e.get("name", "")))
    return by_node
