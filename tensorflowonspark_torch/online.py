"""Continuous-batching online serving tier: coalesced requests, multi-tenant
routing, admission control, per-tenant SLO metrics.

Reference anchor: ``tensorflowonspark_tpu/online.py`` (``OnlineServer``
``:533``, ``OnlineHTTPServer`` ``:1410``), copied with its imports
rewritten; ROADMAP Queue 1 item 7.  ``TFModel.transform`` assumes one
caller pushing large partitions; this tier serves many concurrent callers
with one row or a handful each, multiplexed over one set of captured
forwards (arXiv:1605.08695 §4).  Driver-less and single-process:

- **Coalesced request queue** (:class:`OnlineServer`): concurrent
  :meth:`~OnlineServer.submit` calls drain into the serving bucket ladder
  (``shapes.resolve_buckets`` / ``choose_bucket``, ``serving.pad_columns``)
  under a latency SLO: a batch flushes when the oldest request's deadline
  (``flush_ms``) arrives, when a full bucket's worth of rows is pending,
  or the moment the engine goes idle (holding a request while nothing
  computes buys no bigger batch, only latency).  One forward runs per
  coalesced batch and each caller gets its own rows back.  Assembly
  (coalesce, pad, ``serving.stager`` staging onto the device) runs on the
  coalescer thread while the previous batch computes, over a bounded
  staged queue (``TFOS_SERVING_PREFETCH`` deep).
- **The forward on the card**: each bucket of a tenant's model (a
  self-describing export's program, a zoo model's forward) is one CUDA
  graph (``serving.captured``, a ``parallel.train.CapturedForward``),
  captured in :meth:`~OnlineServer.add_tenant` when the tenant warms on
  load and replayed by the compute thread; a tenant's ``predict_fn`` runs
  as given, eagerly, as the reference runs it.  The coalescer thread
  stages a batch with a non-blocking copy on its current stream, and the
  compute thread copies it into the graph's static inputs and replays on
  its own: both are the device's default stream, so the replay starts
  after the staged copy ends.  The device-to-host copy of the outputs
  (``serving.to_host``, bf16 as f32), made before any other call can
  replay the graph over them, is the one sync a batch.  A bucket with no
  shapes at warm time is captured at its second sighting.
- **Multi-tenant routing**: each tenant names a model (export dir and
  forward), resolved through the per-process ``pipeline._MODEL_CACHE``;
  tenants sharing one model, bucket ladder and mappings coalesce into the
  SAME batches, drained round-robin so one tenant's backlog cannot
  monopolize a batch.
- **Admission control / load shedding**: each tenant's pending queue is
  byte-bounded; a request that would exceed the bound is shed with an
  explicit :class:`Rejected` (HTTP 429, ``Retry-After``), never dropped
  silently or left waiting.
- **Observability**: ``online_requests_total`` / ``online_rows_total`` /
  ``online_shed_total`` counters, the ``online_coalesce_size`` histogram,
  per-tenant latency histograms labeled ``tenant``, the ``"online"``
  flight plane (``wait``/``coalesce``/``pad``/``compute``/``reply``), the
  cost ledger's per-tenant charges, and the server and per-tenant state
  (with the last-window shed rate and the stable ``admission`` block a
  router reads) on ``/healthz``.
- **Request-scoped tracing**: every request carries a span tree
  (``admission``, ``queue``, ``coalesce``, ``forward``, ``reply``),
  stitched across the coalescer and compute threads; complete trees are
  retained for SLO breaches, sheds, errors and timeouts plus a uniform
  sample (``TFOS_TRACE_SAMPLE``), served on ``GET /debug/requests``, with
  their ids as exemplars on the latency histogram.  Capture arms at
  ``TFOS_TRACE_ARM`` (inbound ``traceparent`` always arms);
  ``TFOS_TRACE_REQUESTS=0`` turns it off.
- **Warm on load**: a tenant with known input shapes (a self-describing
  export's signature, ``warmup_example=``, or the zoo's example batch for
  ``model_name`` tenants) runs and captures every bucket in
  :meth:`~OnlineServer.add_tenant`, counted through
  ``serving.note_compile`` as warmed, so compiles equal signatures and the
  first real request pays no capture.

The HTTP front end (:class:`OnlineHTTPServer`) follows ``obs/httpd.py``:
stdlib ``ThreadingHTTPServer``, ``POST /v1/predict`` plus ``GET /metrics``
/ ``/healthz`` / ``/pipeline`` / ``/debug/requests``.  Not ported: the
serving mesh's router (``mesh.py``) and its shedding at the router.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue as _queue_mod
import threading
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from tensorflowonspark_torch.obs import journal as _journal
from tensorflowonspark_torch.obs import trace as _trace

logger = logging.getLogger(__name__)

# hot-path bindings: under a loaded closed loop every Python function
# call on the per-request path costs µs (measured — call overhead plus
# cache pressure dominate the tracing A/B), so the submit/compute loops
# inline these instead of calling through the trace module
_env_get = os.environ.get
_rng_random = _trace._ID_RNG.random
_TRACER = _trace.get_tracer()

# lazy trace identity: the hot path stamps only an atomic sequence
# number (`next` on a count() is one C call); the 32-hex trace id
# derives DETERMINISTICALLY from (process nonce, seq) at first use —
# materialization, batch-mate listing, failure paths — so two racing
# derivations compute the same id and the common dropped request never
# pays id minting at all.  Inbound-traceparent requests carry their
# caller's id instead and skip derivation.
_TRACE_SEQ = itertools.count(1)
_TRACE_NONCE = os.urandom(16)


def _trace_id_of(req: "_Request") -> str:
    tid = req.trace_id
    if tid is None:
        import hashlib

        tid = hashlib.blake2b(
            req.trace_seq.to_bytes(8, "little"), digest_size=16,
            key=_TRACE_NONCE).hexdigest()
        req.trace_id = tid  # racing derivations agree: benign
    return tid


#: settles the (rare) finish races — compute-thread reply vs caller
#: timeout vs stop/fail.  One module lock instead of a per-request
#: token object: claims happen only on retained/failed paths.
_CLAIM_LOCK = threading.Lock()

#: request-latency histogram bounds: SLO-grade resolution (the registry
#: default bottoms out at 1 ms — too coarse for sub-10ms online targets)
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, float("inf"))
#: coalesced-batch row-count histogram bounds (powers of two — bucket
#: ladders are built from them)
COALESCE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                    4096, float("inf"))

#: default per-tenant pending byte bound, MB (``max_pending_mb`` overrides
#: per tenant) — the ``_ByteBoundedQueue`` convention: back-pressure on the
#: unbounded term, not a hard memory cap
DEFAULT_MAX_PENDING_MB = 64.0
#: default flush deadline, ms: the latency the coalescer may spend waiting
#: for batch-mates (the queueing half of the SLO; compute rides on top)
DEFAULT_FLUSH_MS = 10.0
#: default per-tenant SLO when ``add_tenant(slo_ms=...)`` is not given:
#: this multiple of the tenant's flush deadline (queueing budget × this
#: headroom for compute + scatter).  The SLO drives tail-based trace
#: retention: a request over it keeps its complete span tree.
DEFAULT_SLO_FLUSH_FACTOR = 10.0
#: tumbling-interval length of the per-tenant shed-rate window surfaced
#: on ``/healthz`` (the window covers the current + previous interval,
#: so 30s intervals report over the last 30-60s)
SHED_WINDOW_INTERVAL_S = 30.0
#: batch-mate trace ids listed per coalesce span before truncation (the
#: full member count always rides ``batch_requests``)
_MAX_BATCH_MATES = 16

_STOP = object()


class Rejected(RuntimeError):
    """Request shed by admission control — HTTP 429 semantics.

    The tenant's pending queue is over its byte bound; the caller should
    back off ``retry_after_s`` and retry.  Shedding is *loud by design*:
    every shed increments ``online_shed_total`` (and the tenant's own
    counter) and the caller always gets this exception — there is no path
    on which a request is silently dropped or left waiting forever.
    """

    def __init__(self, message: str, retry_after_s: float = 0.05):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def _canon(a: np.ndarray) -> np.ndarray:
    """JSON-sourced arrays → the canonical dtypes (f64→f32, i64→i32) so a
    request parsed from HTTP JSON hits the same signature (the same
    captured graph) as a warmed / numpy-native one.  Tenants with known
    input specs cast to the spec dtype instead and never reach this."""
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


class _Request:
    """One caller's in-flight request: columns in, sliced results out.

    Trace state is RAW FIELDS, not a span tree: ``trace_id`` (shared with
    batch-mates and echoed to ``traceparent`` callers, None when
    ``TFOS_TRACE_REQUESTS=0``), the inbound context, the admission
    window, and the shared :class:`_BatchTrace` the request rode.  The
    :class:`~tensorflowonspark_torch.obs.trace.RequestTrace` tree
    materializes RETROACTIVELY (:func:`_build_trace`) only for the
    retained minority — an A/B measured eager per-request span objects at
    10-20% of closed-loop throughput on this class of box; raw slot
    writes are what the hot path can afford.  :meth:`claim_trace`
    settles the finish race (compute-thread reply vs caller-side
    timeout): exactly one side claims and commits.
    """

    __slots__ = ("tenant", "cols", "rows", "nbytes", "enqueued", "deadline",
                 "event", "result", "error", "trace_id", "inbound",
                 "t0_perf", "trace_seq", "trace_claimed", "admission_dur",
                 "admission_attrs", "batch")

    def __init__(self, tenant: "_Tenant", cols: dict, rows: int,
                 nbytes: int, deadline: float,
                 enqueued: float | None = None):
        self.tenant = tenant
        self.cols = cols
        self.rows = rows
        self.nbytes = nbytes
        self.enqueued = (time.perf_counter() if enqueued is None
                         else enqueued)
        self.deadline = deadline
        self.event = threading.Event()
        self.result: dict | None = None
        self.error: BaseException | None = None
        self.trace_id: str | None = None
        self.inbound = None
        #: non-zero ⇔ the request is traced (the hot-path marker)
        self.t0_perf = 0.0
        self.trace_seq = 0
        self.trace_claimed = False
        self.admission_dur: float | None = None
        self.admission_attrs: dict | None = None
        self.batch: "_BatchTrace | None" = None

    def claim_trace(self) -> bool:
        """Claim the (rare) right to finish+commit this request's trace —
        arbitration between a compute-thread reply, a caller-side
        timeout, and stop/fail, under one module lock (claims only
        happen on retained/failed paths, never per request)."""
        if not self.t0_perf:
            return False
        with _CLAIM_LOCK:
            if self.trace_claimed:
                return False
            self.trace_claimed = True
            return True

    def fail(self, err: BaseException) -> None:
        self.error = err
        if self.claim_trace():
            status = "shed" if isinstance(err, Rejected) else "error"
            rt = _build_trace(self)
            rt.finish(status=status,
                      error=f"{type(err).__name__}: {err}"[:300])
            # failures are always tail-retained: they are exactly the
            # requests an operator will come asking about
            _trace.get_trace_store().commit(rt, retain=status)
        self.event.set()


def _build_trace(req: _Request) -> "_trace.RequestTrace":
    """Materialize a request's span tree from its raw fields — called
    only on the retained path (tail signal or sample win), never per
    request on the hot path.  The wall-clock anchor derives from the
    perf timestamps (one time.time here instead of one per request)."""
    t0_wall = time.time() - (time.perf_counter() - req.t0_perf)
    rt = _trace.RequestTrace(
        "online.request", ctx=req.inbound, trace_id=_trace_id_of(req),
        started=(t0_wall, req.t0_perf), tenant=req.tenant.name)
    if req.admission_dur is not None:
        rt.add("admission", req.admission_dur,
               end_wall=t0_wall + req.admission_dur,
               **(req.admission_attrs
                  or {"outcome": "admitted", "rows": req.rows,
                      "request_bytes": req.nbytes}))
    bt = req.batch
    if bt is not None:
        rt.add_lazy(lambda bt=bt, tid=req.trace_id,
                    enq=req.enqueued: bt.spans_for(tid, enq))
    return rt


class _ShedWindow:
    """Tumbling two-interval offered/shed window — the ``/healthz``
    shed-*rate* view (admission pressure NOW, not the lifetime counter).

    Constant memory: the current and previous ``interval_s`` buckets;
    :meth:`snapshot` reports over both, so the window covers the last
    1-2 intervals.  Callers hold the server lock, so no lock here.
    """

    __slots__ = ("interval_s", "_idx", "_cur", "_prev")

    def __init__(self, interval_s: float = SHED_WINDOW_INTERVAL_S):
        self.interval_s = float(interval_s)
        self._idx = 0
        self._cur = [0, 0]  # offered, shed
        self._prev = [0, 0]

    def _roll(self, now: float) -> None:
        idx = int(now / self.interval_s)
        if idx != self._idx:
            self._prev = self._cur if idx == self._idx + 1 else [0, 0]
            self._cur = [0, 0]
            self._idx = idx

    def note(self, shed: bool, now: float | None = None) -> None:
        self._roll(time.time() if now is None else now)
        self._cur[0] += 1
        if shed:
            self._cur[1] += 1

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        now = time.time() if now is None else now
        self._roll(now)
        offered = self._prev[0] + self._cur[0]
        shed = self._prev[1] + self._cur[1]
        covered = self.interval_s + (now % self.interval_s)
        return {"window_s": round(covered, 1),
                "offered": offered,
                "shed": shed,
                "shed_rate": round(shed / offered, 4) if offered else 0.0}


#: public name for reuse by the other admission-controlled tiers (the
#: generative decode engine surfaces the same tumbling shed-rate view on
#: ITS /healthz admission block)
ShedWindow = _ShedWindow


class _Tenant:
    """Per-tenant routing + admission state (pending queue lives here so
    one tenant's backlog is *visible* and boundable independently)."""

    def __init__(self, name: str, group: "_ModelGroup", in_map: dict,
                 flush_s: float, max_pending_bytes: int,
                 slo_s: float | None = None):
        from tensorflowonspark_torch import obs

        self.name = name
        self.group = group
        self.in_map = dict(in_map)
        self.flush_s = float(flush_s)
        self.max_pending_bytes = int(max_pending_bytes)
        #: latency over this retains the request's complete span tree
        #: (tail-based sampling) — the per-tenant SLO
        self.slo_s = (float(slo_s) if slo_s is not None
                      else self.flush_s * DEFAULT_SLO_FLUSH_FACTOR)
        self.pending: collections.deque[_Request] = collections.deque()
        self.pending_rows = 0
        self.pending_bytes = 0
        self.shed_window = _ShedWindow()
        # instrument handles cached here: submit/reply are the hot path
        # and must not pay a registry lookup per request (flight-recorder
        # rule).  The tenant is a first-class Prometheus LABEL (the
        # round-11 name-mangled ``online_*_<tenant>`` aliases were
        # dual-published for exactly one round and are now gone).
        # labeled families are DISJOINT from the unlabeled server-wide
        # grand totals (online_requests_total / online_shed_total): mixing
        # a labelless series into a labeled family would double-count
        # every request under sum() — the aggregation alerting uses
        tenant_label = {"tenant": name}
        self.requests_total = obs.counter(
            "online_tenant_requests_total",
            "online requests admitted, per tenant", labels=tenant_label)
        self.shed_total = obs.counter(
            "online_tenant_shed_total",
            "online requests shed by admission control, per tenant",
            labels=tenant_label)
        self.latency = obs.histogram(
            "online_request_seconds",
            "submit→reply latency (p50/p99 from the buckets; slow "
            "observations carry retained-trace exemplars)",
            buckets=LATENCY_BUCKETS, labels=tenant_label)

    def note_admitted(self) -> None:
        self.requests_total.inc()
        self.shed_window.note(shed=False)

    def note_shed(self) -> None:
        self.shed_total.inc()
        self.shed_window.note(shed=True)

    def observe_latency(self, seconds: float,
                        trace_id: str | None = None) -> None:
        """Record one reply latency; a retained trace's id rides the
        labeled histogram as the bucket's exemplar."""
        self.latency.observe(
            seconds,
            exemplar={"trace_id": trace_id} if trace_id else None)

    def evict_metrics(self) -> None:
        """Drop this tenant's labeled series with the tenant (bounded
        cardinality: a removed tenant frees every slot it pinned)."""
        from tensorflowonspark_torch import obs

        reg = obs.get_registry()
        label = {"tenant": self.name}
        reg.remove("online_tenant_requests_total", label)
        reg.remove("online_tenant_shed_total", label)
        reg.remove("online_request_seconds", label)

    def quantile_ms(self, q: float) -> float | None:
        from tensorflowonspark_torch.obs import anomaly

        h = self.latency.export()
        if not h["count"]:
            return None
        v = anomaly.hist_quantile(h["buckets"], q)
        return None if v is None else round(v * 1000, 3)


class _BatchTrace:
    """ONE record per coalesced batch, shared by every member request's
    trace — the batch-level half of request tracing at batch-level cost.

    The coalescer fills the drain/assembly fields and registers one
    O(1) closure per member (``RequestTrace.add_lazy``); the compute
    thread fills the forward/reply windows.  Only a RETAINED trace ever
    expands the record into its ``queue``/``coalesce``/``forward``/
    ``reply`` spans (mates = the member ids minus its own) — the hot
    path never pays per-request×per-span dict work, which an A/B
    measured at ~20% of closed-loop throughput when done eagerly.
    Fields a failed batch never filled simply produce no span.
    """

    __slots__ = ("batch_id", "bucket", "rows", "flush", "pad_waste",
                 "members", "n_requests", "drained_wall",
                 "drained_perf", "assembled_wall", "assembled_perf",
                 "coalescer_tid", "forward_dur", "forward_end_wall",
                 "compute_tid", "reply_dur", "reply_end_wall")

    def __init__(self, batch_id: int):
        self.batch_id = batch_id
        self.bucket = self.rows = self.n_requests = 0
        self.flush = ""
        self.pad_waste = 0.0
        #: the batch's requests (aliased, not copied) — member trace ids
        #: and tenant names derive lazily at expansion
        self.members: list = []
        self.drained_wall = self.drained_perf = 0.0
        self.assembled_wall = self.assembled_perf = 0.0
        self.coalescer_tid = self.compute_tid = 0
        self.forward_dur: float | None = None
        self.forward_end_wall = 0.0
        self.reply_dur: float | None = None
        self.reply_end_wall = 0.0

    def spans_for(self, trace_id: str, enqueued_perf: float) -> list:
        """Expand into one member's span tuples (``add_lazy`` contract:
        ``(name, end_wall, dur_s, tid, parent_span_id, attrs)``)."""
        out = []
        if self.drained_perf:
            out.append(("queue", self.drained_wall,
                        max(0.0, self.drained_perf - enqueued_perf),
                        self.coalescer_tid, None,
                        {"batch_id": self.batch_id}))
        if self.assembled_perf:
            mates = [m for m in (_trace_id_of(r) for r in self.members
                                 if r.t0_perf) if m != trace_id]
            truncated = len(mates) > _MAX_BATCH_MATES
            out.append((
                "coalesce", self.assembled_wall,
                max(0.0, self.assembled_perf - self.drained_perf),
                self.coalescer_tid, None,
                {"batch_id": self.batch_id, "bucket": self.bucket,
                 "rows": self.rows, "flush": self.flush,
                 "pad_waste": self.pad_waste,
                 "batch_requests": self.n_requests,
                 "batch_mates": mates[:_MAX_BATCH_MATES],
                 **({"batch_mates_total": len(mates)} if truncated
                    else {}),
                 "tenants": sorted({r.tenant.name for r in self.members})}))
        if self.forward_dur is not None:
            out.append(("forward", self.forward_end_wall, self.forward_dur,
                        self.compute_tid, None,
                        {"batch_id": self.batch_id, "bucket": self.bucket}))
        if self.reply_dur is not None:
            out.append(("reply", self.reply_end_wall, self.reply_dur,
                        self.compute_tid, None,
                        {"batch_id": self.batch_id}))
        return out


class _ModelGroup:
    """One loaded forward + bucket geometry; the unit of coalescing.

    Tenants whose (model-cache key, bucket ladder, input mapping) agree
    share a group, so their requests ride the same coalesced batches —
    that is what makes the tier multi-tenant rather than N independent
    servers in one process.  ``forward`` is the model's captured forward
    (``serving.captured``: one CUDA graph a bucket on the card, a
    ``predict_fn`` eager) and
    ``stage`` the stager onto the model's device.
    """

    def __init__(self, key: tuple, forward, stage: Callable,
                 cache_key: Any, buckets: tuple[int, ...], out_map,
                 specs: dict | None):
        self.key = key
        self.forward = forward
        self.stage = stage
        self.cache_key = cache_key
        self.buckets = tuple(buckets)
        self.batch_cap = int(buckets[-1])
        self.out_map = out_map
        self.specs = specs
        self.tenants: list[_Tenant] = []
        self.rr = 0  # round-robin drain start index

    def pending_rows(self) -> int:
        return sum(t.pending_rows for t in self.tenants)

    def oldest_deadline(self) -> float | None:
        heads = [t.pending[0].deadline for t in self.tenants if t.pending]
        return min(heads) if heads else None


class OnlineServer:
    """Driver-less continuous-batching inference server (see module doc).

    Lifecycle: :meth:`add_tenant` (loads + optionally warms the model) →
    :meth:`start` → concurrent :meth:`submit` from any threads →
    :meth:`stop` (fails every still-pending request loudly; nothing is
    dropped silently and no caller is left waiting).
    """

    def __init__(self):
        from tensorflowonspark_torch import obs, serving

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants: dict[str, _Tenant] = {}
        self._groups: dict[tuple, _ModelGroup] = {}
        depth = serving.prefetch_depth()
        self._depth = depth if depth > 0 else 0
        # staged coalesced batches: bounded so the coalescer backpressures
        # into the pending queues (and from there into admission control)
        # when the forward falls behind
        self._staged: _queue_mod.Queue = _queue_mod.Queue(
            maxsize=max(1, self._depth))
        self._coalescer: threading.Thread | None = None
        self._computer: threading.Thread | None = None
        self._started = False
        self._started_ts = 0.0
        self._stopped = False
        # batches staged or computing right now: while 0 the engine is
        # IDLE and the coalescer flushes any pending work immediately —
        # the continuous-batching discipline (holding a request while the
        # engine idles buys no bigger batch, only latency; under load the
        # requests that arrive during the in-flight batch coalesce on
        # their own).  ``flush_ms`` therefore only delays requests while
        # a batch is already in flight.
        self._inflight = 0
        #: monotonically increasing coalesced-batch id — what a request's
        #: trace cites to name the batch it rode (batch-level causality)
        self._batch_seq = 0
        self._requests_total = obs.counter(
            "online_requests_total", "online requests admitted")
        self._rows_total = obs.counter(
            "online_rows_total", "rows admitted to the online tier")
        self._shed_total = obs.counter(
            "online_shed_total",
            "online requests shed by admission control (every one of "
            "these was an explicit 429-style rejection)")
        self._errors_total = obs.counter(
            "online_errors_total",
            "coalesced batches whose forward raised (every waiting "
            "caller got the error)")
        self._coalesce_size = obs.histogram(
            "online_coalesce_size",
            "real rows per coalesced forward batch (pre-padding)",
            buckets=COALESCE_BUCKETS)
        self._pending_rows_g = obs.gauge(
            "online_pending_rows", "rows waiting in online pending queues")
        self._pending_bytes_g = obs.gauge(
            "online_pending_bytes",
            "payload bytes waiting in online pending queues "
            "(admission-control accounting)")

    # -- configuration -------------------------------------------------------

    def add_tenant(self, name: str, *, export_dir: str,
                   model_name: str | None = None,
                   predict_fn: Callable | None = None,
                   batch_size: int = 128,
                   bucket_sizes: Sequence[int] | None = None,
                   input_mapping: Mapping[str, str] | None = None,
                   output_mapping: Mapping[str, str] | None = None,
                   flush_ms: float = DEFAULT_FLUSH_MS,
                   max_pending_mb: float = DEFAULT_MAX_PENDING_MB,
                   slo_ms: float | None = None,
                   warmup: bool | None = None,
                   warmup_example: Mapping[str, Any] | None = None
                   ) -> "_Tenant":
        """Route ``name`` to a model; load (and by default warm) it now.

        The model resolves exactly like ``TFModel.transform``'s executor
        side — through the bounded ``pipeline._MODEL_CACHE`` (per-path
        eviction on re-export preserved), precedence ``predict_fn`` >
        serialized forward > ``model_name``.  Tenants that resolve to the
        same loaded forward with the same bucket ladder and input mapping
        COALESCE TOGETHER.

        ``flush_ms`` is the queueing half of the tenant's latency SLO:
        how long the coalescer may hold its oldest request waiting for
        batch-mates.  ``max_pending_mb`` bounds the tenant's pending
        payload bytes (admission control).  ``slo_ms`` is the tenant's
        end-to-end latency SLO (default ``flush_ms`` ×
        ``DEFAULT_SLO_FLUSH_FACTOR``): a request over it keeps its
        complete span tree in the trace store (tail-based sampling).
        ``warmup``: ``True`` forces (raises when input shapes are
        unknowable), ``None`` warms when shapes are known
        (``warmup_example``, a self-describing export's signature, or —
        for ``model_name`` tenants — the zoo's own example batch via
        ``shapes.model_specs``, the policy-derived fallback),
        ``False`` skips.  Warming runs and, on the card, captures every
        bucket's forward here, on the caller's thread.
        """
        from tensorflowonspark_torch import pipeline, serving, shapes

        if self._stopped:
            raise RuntimeError("OnlineServer is stopped")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        in_map = dict(input_mapping or {})
        if not in_map and warmup_example:
            in_map = {k: k for k in warmup_example}
        if not in_map:
            raise ValueError(
                "add_tenant needs input_mapping (request field → model "
                "input name) or a warmup_example to derive it from")
        runner = pipeline._RunModel(
            export_dir=export_dir, model_name=model_name,
            predict_fn=predict_fn, batch_size=batch_size,
            input_mapping=in_map, output_mapping=output_mapping,
            columns=list(in_map), backend="sparkapi",
            bucket_sizes=list(bucket_sizes) if bucket_sizes else None)
        forward = runner.captured()
        buckets = shapes.resolve_buckets(batch_size, bucket_sizes)

        specs = None
        if warmup_example is not None:
            specs = shapes.input_specs(example=warmup_example)
        elif runner._signature is not None:
            try:
                specs = shapes.input_specs(signature=runner._signature)
            except ValueError:
                specs = None
        if specs is None and model_name and predict_fn is None:
            # policy-derived fallback (shapes.model_specs): a weights-only
            # zoo export still warms — the zoo's example batch is the
            # model's input-shape policy, at the loaded params' geometry
            try:
                specs = shapes.policy_specs(model_name,
                                            runner._export_specs)
                if any(f not in specs for f in in_map.values()):
                    # the operator's mapping names inputs the zoo's policy
                    # doesn't know: fall back to unwarmed, not an error —
                    # explicit sources (example/signature) still raise
                    specs = None
            except Exception as e:
                logger.info("tenant %r: no policy-derived input specs "
                            "for model %r (%s)", name, model_name, e)
                specs = None
        if specs is not None:
            missing = [f for f in in_map.values() if f not in specs]
            if missing:
                raise ValueError(
                    f"tenant {name!r}: input specs lack model input(s) "
                    f"{missing}")

        if warmup is True and specs is None:
            raise ValueError(
                f"tenant {name!r}: warmup requested but input shapes are "
                "unknowable — pass warmup_example=, serve a "
                "self-describing export, or use a model_name the "
                "shape-policy module (tensorflowonspark_torch/shapes.py: "
                "model_specs) can derive specs from")

        # output_mapping is part of the coalescing identity too: the
        # compute thread names the WHOLE batch's outputs via the group's
        # out_map, so a tenant with a different mapping must get its own
        # batches (not silently inherit the first registrant's names)
        group_key = (runner._cache_key, buckets,
                     tuple(sorted(in_map.items())),
                     tuple(sorted((output_mapping or {}).items())))
        # registration mutates the structures the coalescer iterates
        # (_groups, group.tenants): everything under the one lock.  It
        # happens LAST — after every validation and after warmup — so a
        # failed add_tenant leaves no half-configured, routable tenant
        # behind (and the name stays free for a corrected retry).
        if warmup is not False and specs is not None:
            serving.warm_buckets(forward,
                                 {f: specs[f] for f in in_map.values()},
                                 buckets, runner._cache_key, runner._device)
        with self._cond:
            if name in self._tenants:  # racing registration of one name
                raise ValueError(f"tenant {name!r} already registered")
            group = self._groups.get(group_key)
            if group is None:
                group = _ModelGroup(
                    group_key, forward,
                    serving.stager(runner._device), runner._cache_key,
                    buckets, output_mapping, specs)
                self._groups[group_key] = group
            elif specs is not None and group.specs is None:
                group.specs = specs
            tenant = _Tenant(name, group, in_map, flush_ms / 1000.0,
                             int(max_pending_mb * (1 << 20)),
                             slo_s=(slo_ms / 1000.0
                                    if slo_ms is not None else None))
            self._tenants[name] = tenant
            group.tenants.append(tenant)
        logger.info(
            "online tenant %r → %s (buckets=%s, flush=%.1fms, "
            "slo=%.1fms, pending bound=%d bytes, warmed=%s)", name,
            export_dir, list(buckets), flush_ms, tenant.slo_s * 1000,
            tenant.max_pending_bytes,
            warmup is not False and specs is not None)
        return tenant

    def remove_tenant(self, name: str) -> None:
        """Deregister a tenant: unroute it, fail its pending requests
        loudly, and evict its labeled metric series (bounded label
        cardinality — a dead tenant must not pin registry slots).  Its
        model-cache entry stays (other tenants / future re-adds share
        it)."""
        err = RuntimeError(f"tenant {name!r} removed")
        with self._cond:
            tenant = self._tenants.pop(name, None)
            if tenant is None:
                raise KeyError(f"unknown tenant {name!r}")
            group = tenant.group
            if tenant in group.tenants:
                group.tenants.remove(tenant)
            if not group.tenants:
                self._groups.pop(group.key, None)
            failed = []
            while tenant.pending:
                req = tenant.pending.popleft()
                tenant.pending_rows -= req.rows
                tenant.pending_bytes -= req.nbytes
                self._pending_rows_g.dec(req.rows)
                self._pending_bytes_g.dec(req.nbytes)
                failed.append(req)
        for req in failed:
            req.fail(err)
        tenant.evict_metrics()
        from tensorflowonspark_torch.obs import ledger as ledger_mod

        ledger_mod.get_ledger().evict_tenant(name)
        logger.info("online tenant %r removed (%d pending failed)", name,
                    len(failed))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "OnlineServer":
        if self._started:
            return self
        self._started = True
        # monotonic: uptime feeds the fleet plane's young-replica
        # exemption — a wall-clock NTP step must not rejuvenate a
        # long-cold replica (or age a fresh one into a finding)
        self._started_ts = time.monotonic()
        self._coalescer = threading.Thread(
            target=self._coalesce_loop, name="tfos-online-coalescer",
            daemon=True)
        self._computer = threading.Thread(
            target=self._compute_loop, name="tfos-online-compute",
            daemon=True)
        self._coalescer.start()
        self._computer.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop serving.  Every request still in flight is failed with an
        explicit error — a caller blocked in :meth:`submit` always wakes."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._cond.notify_all()
        if self._coalescer is not None:
            self._coalescer.join(timeout=timeout)
        # drain staged-but-uncomputed batches and fail their callers; the
        # compute thread may be racing these gets — both sides only ever
        # FAIL or ANSWER a request, never drop it
        err = RuntimeError("online server stopped")
        while True:
            try:
                item = self._staged.get_nowait()
            except _queue_mod.Empty:
                break
            if item is not _STOP:
                for req in item[1]:
                    req.fail(err)
        try:
            self._staged.put_nowait(_STOP)
        except _queue_mod.Full:  # pragma: no cover - queue just drained
            pass
        if self._computer is not None:
            self._computer.join(timeout=timeout)
        with self._cond:
            for tenant in self._tenants.values():
                while tenant.pending:
                    req = tenant.pending.popleft()
                    tenant.pending_rows -= req.rows
                    tenant.pending_bytes -= req.nbytes
                    self._pending_rows_g.dec(req.rows)
                    self._pending_bytes_g.dec(req.nbytes)
                    req.fail(err)

    # -- request path --------------------------------------------------------

    def submit(self, tenant: str, inputs: Mapping[str, Any],
               timeout: float = 30.0,
               trace_ctx: "_trace.TraceContext | None" = None
               ) -> dict[str, np.ndarray]:
        """Score ``inputs`` for ``tenant``; blocks until the coalesced
        forward replies.  ``inputs``: request field → array with a shared
        leading batch axis (a single row is shape ``(1, ...)``).  Returns
        output column → array of this request's rows.

        ``trace_ctx`` is the inbound trace context (e.g. a parsed W3C
        ``traceparent``): the request's span tree joins that trace and
        capture is GUARANTEED (explicit propagation always arms).
        Without it the request arms at ``TFOS_TRACE_ARM`` — armed
        requests additionally join the caller's ambient
        ``obs.trace_context()`` when one is installed; callers who need
        certain capture pass ``trace_ctx=obs.trace_context()``.

        Raises :class:`Rejected` when the tenant's pending queue is over
        its byte bound (shed — retry after backoff), ``KeyError`` for an
        unknown tenant, ``ValueError`` for malformed inputs,
        ``TimeoutError`` when no reply arrives in ``timeout`` seconds.
        """
        ts = self._tenants.get(tenant)
        if ts is None:
            raise KeyError(f"unknown tenant {tenant!r} "
                           f"(have {sorted(self._tenants)})")
        # inlined _trace.requests_enabled(): memoized on the raw env
        # string, no function call on the cached path
        raw = _env_get("TFOS_TRACE_REQUESTS", "1")
        cached = _trace._REQ_ENABLED_CACHE
        tracing = (cached[1] if raw == cached[0]
                   else _trace.requests_enabled())
        inbound = None
        armed = False
        if tracing:
            if trace_ctx is not None:
                # explicit propagation always captures
                inbound, armed = trace_ctx, True
            else:
                rawa = _env_get("TFOS_TRACE_ARM", "")
                ca = _trace._ARM_CACHE
                arm = ca[1] if rawa == ca[0] else _trace.arm_rate()
                armed = arm >= 1.0 or (arm > 0.0
                                       and _rng_random() < arm)
                if armed:
                    # inlined _trace.trace_context(): innermost open span
                    # on this thread, else the ambient context.  Consulted
                    # only for armed requests — implicit in-process
                    # propagation joins at the arm rate; pass
                    # trace_ctx=obs.trace_context() to guarantee capture
                    local = _TRACER._local
                    stack = getattr(local, "stack", None)
                    if stack:
                        _, span_id, trace_id = stack[-1]
                        inbound = _trace.TraceContext(trace_id, span_id)
                    else:
                        inbound = getattr(local, "ctx", None)
        a0 = time.perf_counter()
        try:
            cols, rows, nbytes = self._validate(ts, inputs)
        except Exception as e:
            if tracing:  # invalid requests: always captured (cold path)
                rt = _trace.RequestTrace(
                    "online.request", ctx=inbound,
                    started=(time.time(), a0), tenant=tenant)
                rt.add("admission", time.perf_counter() - a0,
                       outcome="invalid")
                rt.finish(status="error",
                          error=f"{type(e).__name__}: {e}"[:300])
                _trace.get_trace_store().commit(rt, retain="error")
            raise
        now = time.perf_counter()
        req = _Request(ts, cols, rows, nbytes, now + ts.flush_s,
                       enqueued=now)
        if armed:
            # raw fields only — the trace id itself, the wall anchor,
            # admission attrs and every span dict derive at
            # materialization, which only the retained minority reaches
            if inbound is not None:
                req.inbound = inbound
                req.trace_id = inbound.trace_id
            req.trace_seq = next(_TRACE_SEQ)
            req.t0_perf = a0
            req.admission_dur = now - a0
        shed_exc = None
        with self._cond:
            if not self._started or self._stopped:
                raise RuntimeError("OnlineServer is not serving "
                                   "(start() it / already stopped)")
            # the _ByteBoundedQueue convention: bytes held from enqueue to
            # drain; a single oversize request is admitted when the queue
            # is byte-empty (otherwise it could never be served at all)
            if ts.pending_bytes > 0 and \
                    ts.pending_bytes + nbytes > ts.max_pending_bytes:
                ts.note_shed()
                self._shed_total.inc()
                pending_bytes = ts.pending_bytes
                shed_exc = Rejected(
                    f"tenant {tenant!r} pending queue over its byte bound "
                    f"({pending_bytes + nbytes} > "
                    f"{ts.max_pending_bytes}); request shed — back off "
                    "and retry", retry_after_s=max(ts.flush_s, 0.01))
            else:
                ts.pending.append(req)
                ts.pending_rows += rows
                ts.pending_bytes += nbytes
                ts.note_admitted()
                self._requests_total.inc()
                self._rows_total.inc(rows)
                self._pending_rows_g.inc(rows)
                self._pending_bytes_g.inc(nbytes)
                self._cond.notify()
        if shed_exc is not None:
            # cold path: journal the verdict (admission sheds are a
            # control-plane transition — the incident timeline needs the
            # moment pressure crossed the byte bound, per tenant)
            _journal.emit("admission.shed", tenant=tenant,
                          where="replica",
                          pending_bytes=pending_bytes,
                          max_pending_bytes=ts.max_pending_bytes)
            if tracing:
                # sheds are ALWAYS captured, armed or not (this cold path
                # can afford to arm retroactively).  "How long it sat
                # shed-adjacent": the admission window from entry to the
                # byte-bound decision (the admitted case's window ends at
                # validation; this one includes the lock wait that
                # preceded the shed verdict)
                if not req.t0_perf:
                    req.inbound = inbound
                    req.trace_seq = next(_TRACE_SEQ)
                    req.t0_perf = a0
                req.admission_dur = time.perf_counter() - a0
                req.admission_attrs = {
                    "outcome": "shed", "pending_bytes": pending_bytes,
                    "max_pending_bytes": ts.max_pending_bytes}
            req.fail(shed_exc)  # materializes + retains the trace: "shed"
            raise shed_exc
        if not req.event.wait(timeout):
            # the finish race with a late compute-thread reply is settled
            # by the claim: exactly one side materializes + commits
            if req.claim_trace():
                rt = _build_trace(req)
                rt.finish(status="timeout", timeout_s=timeout)
                _trace.get_trace_store().commit(rt, retain="timeout")
            raise TimeoutError(
                f"no reply for tenant {tenant!r} within {timeout}s "
                "(server overloaded or stopped?)")
        if req.error is not None:
            raise RuntimeError(
                f"online forward failed for tenant {tenant!r}: "
                f"{req.error!r}") from req.error
        return req.result

    def _validate(self, ts: _Tenant, inputs: Mapping[str, Any]
                  ) -> tuple[dict, int, int]:
        """Map request fields → model-input columns; reject malformed
        requests HERE so a bad request can never poison the coalesced
        batch its well-formed neighbors ride in."""
        from tensorflowonspark_torch import shapes

        unknown = set(inputs) - set(ts.in_map)
        if unknown:
            raise ValueError(
                f"unknown request field(s) {sorted(unknown)}; tenant "
                f"{ts.name!r} accepts {sorted(ts.in_map)}")
        specs = ts.group.specs
        cols: dict[str, np.ndarray] = {}
        for field, feat in ts.in_map.items():
            if field not in inputs:
                raise ValueError(f"request missing field {field!r}")
            a = np.asarray(inputs[field])
            spec = specs.get(feat) if specs else None
            if spec is not None:
                a = np.asarray(a, dtype=spec[1])
                if tuple(a.shape[1:]) != tuple(spec[0]):
                    raise ValueError(
                        f"field {field!r} rows have shape "
                        f"{tuple(a.shape[1:])}, expected {tuple(spec[0])}")
            else:
                a = _canon(a)
            cols[feat] = a
        rows = shapes.batch_rows(cols)
        if rows <= 0:
            raise ValueError(
                "request inputs must share a leading batch axis (a single "
                "row is shape (1, ...))")
        if rows > ts.group.batch_cap:
            raise ValueError(
                f"request carries {rows} rows > the tenant's largest "
                f"bucket {ts.group.batch_cap}; split it client-side")
        nbytes = sum(int(a.nbytes) for a in cols.values())
        return cols, rows, nbytes

    # -- coalescer (assembly thread) -----------------------------------------

    def _next_flush(self, now: float
                    ) -> tuple[_ModelGroup | None, float | None, str]:
        """Under the lock: the group most overdue to flush (with WHY it
        flushes — ``deadline`` / ``full_bucket`` / ``engine_idle``, the
        causality a request trace cites), or the wait until the nearest
        deadline (None = nothing pending)."""
        ready: _ModelGroup | None = None
        ready_deadline = None
        ready_trigger = ""
        nearest: float | None = None
        idle = self._inflight == 0
        for group in self._groups.values():
            oldest = group.oldest_deadline()
            if oldest is None:
                continue
            if oldest <= now:
                trigger = "deadline"
            elif group.pending_rows() >= group.batch_cap:
                trigger = "full_bucket"
            elif idle:
                trigger = "engine_idle"
            else:
                if nearest is None or oldest < nearest:
                    nearest = oldest
                continue
            if ready is None or oldest < ready_deadline:
                ready, ready_deadline = group, oldest
                ready_trigger = trigger
        if ready is not None:
            return ready, None, ready_trigger
        return (None,
                None if nearest is None else max(0.0, nearest - now), "")

    def _drain(self, group: _ModelGroup) -> tuple[list[_Request], int]:
        """Under the lock: pop up to one bucket of rows, round-robin
        across the group's tenants (requests stay whole — scatter slices
        must map 1:1 back to callers).  Rotation means a deep backlog on
        one tenant cannot starve another's freshly-arrived request."""
        cap = group.batch_cap
        members = group.tenants
        out: list[_Request] = []
        rows = 0
        start = group.rr
        progressed = True
        while progressed and rows < cap:
            progressed = False
            for i in range(len(members)):
                ts = members[(start + i) % len(members)]
                if ts.pending and rows + ts.pending[0].rows <= cap:
                    req = ts.pending.popleft()
                    ts.pending_rows -= req.rows
                    ts.pending_bytes -= req.nbytes
                    self._pending_rows_g.dec(req.rows)
                    self._pending_bytes_g.dec(req.nbytes)
                    out.append(req)
                    rows += req.rows
                    progressed = True
                    if rows >= cap:
                        break
        group.rr = (group.rr + 1) % max(1, len(members))
        return out, rows

    def _coalesce_loop(self) -> None:
        from tensorflowonspark_torch import serving, shapes
        from tensorflowonspark_torch.obs import flight

        rec = flight.recorder("online")
        perf = time.perf_counter
        while True:
            with self._cond:
                while True:
                    if self._stopped:
                        return
                    group, wait_s, trigger = self._next_flush(perf())
                    if group is not None:
                        reqs, n = self._drain(group)
                        self._batch_seq += 1
                        batch_id = self._batch_seq
                        break
                    self._cond.wait(timeout=wait_s)
                if reqs:
                    self._inflight += 1
            if not reqs:  # pragma: no cover - defensive (ready ⇒ pending)
                continue
            # one shared batch record per batch; each traced member just
            # points at it — span expansion happens only on retention
            bt = _BatchTrace(batch_id)
            bt.drained_wall, bt.drained_perf = time.time(), perf()
            bt.coalescer_tid = threading.get_ident() & 0xFFFFFFFF
            traced = [r for r in reqs if r.t0_perf]
            for req in traced:
                req.batch = bt
            try:
                t0 = perf()
                cols = self._concat(reqs)
                t1 = perf()
                bucket = shapes.choose_bucket(n, group.buckets)
                if bucket > n:
                    cols = serving.pad_columns(cols, bucket)
                serving.note_rows(n, bucket)
                staged = group.stage(cols)
            except Exception as e:
                # e.g. a spec-less tenant's requests with mismatched row
                # shapes meeting in one np.concatenate: fail THIS batch's
                # callers loudly and keep serving — an unguarded assembly
                # error would kill the coalescer thread and wedge every
                # future caller of every tenant
                self._errors_total.inc()
                logger.warning(
                    "online coalesce failed (%d reqs, %d rows): %r",
                    len(reqs), n, e)
                for req in reqs:
                    req.fail(e)
                self._note_idle()
                continue
            # always overlapped: unlike _RunModel's depth-0 inline mode,
            # the coalescer is a separate thread even at prefetch 0, so
            # counting these as additive would double the stage sum
            # against the compute thread's wait
            rec.add(overlapped=True, coalesce=t1 - t0,
                    pad=perf() - t1)
            self._coalesce_size.observe(n)
            if traced:
                bt.bucket, bt.rows, bt.flush = bucket, n, trigger
                bt.pad_waste = (round((bucket - n) / bucket, 4)
                                if bucket else 0.0)
                bt.n_requests = len(reqs)
                bt.members = reqs  # aliased; ids/tenants derive lazily
                bt.assembled_wall = time.time()
                # assembled_perf is the GATE spans_for() checks: set LAST,
                # after every field it guards, so a racing timeout-path
                # materialization can never see a half-filled record
                bt.assembled_perf = perf()
            item = (group, reqs, n, bucket, staged, bt)
            while True:
                try:
                    self._staged.put(item, timeout=0.2)
                    break
                except _queue_mod.Full:
                    if self._stopped:
                        err = RuntimeError("online server stopped")
                        for req in reqs:
                            req.fail(err)
                        self._note_idle()
                        return

    @staticmethod
    def _concat(reqs: list[_Request]) -> dict[str, np.ndarray]:
        if len(reqs) == 1:
            return dict(reqs[0].cols)
        feats = reqs[0].cols.keys()
        return {f: np.concatenate([r.cols[f] for r in reqs])
                for f in feats}

    # -- compute + scatter (reply thread) ------------------------------------

    def _compute_loop(self) -> None:
        from tensorflowonspark_torch import pipeline, serving
        from tensorflowonspark_torch.obs import flight
        from tensorflowonspark_torch.obs import ledger as ledger_mod

        rec = flight.recorder("online")
        store = _trace.get_trace_store()
        led = ledger_mod.get_ledger()
        perf = time.perf_counter
        while True:
            t0 = perf()
            item = self._staged.get()
            if item is _STOP:
                return
            wait = perf() - t0
            group, reqs, n, bucket, batch, bt = item
            t1 = perf()
            try:
                fresh = serving.note_compile(group.cache_key, batch)
                # the device-to-host copy, before another call may replay
                # the graph: the batch's one sync
                outputs = group.forward(batch, take=serving.to_host)
                named = pipeline._name_outputs(outputs, group.out_map)
                arrays: dict[str, np.ndarray] = {}
                for cname, a in named.items():
                    if a.ndim == 0 or a.shape[0] != bucket:
                        raise ValueError(
                            f"online output {cname!r} has shape "
                            f"{np.shape(a)} but the batch fed {bucket} "
                            "rows — outputs must be per-example to "
                            "scatter back to callers")
                    arrays[cname] = a
            except Exception as e:
                self._errors_total.inc()
                logger.warning("online forward failed (%d reqs, %d rows): "
                               "%r", len(reqs), n, e)
                for req in reqs:
                    req.fail(e)
                rec.add(wait=wait, compute=perf() - t1)
                rec.commit()
                self._note_idle()
                continue
            t2 = perf()
            if fresh:
                # a new shape signature met the forward here: that call's
                # wall (an eager first call) is the cost a warmup moves
                # off the request path
                serving.observe_compile_seconds(t2 - t1)
            bt.forward_dur = t2 - t1
            bt.forward_end_wall = time.time()
            bt.compute_tid = threading.get_ident() & 0xFFFFFFFF
            # cost apportionment rides the measurement it charges: the
            # forward wall splits across batch-mates by row share (the
            # pad rows' slice books to the bucket choice), the compile
            # wall to the head tenant that met the fresh signature —
            # from the local reqs, NOT bt.members (trace-gated)
            led.charge_batch(
                "online",
                [(req.tenant.name, req.rows, req.nbytes)
                 for req in reqs],
                t2 - t1, bucket=bucket,
                compile_s=(t2 - t1) if fresh else 0.0)
            # every caller is woken FIRST; per-request trace bookkeeping
            # follows, off the callers' critical path
            latencies = self._scatter(reqs, arrays)
            t3 = perf()
            bt.reply_dur = t3 - t2
            bt.reply_end_wall = time.time()
            dropped = 0
            sample = _trace.sample_rate()  # hoisted: one env read per batch
            for req, latency in zip(reqs, latencies):
                if not req.t0_perf:
                    req.tenant.observe_latency(latency)
                    continue
                # tail retention: an SLO breach keeps the complete tree,
                # everything else gets one uniform-sample roll; only a
                # KEPT trace pays materialization.  The trace token
                # settles the race with a caller-side timeout.
                reason = ("slo_breach" if latency > req.tenant.slo_s
                          else "sampled" if sample >= 1.0
                          or (sample > 0.0 and _rng_random() < sample)
                          else None)
                kept = None
                if reason is not None and req.claim_trace():
                    rt = _build_trace(req)
                    rt.finish(status="ok",
                              latency_ms=round(latency * 1000, 3),
                              rows=req.rows)
                    kept = store.commit(rt, retain=reason)
                elif reason is None and req.claim_trace():
                    # drop decided UNDER the claim: a caller-side timeout
                    # that won the claim already committed this trace, and
                    # counting it dropped too would double the store's
                    # committed/dropped accounting (an unlocked flag read
                    # here would race that exact interleaving)
                    dropped += 1
                # exemplar only for a RETAINED trace: a dashboard click
                # through an exemplar must land on a trace that exists
                req.tenant.observe_latency(
                    latency, trace_id=req.trace_id if kept else None)
            store.note_dropped(dropped)
            rec.add(wait=wait, compute=t2 - t1, reply=perf() - t2)
            rec.commit()
            self._note_idle()

    @staticmethod
    def _scatter(reqs: list[_Request], arrays: dict[str, np.ndarray]
                 ) -> list[float]:
        """Hand each request its rows and wake it: request k owns rows
        ``[off, off + k.rows)`` of the batch, in drain order (the tenant
        mix is irrelevant to correctness).  Returns each request's
        submit-to-reply latency."""
        perf = time.perf_counter
        off = 0
        latencies = []
        for req in reqs:
            req.result = {c: a[off:off + req.rows]
                          for c, a in arrays.items()}
            off += req.rows
            req.event.set()
            latencies.append(perf() - req.enqueued)
        return latencies

    def _note_idle(self) -> None:
        """One staged batch fully answered: wake the coalescer — an idle
        engine flushes pending work immediately (see ``_inflight``)."""
        with self._cond:
            self._inflight -= 1
            self._cond.notify()

    # -- introspection -------------------------------------------------------

    @property
    def state(self) -> str:
        if self._stopped:
            return "stopped"
        return "serving" if self._started else "created"

    def stats(self) -> dict[str, Any]:
        """JSON-able server + per-tenant state (the ``/healthz`` body).

        ``shed_window`` is the last-window shed *rate* (shed / offered
        over the tumbling window) — admission pressure visible without
        Prometheus rate() math over the lifetime counters.

        The top-level ``admission`` block is a STABLE, machine-consumable
        summary (``admission_schema`` versions it; field removals or
        semantic changes bump the version) — the one field the
        serving-mesh router's global admission control reads instead of
        scraping Prometheus text:

        - ``pending_bytes`` / ``max_pending_bytes`` / ``pending_rows`` —
          byte-bound admission state summed over the tenants (the
          ``_ByteBoundedQueue`` accounting: payload bytes held from
          enqueue to drain);
        - ``saturation`` — ``pending_bytes / max_pending_bytes`` (0 when
          unbounded), the replica-level back-pressure signal;
        - ``shed_window`` — the tumbling offered/shed/``shed_rate``
          window aggregated across tenants (coverage = the longest
          tenant window).

        Per-tenant blocks carry the same fields tenant-scoped, so a
        router that places tenants individually can shed per (replica,
        tenant) rather than per replica.
        """
        tenants = {}
        with self._lock:
            # window snapshots roll under the same lock note() runs under
            snap = [(ts, ts.shed_window.snapshot())
                    for ts in self._tenants.values()]
        agg_offered = agg_shed = 0
        agg_window_s = 0.0
        agg_pending_bytes = agg_pending_rows = agg_max_bytes = 0
        for ts, window in snap:
            agg_offered += window["offered"]
            agg_shed += window["shed"]
            agg_window_s = max(agg_window_s, window["window_s"])
            agg_pending_bytes += ts.pending_bytes
            agg_pending_rows += ts.pending_rows
            agg_max_bytes += ts.max_pending_bytes
            tenants[ts.name] = {
                "pending_rows": ts.pending_rows,
                "pending_bytes": ts.pending_bytes,
                "max_pending_bytes": ts.max_pending_bytes,
                "flush_ms": round(ts.flush_s * 1000, 3),
                "slo_ms": round(ts.slo_s * 1000, 3),
                "requests_total": int(ts.requests_total.value),
                "shed_total": int(ts.shed_total.value),
                "shed_window": window,
                "latency_p50_ms": ts.quantile_ms(0.50),
                "latency_p99_ms": ts.quantile_ms(0.99),
            }
        from tensorflowonspark_torch import serving as _serving

        return {
            "state": self.state,
            # fleet-view context: a young replica with a low compile-
            # cache warm ratio is an EXPECTED cold start; a long-running
            # one is a finding (obs/fleet.py check_fleet)
            "uptime_s": (round(time.monotonic() - self._started_ts, 3)
                         if self._started_ts else None),
            "tenants": tenants,
            # compile-cache visibility: ``warm_ratio`` (hits and warmed
            # signatures over all shape requests) is how a router can see
            # a COLD replica — one whose requests still pay first calls
            # and captures — and ``dir``/``namespace`` say where the
            # kernel library store lives.  Outside the versioned
            # ``admission`` block: additive field, admission_schema
            # semantics unchanged.
            "compile_cache": _serving.cache_health(),
            "admission": {
                "admission_schema": 1,
                "pending_bytes": agg_pending_bytes,
                "pending_rows": agg_pending_rows,
                "max_pending_bytes": agg_max_bytes,
                "saturation": (round(agg_pending_bytes / agg_max_bytes, 4)
                               if agg_max_bytes else 0.0),
                "shed_window": {
                    "window_s": agg_window_s,
                    "offered": agg_offered,
                    "shed": agg_shed,
                    "shed_rate": (round(agg_shed / agg_offered, 4)
                                  if agg_offered else 0.0),
                },
            },
            "models_loaded": len(self._groups),
            "staged_batches": self._staged.qsize(),
            "requests_total": int(self._requests_total.value),
            "rows_total": int(self._rows_total.value),
            "shed_total": int(self._shed_total.value),
            "errors_total": int(self._errors_total.value),
        }


# ---------------------------------------------------------------------------
# HTTP front end (obs/httpd.py pattern: stdlib, no framework)
# ---------------------------------------------------------------------------


class OnlineHTTPServer:
    """Thin stdlib HTTP front end over an :class:`OnlineServer`.

    - ``POST /v1/predict`` — body ``{"tenant": str, "inputs": {field:
      nested lists}, "timeout_s": float?}`` → ``{"outputs": {col:
      lists}, "rows": n}``.  Admission shed → **429** with a
      ``Retry-After`` header; unknown tenant → 404; malformed → 400;
      reply timeout → 504.  A W3C ``traceparent`` request header joins
      the caller's distributed trace (the reply then echoes that trace
      id as ``trace_id``, the key to look up on ``/debug/requests``).
    - ``GET /metrics`` — Prometheus text of this process's registry
      (the online counters/histograms ride the same exposition as every
      other instrument); ``Accept: application/openmetrics-text`` gets
      the OpenMetrics flavor with trace-id exemplars on the latency
      histogram buckets.
    - ``GET /healthz`` — :meth:`OnlineServer.stats` JSON; 200 while
      serving, 503 otherwise.
    - ``GET /pipeline`` — this process's flight-recorder planes (the
      ``"online"`` plane's stage totals + verdicts) plus the stats doc.
    - ``GET /debug/requests`` — the retained request traces
      (slowest-first JSON: SLO breaches, sheds, errors, the uniform
      sample), straight from the process trace store.

    A handler that raises becomes a 500; the endpoint must never take the
    serving process down (the ``obs/httpd.py`` contract).
    """

    def __init__(self, server: OnlineServer, host: str = "127.0.0.1",
                 port: int = 0):
        self._online = server
        self._host = host
        self._port = port
        self._httpd = None
        self._thread: threading.Thread | None = None

    def start(self) -> tuple[str, int]:
        import json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from tensorflowonspark_torch import obs
        from tensorflowonspark_torch.obs import httpd as _httpd
        from tensorflowonspark_torch.obs import flight

        online = self._online

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every reply carries Content-Length, so
            # persistent connections are safe — and the serving-mesh
            # router proxies EVERY request through here on a pooled
            # connection (HTTP/1.0's close-per-request made each proxied
            # hop pay a reconnect)
            protocol_version = "HTTP/1.1"

            def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        accept = self.headers.get("Accept", "") or ""
                        if "application/openmetrics-text" in accept:
                            self._reply(
                                200, _httpd.OPENMETRICS_CONTENT_TYPE,
                                obs.get_registry().to_openmetrics())
                        else:
                            self._reply(
                                200, _httpd.PROMETHEUS_CONTENT_TYPE,
                                obs.get_registry().to_prometheus())
                    elif path == "/healthz":
                        doc = online.stats()
                        self._reply(
                            200 if doc["state"] == "serving" else 503,
                            "application/json", json.dumps(doc))
                    elif path == "/pipeline":
                        doc = {"planes": flight.local_report(),
                               "server": online.stats()}
                        self._reply(200, "application/json",
                                    json.dumps(doc))
                    elif path == "/debug/requests":
                        self._reply(
                            200, "application/json",
                            json.dumps(_trace.get_trace_store().to_doc()))
                    else:
                        self._reply(404, "application/json", json.dumps(
                            {"error": "not found",
                             "routes": ["/v1/predict (POST)", "/metrics",
                                        "/healthz", "/pipeline",
                                        "/debug/requests"]}))
                except Exception as e:  # must never kill the server
                    logger.warning("online http GET %s failed: %s", path, e)
                    self._reply(500, "text/plain; charset=utf-8",
                                f"handler error: {e}")

            def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
                path = self.path.split("?", 1)[0].rstrip("/")
                # drain the body even on the 404 path: under HTTP/1.1
                # keep-alive an unread body desyncs the connection (the
                # leftover bytes parse as the next request line)
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                if path != "/v1/predict":
                    self._reply(404, "application/json",
                                json.dumps({"error": "not found"}))
                    return
                try:
                    body = json.loads(raw or b"{}")
                    tenant = body.get("tenant")
                    inputs = body.get("inputs")
                    if not tenant or not isinstance(inputs, dict):
                        raise ValueError(
                            "body must carry 'tenant' and 'inputs'")
                    # explicit timeout_s of 0 means fail-fast, not the
                    # default — a falsy-or would silently make it 30s
                    timeout = min(float(body["timeout_s"])
                                  if "timeout_s" in body else 30.0,
                                  300.0)
                    # W3C trace-context propagation: the request's span
                    # tree joins the caller's distributed trace (lenient:
                    # a malformed header starts a fresh trace, never 400s)
                    ctx = _trace.parse_traceparent(
                        self.headers.get("traceparent"))
                    t0 = time.perf_counter()
                    out = online.submit(tenant, inputs, timeout=timeout,
                                        trace_ctx=ctx)
                    doc = {"outputs": {c: np.asarray(a).tolist()
                                       for c, a in out.items()},
                           "rows": int(next(iter(out.values())).shape[0])
                           if out else 0,
                           "latency_ms": round(
                               (time.perf_counter() - t0) * 1000, 3)}
                    if ctx is not None:
                        doc["trace_id"] = ctx.trace_id
                    self._reply(200, "application/json", json.dumps(doc))
                except Rejected as e:
                    import math

                    # header per RFC 9110: integer delta-seconds (a
                    # fractional value is unparseable to spec-compliant
                    # retry middleware); the body keeps the precise float
                    self._reply(429, "application/json", json.dumps(
                        {"error": str(e),
                         "retry_after_s": e.retry_after_s}),
                        extra_headers={"Retry-After": str(max(
                            1, math.ceil(e.retry_after_s)))})
                except KeyError as e:
                    self._reply(404, "application/json",
                                json.dumps({"error": str(e)}))
                except (ValueError, TypeError) as e:
                    self._reply(400, "application/json",
                                json.dumps({"error": str(e)}))
                except TimeoutError as e:
                    self._reply(504, "application/json",
                                json.dumps({"error": str(e)}))
                except Exception as e:  # must never kill the server
                    logger.warning("online http POST failed: %s", e)
                    self._reply(500, "application/json",
                                json.dumps({"error": f"handler error: "
                                                     f"{e}"}))

            def _reply(self, status: int, ctype: str, body,
                       extra_headers: dict | None = None) -> None:
                if isinstance(body, str):
                    body = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt: str, *args: Any) -> None:
                logger.debug("online http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tfos-online-http",
            daemon=True)
        self._thread.start()
        return self.address

    @property
    def address(self) -> tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    def url(self, path: str = "/") -> str:
        host, port = self.address
        return f"http://{host}:{port}{path}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
