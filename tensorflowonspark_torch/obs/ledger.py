"""Per-tenant cost accounting + training goodput ledger.

The fleet plane can say which replica is hot and whose SLO is burning
(the fleet planes); nothing says **who is spending the hardware** or what
fraction of training wall-clock is productive — the multi-tenant
attribution the TensorFlow system paper (arXiv:1605.08695) treats as
table stakes for production clusters, and the capacity/billing view the
QoS arc (ROADMAP item 5: priority admission, preemptible decode) will
price its decisions on.  Two ledgers, one module:

- **CostLedger** — apportions *engine* time to tenants at the moment it
  is measured, on the thread that measured it:

  - a coalesced online batch's forward wall splits across its
    batch-mates by **row share** (the batch already knows its tenant
    mix; the pad rows' share is charged to the **bucket choice** that
    forced the pad, as a ``bucket=`` labeled series — padding waste is
    a ladder-geometry cost, not any tenant's);
  - a decode step's wall splits across the active slots by **tokens
    emitted** (one per live slot per step); a prefill's wall is the
    admitted request's alone;
  - a serving partition's forward wall attributes to its **model key**
    (batch scoring has no tenants; the model is the payer);
  - compile seconds are charged to the tenant whose request missed the
    cache (the head of the batch that met the fresh signature — it
    asked first, it pays; everyone after rides the warm path);
  - per-tenant admitted rows / bytes / tokens ride beside the seconds,
    so a chargeback report can price whichever unit the contract names.

  Every meter is a labeled Prometheus family with **cached instrument
  handles** (the ``_Tenant`` rule: the hot path never pays a registry
  lookup) and bounded cardinality (the registry's
  ``TFOS_METRIC_SERIES_MAX`` overflow machinery); an evicted tenant's
  series are removed with it.  The unlabeled
  ``ledger_engine_seconds_total{plane=}`` family records the same walls
  un-apportioned — the conservation denominator: Σ per-tenant
  device-seconds + pad-seconds ≡ engine-seconds by construction, and
  ``bench.py --costs`` proves the identity holds under concurrent
  mixed-tenant load within 1%.

- **GoodputLedger** — folds the training side's existing signals (the
  feed plane's flight stages, the trainer's shard/compute windows,
  checkpoint saves, elastic recovery windows, first-call compiles) into
  a wall-clock breakdown ``productive / input_wait / compile /
  checkpoint / recovery / stall`` that must reconcile to measured wall
  within the flight recorder's tolerance discipline (``stall`` is the
  clamped residual — wall nobody claimed; a large stall is itself a
  finding).  The first trained step's compute wall IS the jit compile
  (the ``note_compile`` discipline serving uses), so it books as
  ``compile``, not ``productive``.

``TFOS_LEDGER=0`` disables cost recording (memoized on the raw env
string — the trace.py discipline; ``bench.py --costs`` A/Bs the
overhead and the gate holds it at the noise floor).  What the ledger
**never** records: request payloads, row contents, prompts or tokens
themselves — only counts and seconds, per tenant name the operator
already configured.
"""

from __future__ import annotations

import os
import threading
from collections import defaultdict
from typing import Any, Sequence

__all__ = [
    "CostLedger", "GoodputLedger", "enabled", "set_enabled",
    "get_ledger", "goodput", "reset", "GOODPUT_PHASES",
    "COST_FAMILIES",
]

#: every per-tenant cost family the ledger mints (eviction + federation
#: read this list; ``ledger_pad_seconds_total`` is bucket-labeled and
#: ``ledger_engine_seconds_total`` plane-labeled, so they live apart)
COST_FAMILIES = (
    "ledger_device_seconds_total",
    "ledger_rows_total",
    "ledger_tokens_total",
    "ledger_bytes_total",
    "ledger_compile_seconds_total",
)

#: the goodput breakdown's complete phase vocabulary, in report order
GOODPUT_PHASES = ("productive", "input_wait", "compile", "checkpoint",
                  "recovery", "stall")

#: feed-plane flight stages the goodput breakdown folds in as input
#: wait — the halves the TRAINER never times itself (DataFeed records
#: them); shard/compute are noted directly by the trainer and excluded
#: here so nothing double-counts
_INPUT_STAGES = ("wait", "ingest", "collate", "stage")

_ENABLED_CACHE: tuple[str | None, bool] = (None, True)


def enabled() -> bool:
    """``TFOS_LEDGER`` gate, memoized on the raw env string (no parse
    on the hot path — the trace.py discipline)."""
    global _ENABLED_CACHE
    raw = os.environ.get("TFOS_LEDGER", "1")
    cached = _ENABLED_CACHE
    if raw == cached[0]:
        return cached[1]
    on = raw.strip().lower() not in ("0", "false", "no", "off")
    _ENABLED_CACHE = (raw, on)
    return on


def set_enabled(on: bool) -> None:
    """Flip cost recording (the bench overhead A/B seam — same effect
    as exporting ``TFOS_LEDGER``)."""
    os.environ["TFOS_LEDGER"] = "1" if on else "0"


class _TenantMeters:
    """One tenant's cached instrument handles (minted once; the charge
    path pays zero registry lookups — the ``_Tenant`` rule)."""

    __slots__ = ("name", "device_seconds", "rows", "tokens", "bytes",
                 "compile_seconds")

    def __init__(self, name: str):
        from tensorflowonspark_torch import obs

        label = {"tenant": name}
        self.name = name
        self.device_seconds = obs.counter(
            "ledger_device_seconds_total",
            "engine wall apportioned to this tenant (row / token share "
            "of each batch it rode)", labels=label)
        self.rows = obs.counter(
            "ledger_rows_total", "rows this tenant fed through coalesced "
            "forwards", labels=label)
        self.tokens = obs.counter(
            "ledger_tokens_total", "decode tokens emitted for this "
            "tenant", labels=label)
        self.bytes = obs.counter(
            "ledger_bytes_total", "payload bytes this tenant fed through "
            "charged batches", labels=label)
        self.compile_seconds = obs.counter(
            "ledger_compile_seconds_total",
            "compile wall charged to this tenant (its request met the "
            "fresh signature)", labels=label)


class CostLedger:
    """Per-process tenant cost apportionment (module doc).

    ``shares`` everywhere below is an iterable of ``(tenant, units,
    bytes)`` triples; a batch's wall splits proportionally to ``units``
    (rows online, tokens on decode).  All charge methods are cheap
    no-ops when :func:`enabled` is off — the A/B seam.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantMeters] = {}
        self._engine: dict[str, Any] = {}
        self._pads: dict[str, Any] = {}

    # -- instrument caches ---------------------------------------------------

    def _meters(self, tenant: str) -> _TenantMeters:
        m = self._tenants.get(tenant)
        if m is None:
            with self._lock:
                m = self._tenants.get(tenant)
                if m is None:
                    m = self._tenants[tenant] = _TenantMeters(tenant)
        return m

    def _engine_counter(self, plane: str):
        c = self._engine.get(plane)
        if c is None:
            from tensorflowonspark_torch import obs

            with self._lock:
                c = self._engine.get(plane)
                if c is None:
                    c = self._engine[plane] = obs.counter(
                        "ledger_engine_seconds_total",
                        "un-apportioned engine busy wall per serving "
                        "plane (the conservation denominator)",
                        labels={"plane": plane})
        return c

    def _pad_counter(self, bucket: int):
        key = str(int(bucket))
        c = self._pads.get(key)
        if c is None:
            from tensorflowonspark_torch import obs

            with self._lock:
                c = self._pads.get(key)
                if c is None:
                    c = self._pads[key] = obs.counter(
                        "ledger_pad_seconds_total",
                        "forward wall spent computing pad rows, charged "
                        "to the bucket choice that forced the pad",
                        labels={"bucket": key})
        return c

    # -- charging (hot path) -------------------------------------------------

    def charge_batch(self, plane: str,
                     shares: Sequence[tuple[str, int, int]],
                     wall_s: float, *, bucket: int = 0,
                     compile_s: float = 0.0) -> None:
        """Charge one coalesced forward: ``wall_s`` splits across
        ``(tenant, rows, bytes)`` by row share of ``bucket`` (the padded
        batch size); the pad rows' slice books to the bucket's
        ``ledger_pad_seconds_total`` series.  ``compile_s`` (nonzero
        when this forward met a fresh signature) is charged to the HEAD
        tenant — the request that opened the batch missed the cache."""
        if not enabled() or wall_s < 0 or not shares:
            return
        wall_s = float(wall_s)
        total = int(bucket) if bucket else sum(s[1] for s in shares)
        if total <= 0:
            return
        real = 0
        for tenant, units, nbytes in shares:
            m = self._meters(tenant)
            m.device_seconds.inc(wall_s * units / total)
            m.rows.inc(units)
            if nbytes:
                m.bytes.inc(nbytes)
            real += units
        pad = total - real
        if pad > 0:
            self._pad_counter(bucket or total).inc(wall_s * pad / total)
        if compile_s > 0:
            self._meters(shares[0][0]).compile_seconds.inc(compile_s)
        self._engine_counter(plane).inc(wall_s)

    def charge_decode(self, shares: Sequence[tuple[str, int]],
                      wall_s: float, *, compile_s: float = 0.0,
                      nbytes: int = 0) -> None:
        """Charge one decode-engine phase: ``wall_s`` splits across the
        ``(tenant, tokens)`` pairs by tokens emitted (a decode step
        emits one per live slot; a prefill emits its request's first
        token, so its wall is that tenant's alone).  ``nbytes`` rides
        only the single-share (prefill) case — the admitted prompt."""
        if not enabled() or wall_s < 0 or not shares:
            return
        wall_s = float(wall_s)
        total = sum(s[1] for s in shares)
        if total <= 0:
            return
        for tenant, tokens in shares:
            m = self._meters(tenant)
            m.device_seconds.inc(wall_s * tokens / total)
            m.tokens.inc(tokens)
        if nbytes and len(shares) == 1:
            self._meters(shares[0][0]).bytes.inc(nbytes)
        if compile_s > 0:
            self._meters(shares[0][0]).compile_seconds.inc(compile_s)
        self._engine_counter("decode").inc(wall_s)

    def charge_serve(self, model: str, wall_s: float, rows: int, *,
                     compile_s: float = 0.0) -> None:
        """Charge one batch-scoring forward to its model key (the serve
        plane has no tenants; the model is the payer)."""
        if not enabled() or wall_s < 0:
            return
        m = self._meters(str(model))
        m.device_seconds.inc(float(wall_s))
        if rows:
            m.rows.inc(int(rows))
        if compile_s > 0:
            m.compile_seconds.inc(compile_s)
        self._engine_counter("serve").inc(float(wall_s))

    # -- lifecycle / reads ---------------------------------------------------

    def evict_tenant(self, tenant: str) -> None:
        """Drop a removed tenant's labeled series (bounded cardinality:
        the ``_Tenant.evict_metrics`` discipline)."""
        from tensorflowonspark_torch import obs

        with self._lock:
            self._tenants.pop(tenant, None)
        reg = obs.get_registry()
        label = {"tenant": tenant}
        for family in COST_FAMILIES:
            reg.remove(family, label)

    def summary(self) -> dict[str, Any]:
        """JSON-able per-tenant lifetime totals + the engine denominator
        (tests and ``tools/costs.py`` read this; Prometheus carries the
        same numbers as the labeled families)."""
        with self._lock:
            tenants = dict(self._tenants)
            engines = dict(self._engine)
            pads = dict(self._pads)
        doc: dict[str, Any] = {"tenants": {}, "engine_seconds": {},
                               "pad_seconds": {}}
        for name in sorted(tenants):
            m = tenants[name]
            doc["tenants"][name] = {
                "device_seconds": round(m.device_seconds.value, 6),
                "rows": int(m.rows.value),
                "tokens": int(m.tokens.value),
                "bytes": int(m.bytes.value),
                "compile_seconds": round(m.compile_seconds.value, 6),
            }
        for plane in sorted(engines):
            doc["engine_seconds"][plane] = round(
                engines[plane].value, 6)
        for bucket in sorted(pads, key=lambda b: int(b)):
            doc["pad_seconds"][bucket] = round(pads[bucket].value, 6)
        return doc


class GoodputLedger:
    """Training wall-clock phase accounting (module doc).

    The trainer notes its own windows (:meth:`note_step` — first step's
    compute books as ``compile``); checkpoint saves and elastic
    recovery windows arrive via :meth:`note_checkpoint` /
    :meth:`note_recovery`; the feed plane's DataFeed-side stages
    (wait/ingest/collate/stage) are folded in at :meth:`breakdown` time
    from the flight recorder's run totals — existing signals, not new
    instrumentation.  Each noted second also rides the
    ``goodput_seconds_total{phase=}`` counter family so the fleet plane
    federates the breakdown like any other meter.
    """

    def __init__(self, plane: str = "feed"):
        self.plane = plane
        self._lock = threading.Lock()
        self._noted: dict[str, float] = defaultdict(float)
        self._steps = 0
        self._counters: dict[str, Any] = {}

    def _counter(self, phase: str):
        c = self._counters.get(phase)
        if c is None:
            from tensorflowonspark_torch import obs

            with self._lock:
                c = self._counters.get(phase)
                if c is None:
                    c = self._counters[phase] = obs.counter(
                        "goodput_seconds_total",
                        "training wall-clock by goodput phase "
                        "(productive / input_wait / compile / "
                        "checkpoint / recovery / stall)",
                        labels={"phase": phase})
        return c

    def note(self, phase: str, seconds: float) -> None:
        if phase not in GOODPUT_PHASES:
            raise ValueError(f"unknown goodput phase {phase!r} "
                             f"(one of {GOODPUT_PHASES})")
        seconds = float(seconds)
        if seconds <= 0:
            return
        with self._lock:
            self._noted[phase] += seconds
        self._counter(phase).inc(seconds)

    def note_step(self, shard_s: float, compute_s: float,
                  compile: bool | None = None) -> None:
        """One trainer step's own windows.  The FIRST step's compute
        wall carries the jit trace+compile (the ``note_compile``
        first-call discipline), so it books as ``compile``; every later
        step's compute is ``productive``.  ``compile`` given overrides
        that rule: the trainer passes it on a card, where the step that
        captures a CUDA graph is the compile.  The shard/stage half is
        input movement — ``input_wait``."""
        with self._lock:
            first = self._steps == 0
            self._steps += 1
        if compile is None:
            compile = first
        self.note("compile" if compile else "productive", compute_s)
        self.note("input_wait", shard_s)

    def note_checkpoint(self, seconds: float) -> None:
        self.note("checkpoint", seconds)

    def note_recovery(self, seconds: float) -> None:
        self.note("recovery", seconds)

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    def breakdown(self, wall_s: float) -> dict[str, Any]:
        """The wall-clock goodput breakdown for a run that took
        ``wall_s``: noted phases + the feed plane's DataFeed-side flight
        stages, with ``stall`` as the clamped residual (wall nobody
        claimed).  ``stage_sum_s``/``stage_sum_frac`` follow the flight
        breakdown's reconciliation contract — the bench gate fails the
        artifact when the sum drifts past the flight tolerance."""
        from tensorflowonspark_torch.obs import flight

        wall_s = float(wall_s)
        with self._lock:
            phases = {p: self._noted.get(p, 0.0) for p in GOODPUT_PHASES}
        feed = flight.recorder(self.plane).totals()
        for stage in _INPUT_STAGES:
            phases["input_wait"] += feed.get(stage, 0.0)
        accounted = sum(phases.values())
        stall = max(0.0, wall_s - accounted)
        if stall > 0:
            phases["stall"] += stall
            self._counter("stall").inc(stall)
        ssum = sum(phases.values())
        return {
            "wall_s": round(wall_s, 4),
            "stage_sum_s": round(ssum, 4),
            "stage_sum_frac": (round(ssum / wall_s, 4)
                               if wall_s > 0 else None),
            "phases_s": {p: round(v, 4) for p, v in phases.items()},
            "productive_frac": (round(phases["productive"] / wall_s, 4)
                                if wall_s > 0 else None),
            "steps": self.steps,
        }

    def reset(self) -> None:
        """Zero the run-local accumulation (bench runs reset per
        measurement; registry counters are cumulative, unaffected)."""
        with self._lock:
            self._noted.clear()
            self._steps = 0


# -- per-process singletons ---------------------------------------------------

_LEDGER: CostLedger | None = None
_GOODPUT: GoodputLedger | None = None
_SINGLETON_LOCK = threading.Lock()


def get_ledger() -> CostLedger:
    """The process-wide cost ledger (get-or-create)."""
    global _LEDGER
    led = _LEDGER
    if led is None:
        with _SINGLETON_LOCK:
            led = _LEDGER
            if led is None:
                led = _LEDGER = CostLedger()
    return led


def goodput() -> GoodputLedger:
    """The process-wide goodput ledger (get-or-create)."""
    global _GOODPUT
    gp = _GOODPUT
    if gp is None:
        with _SINGLETON_LOCK:
            gp = _GOODPUT
            if gp is None:
                gp = _GOODPUT = GoodputLedger()
    return gp


def reset() -> None:
    """Drop both singletons (test / bench isolation; the next accessor
    mints fresh ones — registry series persist, as instruments do)."""
    global _LEDGER, _GOODPUT
    with _SINGLETON_LOCK:
        _LEDGER = None
        _GOODPUT = None
