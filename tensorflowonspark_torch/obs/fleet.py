"""Fleet observability plane: federated metrics, windowed SLO burn rates,
and load-skew / capacity / compile-cache findings over the serving mesh.

Every observability surface built so far is per-process — each replica's
``/metrics``, ``/healthz`` admission block, flight verdicts and trace
trees end at its own port.  Once the serving tier went horizontal
(:mod:`tensorflowonspark_torch.mesh`), "is the *fleet* healthy, which
replica is hot, and are we burning a tenant's SLO budget" required
hand-scraping N replicas.  This module is the missing rollup — the
production-monitoring layer the TensorFlow system paper (1605.08695)
treats as a first-class subsystem — built as three layers over the
exposition format the replicas already serve:

- **federation** (:class:`FleetCollector`): the mesh router scrapes each
  confirmed replica's ``/metrics`` on its existing health-poll cadence
  (bounded per-replica timeout + one retry; a black-holed replica can
  never stall the router — see :meth:`FleetCollector.scrape`), parses
  the Prometheus text back into a registry snapshot
  (:func:`parse_exposition`), and merges the latest snapshots into ONE
  federated document with a first-class ``replica=`` label
  (:func:`tensorflowonspark_torch.obs.registry.relabel_snapshot`, riding
  the labeled-series machinery) — served as ``GET /fleet/metrics``
  (Prometheus / OpenMetrics, one ``# TYPE`` line per family across
  replica labels) and summarized on ``GET /fleet``;
- **windows**: a bounded time-series ring of snapshots per replica
  turns cumulative instruments into *recent* evidence — counters become
  windowed rates (:meth:`FleetCollector.window`), cumulative histograms
  become windowed p50/p99 (bucket-wise deltas through
  :func:`~tensorflowonspark_torch.obs.anomaly.hist_quantile`).  Lifetime
  totals answer "how much ever"; every judgment below needs "how much
  *now*";
- **judgment**: a declarative multi-window SLO burn-rate engine
  (:class:`Objective` / :func:`evaluate_slo` → structured ``slo.burn``
  findings: a finding fires only when BOTH the fast and the slow window
  burn the error budget past ``burn_threshold`` — the corroboration
  that keeps a latency blip from paging and a long-cleared incident
  from re-paging) and fleet anomaly findings in the
  ``check_anomalies()`` pattern (:func:`check_fleet`):
  ``fleet.load_skew`` (a replica's windowed rows/sec and admission
  saturation vs the fleet median — the exact signal placement
  re-balancing will consume), ``fleet.capacity`` (placed pending-bytes
  vs ``replica_capacity_mb`` headroom — the autoscaling decision
  signal), and ``fleet.compile_cache`` (the compile cache's hit/miss counters
  aggregated, so a replica cold-starting without the persistent cache
  is visible).

The same federation carries the per-tenant cost plane: the
``ledger_*`` families (:mod:`tensorflowonspark_torch.obs.ledger`) roll up
into a windowed per-tenant chargeback document (:func:`cost_summary`,
served as ``GET /fleet/costs``) and a ``fleet.cost_skew`` finding
(:func:`check_costs`): a tenant holding more than
``TFOS_FLEET_COST_SKEW_FRAC`` of the fleet's windowed device-seconds
while another tenant's ``slo.burn`` fires — the throttling decision
signal, since the dominant tenant is spending the hardware the burning
tenant's SLO needs.

Stale evidence never judges: a replica whose last successful scrape is
older than the mesh's fail-open window (``TFOS_MESH_HEALTH_STALE_S``
convention) is excluded from findings — the same discipline the
admission block applies — and its ``fleet_scrape_stale_seconds`` gauge
says exactly how blind the router is.
"""

from __future__ import annotations

import http.client
import logging
import os
import re
import threading
import time
from collections import deque
from typing import Any, Iterable, Mapping, Sequence

from tensorflowonspark_torch.obs import anomaly as _anomaly
from tensorflowonspark_torch.obs import registry as _registry

logger = logging.getLogger(__name__)

#: per-replica snapshot-ring depth (``TFOS_FLEET_RING`` overrides):
#: retention ≈ depth × scrape cadence (DEPLOY "Fleet observability
#: sizing")
DEFAULT_RING_DEPTH = 64
#: default windows for rate/quantile summaries and the skew judgment —
#: a CAP, not a requirement: with fewer scrapes the actual bracketed
#: span is used, so judgments start as soon as two scrapes exist
DEFAULT_WINDOW_S = 30.0
#: hot-replica factor: windowed rows/sec beyond this multiple of the
#: fleet median flags ``fleet.load_skew``
DEFAULT_SKEW_FACTOR = 2.0
#: absolute windowed rows/sec a replica must exceed the median BY before
#: skew is evidence — an idle fleet's noise must not page
DEFAULT_SKEW_MIN_RATE = 1.0
#: placement headroom fraction below which ``fleet.capacity`` fires
#: (1 - placed/capacity < this → the replica is nearly full — the
#: autoscaling decision signal)
DEFAULT_HEADROOM_WARN = 0.25
#: compile-cache warm ratio below which a replica reads as cold
DEFAULT_COLD_WARM_RATIO = 0.5
#: minimum replica uptime before a low warm ratio is a FINDING: a young
#: replica paying its first compiles is an expected cold start (the
#: ``uptime_s`` field online/decode /healthz publishes exists for this)
DEFAULT_COLD_MIN_UPTIME_S = 120.0
#: counter whose windowed rate is the load-skew signal
LOAD_COUNTER = "online_rows_total"
#: fraction of fleet device-seconds one tenant must hold for
#: ``fleet.cost_skew`` to consider it dominant
#: (``TFOS_FLEET_COST_SKEW_FRAC`` overrides)
DEFAULT_COST_SKEW_FRAC = 0.6
#: minimum windowed fleet device-seconds before cost skew is judged —
#: an idle fleet's rounding noise must not name a dominant tenant
DEFAULT_COST_MIN_SECONDS = 0.05

_NAME_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)")


def _split_sample(line: str) -> tuple[str, str, str] | None:
    """``(name, labels_str, value_str)`` of one sample line, or None.

    The label block is scanned quote-aware instead of regexed to the
    first ``}``: Prometheus escapes only backslash/quote/newline in
    label values, so a tenant literally named ``a}b`` is emitted
    verbatim and a ``[^}]*`` match would truncate it — silently
    dropping that tenant's series from every window and SLO judgment.
    """
    m = _NAME_RE.match(line)
    if not m:
        return None
    name, rest = m.group(1), line[m.end():]
    labels_s = ""
    if rest.startswith("{"):
        in_q = esc = False
        end = -1
        for i, ch in enumerate(rest):
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_q = not in_q
            elif ch == "}" and not in_q:
                end = i
                break
        if end < 0:
            return None
        labels_s, rest = rest[:end + 1], rest[end + 1:]
    parts = rest.split()
    if not parts:
        return None
    return name, labels_s, parts[0]


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


_EXEMPLAR_RE = re.compile(
    r"^\{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*)?)\}"
    r"\s+(?P<value>\S+)(?:\s+(?P<ts>\S+))?\s*$")
_EXEMPLAR_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_exemplar(s: str) -> list | None:
    """`` {trace_id="..."} value [ts]`` → the registry's snapshot shape
    ``[labels, value, ts]``; None when malformed (dropped, not fatal)."""
    m = _EXEMPLAR_RE.match(s.strip())
    if m is None:
        return None
    try:
        value = _parse_value(m.group("value"))
        ts = float(m.group("ts")) if m.group("ts") else 0.0
    except ValueError:
        return None
    labels = {k: _registry._unescape(v)
              for k, v in _EXEMPLAR_LABEL_RE.findall(m.group("labels"))}
    return [labels, value, ts]


def parse_exposition(text: str, prefix: str = "tfos_") -> dict[str, Any]:
    """Prometheus text exposition → a registry-snapshot-shaped dict.

    The inverse of :func:`~tensorflowonspark_torch.obs.registry
    .snapshot_to_prometheus` for the documents this codebase emits —
    federation re-speaks the replicas' own wire format, the way
    Prometheus federation scrapes ``/federate``.  ``prefix`` is stripped
    from family names so the parsed snapshot keys match what
    ``Registry.snapshot()`` would produce locally.  Histogram families
    are reassembled from their ``_bucket``/``_sum``/``_count`` samples
    (cumulative buckets, ``le`` kept as ``"+Inf"`` or a float); bucket
    exemplar annotations (`` # {trace_id="..."} value ts``) are RETAINED
    into the snapshot's ``exemplars`` map (federation carries
    the trace link, so a fleet-level ``slo.burn`` finding can name the
    tail request that filled the bucket) — a malformed exemplar is
    dropped, never fatal.  Unknown lines are skipped rather than fatal —
    a scrape must survive a foreign exporter's extensions.
    """
    from tensorflowonspark_torch.obs.httpd import _split_exemplar

    types: dict[str, str] = {}
    snap: dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    hists: dict[str, dict[str, Any]] = {}
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        line, exemplar_s = _split_exemplar(line)
        m = _split_sample(line)
        if m is None:
            continue
        name, labels_s, value_s = m
        try:
            value = _parse_value(value_s)
        except ValueError:
            continue
        _fam, labels = _registry.split_series(name + labels_s)
        base, part = name, None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[: -len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                base, part = cand, suffix
                break
        typ = types.get(base)
        fam = base[len(prefix):] if base.startswith(prefix) else base
        if typ == "histogram":
            hl = dict(labels)
            le = hl.pop("le", None)
            key = _registry.series_key(fam, hl)
            h = hists.setdefault(key, {"buckets": {}, "sum": 0.0,
                                       "count": 0})
            if part == "_bucket" and le is not None:
                bound = "+Inf" if le == "+Inf" else float(le)
                h["buckets"][bound] = value
                if exemplar_s:
                    ex = _parse_exemplar(exemplar_s)
                    if ex is not None:
                        # keyed by the le STRING exactly as the registry
                        # exports it — re-emission and merge round-trip
                        h.setdefault("exemplars", {})[le] = ex
            elif part == "_sum":
                h["sum"] = value
            elif part == "_count":
                h["count"] = int(value)
        elif typ == "counter":
            snap["counters"][_registry.series_key(fam, labels)] = value
        elif typ == "gauge":
            snap["gauges"][_registry.series_key(fam, labels)] = value
        # untyped/summary samples are skipped: nothing downstream can
        # judge a sample whose monotonicity is unknown
    for key, h in hists.items():
        buckets = sorted(
            h["buckets"].items(),
            key=lambda kv: float("inf") if kv[0] == "+Inf" else kv[0])
        doc = {
            "buckets": [[le, int(n)] for le, n in buckets],
            "sum": h["sum"], "count": h["count"]}
        if h.get("exemplars"):
            doc["exemplars"] = h["exemplars"]
        snap["histograms"][key] = doc
    return snap


def _delta_buckets(new: list, old: list | None) -> list | None:
    """Bucket-wise windowed delta of two cumulative bucket lists.

    Returns cumulative buckets covering only the window, or None on a
    counter reset (any bucket went backwards — the replica restarted;
    the window spans two incarnations and cannot be attributed)."""
    old_by_le = {le: n for le, n in (old or [])}
    out = []
    for le, n in new:
        d = n - old_by_le.get(le, 0)
        if d < 0:
            return None
        out.append([le, d])
    return out


class _ReplicaRing:
    """Bounded (ts, snapshot) ring + scrape bookkeeping for one replica."""

    __slots__ = ("ring", "ok_ts", "last_error", "scrapes", "failures")

    def __init__(self, depth: int):
        self.ring: deque = deque(maxlen=depth)
        self.ok_ts = 0.0
        self.last_error: str | None = None
        self.scrapes = 0
        self.failures = 0


def _ring_depth_default() -> int:
    raw = os.environ.get("TFOS_FLEET_RING", "").strip()
    if raw:
        try:
            v = int(raw)
            if v >= 2:
                return v
            logger.warning("TFOS_FLEET_RING=%r below the minimum of 2; "
                           "using default %d", raw, DEFAULT_RING_DEPTH)
        except ValueError:
            logger.warning("TFOS_FLEET_RING=%r unparseable; using default "
                           "%d", raw, DEFAULT_RING_DEPTH)
    return DEFAULT_RING_DEPTH


class FleetCollector:
    """Scrape-side federation: per-replica snapshot rings + windows.

    The router owns one; :meth:`scrape` runs on the health-poll cadence
    (module doc).  All reads (:meth:`window`, :meth:`federated_snapshot`,
    :meth:`stale_seconds`) are lock-protected and cheap enough for a
    ``GET /fleet`` per poll — the expensive parse happens once per
    scrape, never per read.
    """

    def __init__(self, ring_depth: int | None = None,
                 timeout_s: float = 1.5, retries: int = 1,
                 prefix: str = "tfos_"):
        self.ring_depth = (int(ring_depth) if ring_depth is not None
                           else _ring_depth_default())
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.prefix = prefix
        self._rings: dict[str, _ReplicaRing] = {}
        #: ids drop()ped since their last scrape: an IN-FLIGHT scrape of
        #: a just-dropped replica must not resurrect its ring/gauge (the
        #: rid would never be scraped or re-dropped again — an immortal
        #: corpse series); a rid is un-dropped when a scrape tick names
        #: it again (a rejoined replica is wanted again)
        self._dropped: set[str] = set()
        self._lock = threading.Lock()
        from tensorflowonspark_torch import obs

        self._scrapes_total = obs.counter(
            "fleet_scrapes_total", "replica /metrics scrapes attempted")
        self._scrape_failures_total = obs.counter(
            "fleet_scrape_failures_total",
            "replica /metrics scrapes that failed after retries")
        #: per-replica staleness gauges, cached by rid (the scrape loop
        #: must not pay a registry lookup per replica per tick)
        self._stale_gauges: dict[str, Any] = {}

    # -- ingest --------------------------------------------------------------

    def observe(self, replica_id: str, snapshot: Mapping[str, Any],
                ts: float | None = None) -> None:
        """Record one parsed snapshot for ``replica_id`` (the scrape
        target; also the test seam — windows and findings are pure
        functions of what lands here)."""
        now = time.time() if ts is None else float(ts)
        with self._lock:
            if replica_id in self._dropped:
                return  # a drop() raced this scrape: stay dropped
            ring = self._rings.get(replica_id)
            if ring is None:
                ring = self._rings[replica_id] = _ReplicaRing(
                    self.ring_depth)
            ring.ring.append((now, dict(snapshot)))
            ring.ok_ts = now
            ring.last_error = None

    def _fetch_metrics(self, host: str, port: int,
                       timeout: float) -> str:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            # ask for the OpenMetrics flavor: it is the one that carries
            # bucket exemplars, and parse_exposition retains them so the
            # SLO burn engine can name the tail traces behind a finding.
            # A replica that only speaks classic text ignores the header
            # and everything still parses
            conn.request("GET", "/metrics", headers={
                "Accept": "application/openmetrics-text"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"/metrics returned {resp.status}")
            return body.decode("utf-8", "replace")
        finally:
            conn.close()

    def scrape_replica(self, replica_id: str, host: str, port: int,
                       timeout: float | None = None) -> bool:
        """One bounded scrape (+ ``retries`` on failure).  A failure
        leaves the prior snapshots in place — stale-tolerant: the ring
        ages rather than vanishing, and :meth:`stale_seconds` says by
        how much."""
        timeout = self.timeout_s if timeout is None else float(timeout)
        self._scrapes_total.inc()
        with self._lock:
            if replica_id not in self._dropped:
                ring = self._rings.get(replica_id)
                if ring is None:
                    ring = self._rings[replica_id] = _ReplicaRing(
                        self.ring_depth)
                ring.scrapes += 1
        err: str | None = None
        for _attempt in range(1 + self.retries):
            try:
                text = self._fetch_metrics(host, port, timeout)
                snap = parse_exposition(text, prefix=self.prefix)
                self.observe(replica_id, snap)
                return True
            except Exception as e:
                err = f"{type(e).__name__}: {e}"[:200]
        self._scrape_failures_total.inc()
        with self._lock:
            if replica_id in self._dropped:
                return False  # a drop() raced this scrape: stay dropped
            ring = self._rings.get(replica_id)
            if ring is None:
                ring = self._rings[replica_id] = _ReplicaRing(
                    self.ring_depth)
            ring.failures += 1
            ring.last_error = err
        return False

    def scrape(self, replicas: Iterable[tuple[str, str, int]],
               now: float | None = None) -> dict[str, bool]:
        """Scrape every ``(replica_id, host, port)`` CONCURRENTLY;
        refresh the per-replica ``fleet_scrape_stale_seconds`` gauges.

        One thread per replica, the tick joined at the single-replica
        budget ``timeout_s × (1 + retries)`` — so a black-holed replica
        costs its own budget, never the others': a serial loop would
        degrade every healthy replica's scrape cadence (and the
        detection SLA the gate enforces) by 3 s per unhealthy peer.  A
        straggler thread past the join deadline reports failure for
        this tick; its eventual completion lands in the ring normally
        (socket timeouts bound its life)."""
        from tensorflowonspark_torch import obs

        results: dict[str, bool] = {}
        threads: list[threading.Thread] = []
        for rid, host, port in replicas:
            def one(r=rid, h=host, p=port) -> None:
                results[r] = self.scrape_replica(r, h, p)

            t = threading.Thread(target=one, daemon=True,
                                 name=f"tfos-fleet-scrape-{rid}")
            threads.append(t)
            t.start()
        deadline = time.monotonic() \
            + self.timeout_s * (1 + self.retries) + 0.5
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        for rid, _host, _port in replicas:
            results.setdefault(rid, False)
        now = time.time() if now is None else float(now)
        with self._lock:
            # refresh EVERY known ring's gauge, not just this tick's
            # targets: a lost-but-not-yet-regrouped replica leaves the
            # scrape set, and a gauge frozen at its last small value
            # would suppress exactly the blindness alert it exists for
            for rid, ring in self._rings.items():
                g = self._stale_gauges.get(rid)
                if g is None:
                    g = self._stale_gauges[rid] = obs.gauge(
                        "fleet_scrape_stale_seconds",
                        "age of the newest successful /metrics scrape "
                        "per replica (how blind the fleet view is)",
                        labels={"replica": rid})
                g.set(round(now - ring.ok_ts, 3) if ring.ok_ts
                      else -1.0)
        return results

    def drop(self, replica_id: str) -> None:
        """Forget a replica (regrouped away): its ring, its gauge — a
        corpse must not hold a stale series on /fleet/metrics forever.
        The id stays marked dropped until :meth:`undrop` — called by
        the MEMBERSHIP authority (the router's regroup) when the id is
        a member again — so an in-flight scrape that raced this call
        cannot resurrect the ring.  A scrape tick must NOT clear the
        mark itself: its target list may predate the drop."""
        from tensorflowonspark_torch import obs

        with self._lock:
            self._dropped.add(replica_id)
            self._rings.pop(replica_id, None)
            self._stale_gauges.pop(replica_id, None)
        obs.get_registry().remove("fleet_scrape_stale_seconds",
                                  {"replica": replica_id})

    def undrop(self, replica_id: str) -> None:
        """Track ``replica_id`` again (a re-joined member).  Only the
        caller that owns membership should call this — it is the one
        place that knows the id is CURRENTLY wanted, which a scrape
        tick's possibly-stale target list does not."""
        with self._lock:
            self._dropped.discard(replica_id)

    # -- reads ---------------------------------------------------------------

    def replica_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def latest(self, replica_id: str
               ) -> tuple[float, dict[str, Any]] | None:
        with self._lock:
            ring = self._rings.get(replica_id)
            return ring.ring[-1] if ring and ring.ring else None

    def stale_seconds(self, replica_id: str,
                      now: float | None = None) -> float | None:
        """Age of the newest successful scrape; None when never scraped."""
        now = time.time() if now is None else float(now)
        with self._lock:
            ring = self._rings.get(replica_id)
            if ring is None or not ring.ok_ts:
                return None
            return now - ring.ok_ts

    def scrape_health(self) -> dict[str, dict[str, Any]]:
        now = time.time()
        with self._lock:
            return {rid: {
                "stale_s": (round(now - r.ok_ts, 3) if r.ok_ts else None),
                "samples": len(r.ring),
                "scrapes": r.scrapes,
                "failures": r.failures,
                "last_error": r.last_error,
            } for rid, r in sorted(self._rings.items())}

    def window(self, replica_id: str, window_s: float = DEFAULT_WINDOW_S,
               now: float | None = None) -> dict[str, Any] | None:
        """Windowed deltas for one replica over (at most) ``window_s``.

        Returns ``{"span_s", "counters": {series: {"delta", "rate"}},
        "histograms": {series: {"count", "rate", "p50", "p99"}}}`` from
        the oldest and newest ring entries inside the window — the span
        actually bracketed, so judgments start the moment TWO scrapes
        exist instead of waiting a full window.  None until then.
        Counter resets (a restarted replica) skip the series for this
        window rather than inventing a negative rate.
        """
        now = time.time() if now is None else float(now)
        with self._lock:
            ring = self._rings.get(replica_id)
            entries = list(ring.ring) if ring else []
        entries = [e for e in entries if e[0] >= now - window_s]
        if len(entries) < 2:
            return None
        (t0, old), (t1, new) = entries[0], entries[-1]
        span = t1 - t0
        if span <= 0:
            return None
        counters: dict[str, Any] = {}
        for series, v in (new.get("counters") or {}).items():
            prev = (old.get("counters") or {}).get(series, 0.0)
            d = v - prev
            if d < 0:
                continue  # reset mid-window: unattributable
            counters[series] = {"delta": d, "rate": d / span}
        hists: dict[str, Any] = {}
        for series, h in (new.get("histograms") or {}).items():
            oldh = (old.get("histograms") or {}).get(series)
            db = _delta_buckets(h.get("buckets") or [],
                                (oldh or {}).get("buckets"))
            if db is None:
                continue  # reset mid-window
            count = db[-1][1] if db else 0
            hists[series] = {
                "count": count,
                "rate": count / span,
                "p50": _anomaly.hist_quantile(db, 0.50),
                "p99": _anomaly.hist_quantile(db, 0.99),
                # the windowed cumulative buckets themselves: what
                # fleet_window sums across replicas — re-reading the
                # ring there would race a concurrent drop()
                "buckets": db,
            }
        return {"span_s": span, "from_ts": t0, "to_ts": t1,
                "counters": counters, "histograms": hists}

    def fleet_window(self, window_s: float = DEFAULT_WINDOW_S,
                     now: float | None = None,
                     fresh_within_s: float | None = None
                     ) -> dict[str, Any]:
        """Fleet-summed window: counter deltas summed, histogram delta
        buckets summed bucket-wise (then quantiled) across replicas
        whose newest scrape is fresher than ``fresh_within_s`` (None =
        all).  Rates are the SUM of per-replica rates (each over its
        own bracketed span — dividing the summed deltas by one shared
        span would dilute a short-span replica's burst).  Returns the
        same shape as :meth:`window` plus ``"replicas"`` (the ids that
        contributed); ``span_s`` is the longest contributing span."""
        now = time.time() if now is None else float(now)
        counters: dict[str, float] = {}
        counter_rates: dict[str, float] = {}
        spans: list[float] = []
        hbuckets: dict[str, dict] = {}
        hsums: dict[str, int] = {}
        hrates: dict[str, float] = {}
        contributed: list[str] = []
        for rid in self.replica_ids():
            if fresh_within_s is not None:
                age = self.stale_seconds(rid, now)
                if age is None or age > fresh_within_s:
                    continue
            w = self.window(rid, window_s, now)
            if w is None:
                continue
            contributed.append(rid)
            spans.append(w["span_s"])
            for series, c in w["counters"].items():
                counters[series] = counters.get(series, 0.0) + c["delta"]
                counter_rates[series] = (counter_rates.get(series, 0.0)
                                         + c["rate"])
            # sum each replica's windowed delta buckets bucket-wise so
            # the fleet p99 is a real quantile of the UNION, not an
            # average of per-replica quantiles — from the window()
            # result itself (re-reading the ring here would race a
            # concurrent drop() into an IndexError mid-regroup)
            for series, h in w["histograms"].items():
                db = h.get("buckets") or []
                agg = hbuckets.setdefault(series, {})
                for le, n in db:
                    agg[le] = agg.get(le, 0) + n
                hsums[series] = hsums.get(series, 0) + h["count"]
                hrates[series] = hrates.get(series, 0.0) + h["rate"]
        span = max(spans) if spans else 0.0
        hists: dict[str, Any] = {}
        for series, agg in hbuckets.items():
            buckets = sorted(
                agg.items(),
                key=lambda kv: float("inf") if kv[0] == "+Inf"
                else kv[0])
            db = [[le, n] for le, n in buckets]
            count = hsums.get(series, 0)
            hists[series] = {
                "count": count,
                "rate": hrates.get(series, 0.0),
                "p50": _anomaly.hist_quantile(db, 0.50),
                "p99": _anomaly.hist_quantile(db, 0.99),
                "buckets": db,
            }
        out_counters = {
            series: {"delta": d, "rate": counter_rates.get(series, 0.0)}
            for series, d in counters.items()}
        return {"span_s": span, "replicas": contributed,
                "counters": out_counters, "histograms": hists}

    # -- federation ----------------------------------------------------------

    def federated_snapshot(
            self, extra: Mapping[str, Mapping[str, Any]] | None = None
    ) -> dict[str, Any]:
        """Latest snapshot per replica, each relabeled with
        ``replica=<id>``, merged into ONE snapshot dict.  ``extra`` adds
        non-scraped members (e.g. the router's own registry under
        ``replica="router"``), relabeled WITHOUT overriding existing
        ``replica=`` labels: the extras are the federator's own trusted
        registry, whose per-replica series (the scrape-staleness
        gauges) must stay per-replica — scraped snapshots, by contrast,
        are always overridden so a replica cannot spoof another's
        series.  The whole fleet is one document with one ``# TYPE``
        line per family."""
        merged: dict[str, Any] = {"counters": {}, "gauges": {},
                                  "histograms": {}}
        parts: list[tuple[str, Mapping[str, Any], bool]] = []
        for rid in self.replica_ids():
            latest = self.latest(rid)
            if latest is not None:
                parts.append((rid, latest[1], True))
        for rid, snap in (extra or {}).items():
            parts.append((rid, snap, False))
        for rid, snap, override in parts:
            rl = _registry.relabel_snapshot(snap, {"replica": rid},
                                            override=override)
            for section in ("counters", "gauges", "histograms"):
                merged[section].update(rl.get(section) or {})
        return merged

    def to_prometheus(self, extra=None, prefix: str = "tfos_") -> str:
        return _registry.snapshot_to_prometheus(
            self.federated_snapshot(extra), prefix=prefix)

    def to_openmetrics(self, extra=None, prefix: str = "tfos_") -> str:
        return _registry.snapshot_to_openmetrics(
            self.federated_snapshot(extra), prefix=prefix)


def merge_family_hists(hists: Mapping[str, Any],
                       family: str) -> dict[str, Any] | None:
    """Sum a window's histogram series of one FAMILY across label sets
    (``online_request_seconds{tenant=…}`` is one series per tenant —
    a replica-level latency quantile needs their union), bucket-wise so
    the result is a real quantile.  None when the family is absent."""
    agg: dict[Any, int] = {}
    count = 0
    for series, h in (hists or {}).items():
        fam, _lab = _registry.split_series(series)
        if fam != family:
            continue
        for le, n in h.get("buckets") or []:
            agg[le] = agg.get(le, 0) + n
        count += h.get("count", 0)
    if not agg:
        return None
    db = [[le, n] for le, n in sorted(
        agg.items(),
        key=lambda kv: float("inf") if kv[0] == "+Inf" else kv[0])]
    return {"count": count,
            "p50": _anomaly.hist_quantile(db, 0.50),
            "p99": _anomaly.hist_quantile(db, 0.99),
            "buckets": db}


# ---------------------------------------------------------------------------
# declarative SLO engine: multi-window burn rates
# ---------------------------------------------------------------------------

#: signal name → how to read it from the windowed fleet evidence
SLO_SIGNALS = ("latency", "ttft", "itl", "shed_rate", "error_rate")


class Objective:
    """One declarative SLO objective, judged as a multi-window burn rate.

    ``signal`` picks the evidence:

    - ``"latency"`` — the per-tenant request-latency histogram
      (``online_request_seconds{tenant=}``); ``threshold_ms`` is the
      latency objective, ``budget`` the allowed fraction of requests
      over it (e.g. 0.01 = "99% under threshold");
    - ``"ttft"`` / ``"itl"`` — the decode tier's TTFT / inter-token
      histograms, same semantics;
    - ``"shed_rate"`` — shed ÷ offered from the per-tenant counters
      (fleet-wide totals when ``tenant`` is None); ``budget`` is the
      allowed shed fraction;
    - ``"error_rate"`` — errors ÷ requests from the server-wide
      counters.

    Burn rate = (bad fraction over the window) ÷ ``budget``; the finding
    fires only when burn ≥ ``burn_threshold`` in BOTH the fast and the
    slow window with ≥ ``min_events`` fast-window events — the
    fast window gives detection latency, the slow window corroborates
    that the budget is genuinely burning (not one blip), and a cleared
    incident stops firing as soon as the fast window rolls past it
    (DEPLOY "Fleet observability sizing").

    Latency thresholds quantize UP to the histogram's bucket bounds
    (the good-count is read at the smallest ``le`` ≥ the threshold):
    pick thresholds at bucket bounds for exact semantics.
    """

    def __init__(self, name: str, *, signal: str,
                 tenant: str | None = None,
                 threshold_ms: float | None = None,
                 budget: float = 0.01,
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 2.0,
                 min_events: int = 20):
        if signal not in SLO_SIGNALS:
            raise ValueError(f"unknown SLO signal {signal!r} "
                             f"(one of {SLO_SIGNALS})")
        if signal in ("latency", "ttft", "itl") and threshold_ms is None:
            raise ValueError(f"{signal!r} objectives need threshold_ms")
        if tenant is not None and signal in ("ttft", "itl",
                                             "error_rate"):
            # these instruments are per-PROCESS, not per-tenant: a
            # tenant filter would be silently ignored and the objective
            # would judge fleet-wide traffic under a tenant's name
            raise ValueError(
                f"{signal!r} objectives are fleet-wide (the underlying "
                "instrument carries no tenant label); drop tenant= or "
                "use a 'latency'/'shed_rate' objective")
        if not 0 < budget < 1:
            raise ValueError("budget must be a fraction in (0, 1)")
        if fast_window_s >= slow_window_s:
            raise ValueError("fast_window_s must be shorter than "
                             "slow_window_s (the corroboration window)")
        self.name = str(name)
        self.signal = signal
        self.tenant = tenant
        self.threshold_ms = (float(threshold_ms)
                             if threshold_ms is not None else None)
        self.budget = float(budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_events = int(min_events)

    def to_doc(self) -> dict[str, Any]:
        return {"name": self.name, "signal": self.signal,
                "tenant": self.tenant, "threshold_ms": self.threshold_ms,
                "budget": self.budget,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "burn_threshold": self.burn_threshold,
                "min_events": self.min_events}


_SIGNAL_HISTS = {
    "latency": ("online_request_seconds", True),
    "ttft": ("decode_ttft_seconds", False),
    "itl": ("decode_itl_seconds", False),
}
_SIGNAL_COUNTERS = {
    # (bad family, total family, tenant-labeled)
    "shed_rate": ("online_tenant_shed_total",
                  "online_tenant_requests_total", True),
    "error_rate": ("online_errors_total", "online_requests_total", False),
}


def _bad_fraction(obj: Objective, fw: dict[str, Any]
                  ) -> tuple[float | None, float]:
    """(bad fraction, events) of one objective over one fleet window;
    bad fraction is None when the window carries no evidence."""
    if obj.signal in _SIGNAL_HISTS:
        fam, labeled = _SIGNAL_HISTS[obj.signal]
        if labeled and obj.tenant:
            series = _registry.series_key(fam, {"tenant": obj.tenant})
            h = (fw.get("histograms") or {}).get(series)
        else:
            # no tenant filter: the family's union across label sets —
            # a bare-name lookup would silently never judge, because
            # the online tier always tenant-labels its latency series
            h = merge_family_hists(fw.get("histograms"), fam)
        if not h or not h.get("count"):
            return None, 0.0
        total = float(h["count"])
        thresh_s = obj.threshold_ms / 1000.0
        good = 0.0
        for le, n in h.get("buckets") or []:
            bound = float("inf") if le == "+Inf" else float(le)
            if bound >= thresh_s:
                good = float(n)
                break
        return max(0.0, 1.0 - good / total), total
    fam_bad, fam_total, labeled = _SIGNAL_COUNTERS[obj.signal]
    labels = {"tenant": obj.tenant} if labeled and obj.tenant else None
    if obj.signal == "shed_rate" and obj.tenant is None:
        fam_bad, fam_total, labels = ("online_shed_total",
                                      "online_requests_total", None)
    counters = fw.get("counters") or {}
    bad = (counters.get(_registry.series_key(fam_bad, labels))
           or {}).get("delta", 0.0)
    total = (counters.get(_registry.series_key(fam_total, labels))
             or {}).get("delta", 0.0)
    # sheds are refused OFFERS: the offered volume is served + shed
    offered = total + (bad if obj.signal == "shed_rate" else 0.0)
    if offered <= 0:
        return None, 0.0
    return bad / offered, offered


def burn_exemplars(collector: FleetCollector, obj: Objective,
                   cap: int = 5) -> list[dict[str, Any]]:
    """Exemplar trace links behind one burning latency objective.

    Reads each replica's LATEST scraped snapshot (the ring head — the
    windowed deltas carry counts, not exemplars) and collects the
    objective family's bucket exemplars whose observed value actually
    breached the threshold, newest first, capped at ``cap``.  Every
    exemplar the registry records rides a RETAINED trace (the emitters'
    retained-only rule), so each ``trace_id`` here resolves on the
    owning replica's ``/debug/requests``.  Counter signals (shed/error
    rate) have no exemplars — empty list."""
    if obj.signal not in _SIGNAL_HISTS:
        return []
    fam, labeled = _SIGNAL_HISTS[obj.signal]
    thresh_s = (obj.threshold_ms or 0.0) / 1000.0
    out: list[dict[str, Any]] = []
    for rid in collector.replica_ids():
        latest = collector.latest(rid)
        if latest is None:
            continue
        for series, h in (latest[1].get("histograms") or {}).items():
            name, labels = _registry.split_series(series)
            if name != fam:
                continue
            if labeled and obj.tenant \
                    and labels.get("tenant") != obj.tenant:
                continue
            for _le_s, ex in (h.get("exemplars") or {}).items():
                try:
                    ex_labels, value, ts = ex
                    value = float(value)
                except (TypeError, ValueError):
                    continue
                tid = (ex_labels or {}).get("trace_id")
                if not tid or value <= thresh_s:
                    continue
                out.append({"trace_id": tid, "replica": rid,
                            "value_ms": round(value * 1000, 3),
                            "ts": ts})
    out.sort(key=lambda e: -(e.get("ts") or 0.0))
    return out[:cap]


def evaluate_slo(collector: FleetCollector,
                 objectives: Sequence[Objective],
                 now: float | None = None,
                 fresh_within_s: float | None = None
                 ) -> list[dict[str, Any]]:
    """Judge every objective over its fast AND slow windows; returns the
    ``slo.burn`` findings that fired (module doc: both windows must
    burn — the corroboration requirement).  A latency-signal finding
    carries an ``exemplars`` list (:func:`burn_exemplars`) when the
    scraped snapshots hold breaching bucket exemplars — the link from
    the alert straight to the tail-sampled trace trees."""
    now = time.time() if now is None else float(now)
    findings: list[dict[str, Any]] = []
    windows: dict[float, dict[str, Any]] = {}

    def fw(window_s: float) -> dict[str, Any]:
        if window_s not in windows:
            windows[window_s] = collector.fleet_window(
                window_s, now=now, fresh_within_s=fresh_within_s)
        return windows[window_s]

    for obj in objectives:
        fast_bad, fast_events = _bad_fraction(obj, fw(obj.fast_window_s))
        slow_bad, _slow_events = _bad_fraction(obj, fw(obj.slow_window_s))
        if fast_bad is None or slow_bad is None:
            continue
        if fast_events < obj.min_events:
            continue
        burn_fast = fast_bad / obj.budget
        burn_slow = slow_bad / obj.budget
        if burn_fast >= obj.burn_threshold \
                and burn_slow >= obj.burn_threshold:
            exemplars = burn_exemplars(collector, obj)
            findings.append({
                "finding": "slo.burn",
                "objective": obj.name,
                "tenant": obj.tenant,
                "signal": obj.signal,
                "threshold_ms": obj.threshold_ms,
                "budget": obj.budget,
                "burn_fast": round(burn_fast, 3),
                "burn_slow": round(burn_slow, 3),
                "bad_frac_fast": round(fast_bad, 4),
                "bad_frac_slow": round(slow_bad, 4),
                "events_fast": fast_events,
                "fast_window_s": obj.fast_window_s,
                "slow_window_s": obj.slow_window_s,
                "burn_threshold": obj.burn_threshold,
                # added only when present: the exemplar-free finding
                # shape is unchanged for existing consumers
                **({"exemplars": exemplars} if exemplars else {}),
            })
    return findings


# ---------------------------------------------------------------------------
# fleet anomaly findings (the check_anomalies() pattern)
# ---------------------------------------------------------------------------


#: the one median (anomaly.py's straggler judgment uses the same):
#: a tie-break change must affect both judgments or neither
_median = _anomaly._median


def check_fleet(collector: FleetCollector, *,
                placements: Mapping[str, Mapping[str, Any]] | None = None,
                healths: Mapping[str, Mapping[str, Any]] | None = None,
                window_s: float = DEFAULT_WINDOW_S,
                skew_factor: float = DEFAULT_SKEW_FACTOR,
                skew_min_rate: float = DEFAULT_SKEW_MIN_RATE,
                headroom_warn: float = DEFAULT_HEADROOM_WARN,
                cold_warm_ratio: float = DEFAULT_COLD_WARM_RATIO,
                cold_min_uptime_s: float = DEFAULT_COLD_MIN_UPTIME_S,
                fresh_within_s: float | None = None,
                now: float | None = None) -> dict[str, Any]:
    """Fleet-level anomaly judgment over the windowed evidence.

    Pure function of the collector's rings plus router-side context:
    ``placements`` maps ``replica_id → {"placed_bytes",
    "capacity_bytes"}`` (the placement arithmetic only the router
    knows), ``healths`` maps ``replica_id → /healthz doc`` (admission
    saturation + compile-cache block from the existing poll).  Replicas
    whose scrape is staler than ``fresh_within_s`` are excluded — stale
    evidence never judges (fail-open, the admission discipline).

    Returns ``{"load_skew": [...], "capacity": [...],
    "compile_cache": [...], "replicas_judged": [...], "window_s"}``.
    """
    now = time.time() if now is None else float(now)
    placements = placements or {}
    healths = healths or {}
    fresh: list[str] = []
    for rid in collector.replica_ids():
        age = collector.stale_seconds(rid, now)
        if age is None:
            continue
        if fresh_within_s is not None and age > fresh_within_s:
            continue
        fresh.append(rid)

    def admission_of(rid: str) -> dict[str, Any]:
        block = (healths.get(rid) or {}).get("admission")
        return block if isinstance(block, dict) else {}

    # -- hot-replica load skew ----------------------------------------------
    rates: dict[str, float] = {}
    for rid in fresh:
        w = collector.window(rid, window_s, now)
        if w is None:
            continue
        rates[rid] = (w["counters"].get(LOAD_COUNTER)
                      or {}).get("rate", 0.0)
    load_skew: list[dict[str, Any]] = []
    if len(rates) >= 2:
        sat_by_rid = {rid: admission_of(rid).get("saturation")
                      for rid in rates}
        sat_values = [s for s in sat_by_rid.values()
                      if isinstance(s, (int, float))]
        sat_med = _median(sat_values) if sat_values else None
        for rid in sorted(rates):
            rate = rates[rid]
            # leave-one-out median: a median that includes the hot
            # replica can never be exceeded by skew_factor in a
            # two-replica fleet (hot > 2·(hot+cold)/2 is impossible) —
            # each replica is judged against its PEERS' median
            med = _median([v for r2, v in rates.items() if r2 != rid])
            if rate < skew_min_rate or rate - med < skew_min_rate:
                continue
            if rate <= skew_factor * med:
                continue
            load_skew.append({
                "finding": "fleet.load_skew",
                "replica": rid,
                "rows_per_sec": round(rate, 2),
                "fleet_median_rows_per_sec": round(med, 2),
                "ratio": (round(rate / med, 2) if med else None),
                "saturation": sat_by_rid.get(rid),
                "fleet_median_saturation": sat_med,
                "window_s": window_s,
            })

    # -- capacity headroom (the autoscaling decision signal) ----------------
    capacity: list[dict[str, Any]] = []
    for rid in sorted(placements):
        p = placements[rid]
        cap = p.get("capacity_bytes") or 0
        placed = p.get("placed_bytes") or 0
        if not cap:
            continue
        headroom = 1.0 - placed / cap
        if headroom >= headroom_warn:
            continue
        adm = admission_of(rid)
        # decode replicas publish paged-KV residency next to saturation
        # (the placement-by-KV-bytes signal): the capacity finding carries
        # it so an autoscaler sees byte pressure AND page pressure in one
        # document.  bytes_resident counts UNIQUE physical pages — the
        # prefix-sharing win is already netted out.
        kv = adm.get("kv")
        kv = kv if isinstance(kv, dict) else {}
        capacity.append({
            "finding": "fleet.capacity",
            "replica": rid,
            "placed_bytes": int(placed),
            "capacity_bytes": int(cap),
            "headroom_frac": round(headroom, 4),
            "pending_bytes": adm.get("pending_bytes"),
            "max_pending_bytes": adm.get("max_pending_bytes"),
            "saturation": adm.get("saturation"),
            "kv_bytes_resident": kv.get("bytes_resident"),
            "kv_occupancy": kv.get("occupancy"),
        })

    # -- compile-cache effectiveness (fleet cold-start visibility) ----------
    compile_cache: list[dict[str, Any]] = []
    fleet_hits = fleet_misses = 0.0
    cc_by_rid: dict[str, dict[str, Any]] = {}
    for rid in fresh:
        latest = collector.latest(rid)
        counters = (latest[1].get("counters") or {}) if latest else {}
        hits = (counters.get("serving_compile_cache_hits_total", 0.0)
                + counters.get("serving_compile_cache_disk_hits_total",
                               0.0))
        misses = counters.get("serving_compile_cache_misses_total", 0.0)
        fleet_hits += hits
        fleet_misses += misses
        cc_by_rid[rid] = {"hits": hits, "misses": misses}
    fleet_total = fleet_hits + fleet_misses
    fleet_warm = fleet_hits / fleet_total if fleet_total else None
    for rid in sorted(cc_by_rid):
        health = healths.get(rid) or {}
        cc_health = health.get("compile_cache")
        cc_health = cc_health if isinstance(cc_health, dict) else {}
        warm = cc_health.get("warm_ratio")
        if warm is None:
            c = cc_by_rid[rid]
            total = c["hits"] + c["misses"]
            warm = c["hits"] / total if total else None
        if warm is None or warm >= cold_warm_ratio:
            continue
        # a YOUNG replica paying its first compiles is an expected cold
        # start, not a finding — otherwise every routine rollout pages;
        # unknown uptime (no health doc) stays judged
        uptime = health.get("uptime_s")
        if isinstance(uptime, (int, float)) \
                and uptime < cold_min_uptime_s:
            continue
        persistent = cc_health.get("dir")
        compile_cache.append({
            "finding": "fleet.compile_cache",
            "replica": rid,
            "warm_ratio": round(float(warm), 4),
            "fleet_warm_ratio": (round(fleet_warm, 4)
                                 if fleet_warm is not None else None),
            "true_misses": int(cc_by_rid[rid]["misses"]),
            "persistent_dir": persistent,
            "hint": ("no persistent compile cache configured: every "
                     "replica (re)pays its own compiles — set "
                     "TFOS_COMPILE_CACHE_DIR to a shared fs"
                     if not persistent else
                     "cold replica: first requests are paying compiles "
                     "or disk loads"),
        })

    return {"load_skew": load_skew, "capacity": capacity,
            "compile_cache": compile_cache,
            "replicas_judged": fresh, "window_s": window_s}


# ---------------------------------------------------------------------------
# per-tenant cost federation
# ---------------------------------------------------------------------------

#: tenant-labeled cost counter family → the summary field it fills
_COST_FIELDS = {
    "ledger_device_seconds_total": "device_seconds",
    "ledger_rows_total": "rows",
    "ledger_tokens_total": "tokens",
    "ledger_bytes_total": "bytes",
    "ledger_compile_seconds_total": "compile_seconds",
}


def cost_skew_frac_default() -> float:
    """``TFOS_FLEET_COST_SKEW_FRAC`` (a fraction in (0, 1]) or the
    module default."""
    raw = os.environ.get("TFOS_FLEET_COST_SKEW_FRAC", "").strip()
    if raw:
        try:
            v = float(raw)
            if 0 < v <= 1:
                return v
            logger.warning("TFOS_FLEET_COST_SKEW_FRAC=%r out of (0, 1]; "
                           "using default %s", raw,
                           DEFAULT_COST_SKEW_FRAC)
        except ValueError:
            logger.warning("TFOS_FLEET_COST_SKEW_FRAC=%r unparseable; "
                           "using default %s", raw,
                           DEFAULT_COST_SKEW_FRAC)
    return DEFAULT_COST_SKEW_FRAC


def cost_summary(collector: FleetCollector,
                 window_s: float = DEFAULT_WINDOW_S,
                 now: float | None = None,
                 fresh_within_s: float | None = None) -> dict[str, Any]:
    """Windowed per-tenant cost rollup over the federated ledgers.

    Sums each replica's windowed deltas of the ``ledger_*`` families
    (:mod:`tensorflowonspark_torch.obs.ledger`) across the fleet: who
    spent how many device-seconds / rows / tokens / bytes / compile
    seconds in the last window, each tenant's ``share`` of the
    apportioned total, plus the un-apportioned engine denominator per
    plane and the pad-waste seconds per bucket choice.  Pure read of
    the collector's rings — the ``GET /fleet/costs`` body's core.
    """
    fw = collector.fleet_window(window_s, now=now,
                                fresh_within_s=fresh_within_s)
    tenants: dict[str, dict[str, float]] = {}
    engine: dict[str, float] = {}
    pads: dict[str, float] = {}
    for series, c in (fw.get("counters") or {}).items():
        fam, labels = _registry.split_series(series)
        field = _COST_FIELDS.get(fam)
        if field is not None:
            tenant = labels.get("tenant", "_unlabeled")
            doc = tenants.setdefault(tenant, {})
            doc[field] = doc.get(field, 0.0) + c["delta"]
        elif fam == "ledger_engine_seconds_total":
            plane = labels.get("plane", "_unlabeled")
            engine[plane] = engine.get(plane, 0.0) + c["delta"]
        elif fam == "ledger_pad_seconds_total":
            bucket = labels.get("bucket", "_unlabeled")
            pads[bucket] = pads.get(bucket, 0.0) + c["delta"]
    total_device = sum(t.get("device_seconds", 0.0)
                       for t in tenants.values())
    out_tenants: dict[str, Any] = {}
    for name in sorted(tenants):
        t = tenants[name]
        out_tenants[name] = {
            "device_seconds": round(t.get("device_seconds", 0.0), 6),
            "rows": int(t.get("rows", 0)),
            "tokens": int(t.get("tokens", 0)),
            "bytes": int(t.get("bytes", 0)),
            "compile_seconds": round(t.get("compile_seconds", 0.0), 6),
            "share": (round(t.get("device_seconds", 0.0)
                            / total_device, 4)
                      if total_device > 0 else None),
        }
    return {
        "window_s": window_s,
        "span_s": round(fw.get("span_s", 0.0), 3),
        "replicas": fw.get("replicas") or [],
        "tenants": out_tenants,
        "device_seconds_total": round(total_device, 6),
        "engine_seconds": {p: round(v, 6)
                           for p, v in sorted(engine.items())},
        "pad_seconds": {b: round(v, 6)
                        for b, v in sorted(pads.items())},
    }


def check_costs(collector: FleetCollector, *,
                burns: Sequence[Mapping[str, Any]] | None = None,
                window_s: float = DEFAULT_WINDOW_S,
                skew_frac: float | None = None,
                min_seconds: float = DEFAULT_COST_MIN_SECONDS,
                fresh_within_s: float | None = None,
                now: float | None = None) -> list[dict[str, Any]]:
    """``fleet.cost_skew`` findings: a tenant holding more than
    ``skew_frac`` of the fleet's windowed device-seconds while ANOTHER
    tenant's ``slo.burn`` finding fires (``burns`` — the throttling
    decision signal: the dominant tenant is spending the hardware the
    burning tenant's SLO needs).  A dominant tenant with no one burning
    is just busy — not a finding; a fleet below ``min_seconds`` of
    windowed device time is too idle to judge."""
    skew_frac = (cost_skew_frac_default() if skew_frac is None
                 else float(skew_frac))
    summary = cost_summary(collector, window_s, now=now,
                           fresh_within_s=fresh_within_s)
    total = summary["device_seconds_total"]
    if total < min_seconds:
        return []
    burning = {}
    for b in burns or ():
        t = b.get("tenant")
        if t is not None and t not in burning:
            burning[t] = b.get("objective")
    if not burning:
        return []
    findings: list[dict[str, Any]] = []
    for name, doc in summary["tenants"].items():
        share = doc.get("share")
        if share is None or share <= skew_frac:
            continue
        victims = sorted(t for t in burning if t != name)
        if not victims:
            continue
        findings.append({
            "finding": "fleet.cost_skew",
            "tenant": name,
            "share": share,
            "device_seconds": doc["device_seconds"],
            "fleet_device_seconds": total,
            "burning_tenants": victims,
            "objective": burning[victims[0]],
            "skew_frac": skew_frac,
            "window_s": window_s,
        })
    return findings
