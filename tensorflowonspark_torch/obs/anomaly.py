"""Driver-side straggler / stall attribution over shipped node telemetry.

The telemetry already flows: every trainer observes its step times
into a per-process ``trainer_step_seconds`` histogram, the snapshot rides
each ``MetricsReporter`` publication over the TFManager kv blackboard, and
``TFCluster.metrics()`` keeps the **per-node** snapshots (the cluster-wide
merge sums histograms, but ``nodes[<name>]["registry"]`` retains each
node's own buckets).  What was missing is the *judgment*: nothing compared
nodes against each other, so a straggler dragging every collective was
invisible until ``feed_timeout`` (VERDICT r5: "a degraded bench leaves no
per-node timing evidence behind").  Dapper-style attribution (PAPERS.md)
says the system itself should name the slow node.

This module is pure functions over the already-collected aggregate — no
RPCs, safe to run on every metrics-poll tick:

- :func:`hist_quantile` — quantile estimate from Prometheus-style
  cumulative buckets (linear interpolation inside the bucket);
- :func:`step_time_quantiles` — per-node ``{p50, p95, count}`` from a
  ``TFCluster.metrics()`` aggregate;
- :func:`detect` — flags **stragglers** (nodes whose step-time p50/p95
  deviates from the cluster median by more than ``factor``) and **stalled**
  nodes (whose ``trainer_last_step_unix_ts`` gauge has fallen
  ``stall_after_s`` behind the freshest node);
- :func:`stall_events` — extracts ``health.step_stall`` instants (the
  :class:`~tensorflowonspark_torch.health.StepWatchdog`'s last words, shipped
  over the blackboard before its ``os._exit``) from per-node event lists,
  so a watchdog kill becomes an attributed record in the driver's trace
  instead of a bare dead executor.

``TFCluster.check_anomalies()`` wires these to live cluster state, records
each *new* finding as a driver trace event (``anomaly.straggler`` /
``anomaly.stall``), and the train-time metrics poller runs it on every
sample.
"""

from __future__ import annotations

import logging
from typing import Any

logger = logging.getLogger(__name__)

#: histogram instrument whose per-node buckets drive straggler detection
STEP_HISTOGRAM = "trainer_step_seconds"
#: gauge instrument whose per-node staleness drives stall detection
LAST_STEP_GAUGE = "trainer_last_step_unix_ts"
#: trace event name the StepWatchdog emits before hard-exiting
STALL_EVENT = "health.step_stall"
#: span name the trainer records per completed step, carrying the
#: step-scoped trace id findings cite
STEP_SPAN = "trainer.step"


def hist_quantile(buckets: list, q: float) -> float | None:
    """Quantile from cumulative ``[[le, count], ...]`` buckets.

    Linear interpolation within the containing bucket (lower bound = the
    previous finite ``le``, 0 for the first).  A quantile landing in the
    ``+Inf`` bucket returns the last finite bound (the estimate is a floor,
    like Prometheus ``histogram_quantile``).  Returns None on empty data.
    """
    if not buckets:
        return None
    total = buckets[-1][1]
    if not total:
        return None
    rank = q * total
    lo = 0.0
    prev_count = 0
    last_finite = 0.0
    for le, count in buckets:
        bound = float("inf") if le in ("+Inf", float("inf")) else float(le)
        if bound != float("inf"):
            last_finite = bound
        if count >= rank and count > prev_count:
            if bound == float("inf"):
                return last_finite if last_finite else None
            frac = (rank - prev_count) / (count - prev_count)
            return lo + (bound - lo) * frac
        if bound != float("inf"):
            lo = bound
        prev_count = count
    return last_finite or None


def step_time_quantiles(agg: dict[str, Any],
                        histogram: str = STEP_HISTOGRAM
                        ) -> dict[str, dict[str, Any]]:
    """Per-node ``{p50, p95, count}`` from a ``TFCluster.metrics()``
    aggregate (reads each node's own registry snapshot, not the merge)."""
    out: dict[str, dict[str, Any]] = {}
    for node, snap in (agg.get("nodes") or {}).items():
        reg = (snap or {}).get("registry") or {}
        h = (reg.get("histograms") or {}).get(histogram)
        if not h or not h.get("count"):
            continue
        buckets = h.get("buckets") or []
        out[node] = {
            "p50": hist_quantile(buckets, 0.50),
            "p95": hist_quantile(buckets, 0.95),
            "count": h["count"],
        }
    return out


def _median(values: list[float]) -> float:
    vs = sorted(values)
    mid = len(vs) // 2
    return vs[mid] if len(vs) % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def detect(agg: dict[str, Any], *, factor: float = 1.75,
           min_count: int = 5, stall_after_s: float = 60.0,
           now: float | None = None) -> dict[str, Any]:
    """Judge a metrics aggregate; returns an anomaly report.

    ``{"stragglers": [...], "stalled": [...], "quantiles": {...},
    "num_nodes": N}`` — a straggler entry names the node, which quantile
    deviated (p50 and/or p95), its value, the cluster median, and the
    ratio.  Detection needs ≥ 2 nodes with ≥ ``min_count`` recorded steps
    (a single node has no peers to deviate from; a cold node's first steps
    include compile time).  Stall detection compares each node's
    ``trainer_last_step_unix_ts`` gauge against the freshest node (or
    ``now`` when given): training is collective, so one node falling
    ``stall_after_s`` behind while a peer advances is evidence, not noise.
    """
    quantiles = step_time_quantiles(agg)
    eligible = {n: v for n, v in quantiles.items()
                if v["count"] >= min_count and v["p50"]}
    stragglers: list[dict[str, Any]] = []
    if len(eligible) >= 2:
        med = {q: _median([v[q] for v in eligible.values()])
               for q in ("p50", "p95")}
        for node, v in sorted(eligible.items()):
            flagged_q = [q for q in ("p50", "p95")
                         if v[q] and med[q] and v[q] > factor * med[q]]
            if flagged_q:
                stragglers.append({
                    "node": node,
                    "quantiles_flagged": flagged_q,
                    "p50": round(v["p50"], 6), "p95": round(v["p95"], 6),
                    "cluster_p50": round(med["p50"], 6),
                    "cluster_p95": round(med["p95"], 6),
                    "ratio": round(v[flagged_q[0]] / med[flagged_q[0]], 2),
                })
    stalled: list[dict[str, Any]] = []
    last_steps = ((agg.get("registry") or {}).get("gauges") or {}).get(
        LAST_STEP_GAUGE) or {}
    # a node marked stale FINISHED (its manager is gone and TFCluster
    # retained the last snapshot) — an old heartbeat there is a completed
    # run, not a stall; judging it would false-alarm on every uneven-shard
    # job and teach operators to ignore anomaly.stall
    stale_nodes = {n for n, s in (agg.get("nodes") or {}).items()
                   if s and s.get("stale")}
    live_steps = {n: ts for n, ts in last_steps.items()
                  if n not in stale_nodes}
    if live_steps:
        freshest = max(live_steps.values())
        if now is not None:
            freshest = max(freshest, now)
        for node, ts in sorted(live_steps.items()):
            behind = freshest - ts
            if behind > stall_after_s:
                stalled.append({"node": node,
                                "behind_s": round(behind, 1),
                                "last_step_ts": ts})
    return {"stragglers": stragglers, "stalled": stalled,
            "quantiles": quantiles, "num_nodes": len(quantiles)}


def recent_step_traces(events_by_node: dict[str, list[dict]],
                       limit: int = 3) -> dict[str, list[str]]:
    """Per-node step-scoped trace ids, newest first.

    The trainer records each completed step's window as a
    ``trainer.step`` span under its own trace id (shipped with the rest
    of the ring buffer); the last few per node are the *citable* evidence
    a straggler/stall finding attaches — the exact step windows that were
    judged, addressable in the merged Chrome trace by id.
    """
    out: dict[str, list[str]] = {}
    for node, events in sorted((events_by_node or {}).items()):
        ids = [ev.get("trace_id") for ev in events
               if ev.get("name") == STEP_SPAN and ev.get("trace_id")]
        if ids:
            out[node] = ids[-limit:][::-1]
    return out


def cite_step_traces(report: dict[str, Any],
                     events_by_node: dict[str, list[dict]],
                     limit: int = 3) -> dict[str, Any]:
    """Attach ``step_trace_ids`` to each straggler/stalled finding whose
    node shipped ``trainer.step`` spans — the finding then names not just
    *who* is slow but *which step windows* to pull up.  Mutates and
    returns ``report``; nodes without shipped step spans are untouched
    (absence of evidence is not an error)."""
    ids = recent_step_traces(events_by_node, limit=limit)
    for kind in ("stragglers", "stalled"):
        for finding in report.get(kind) or []:
            tids = ids.get(finding.get("node"))
            if tids:
                finding["step_trace_ids"] = tids
    return report


def stall_events(events_by_node: dict[str, list[dict]]) -> list[dict]:
    """Extract the StepWatchdog's shipped stall events, newest last.

    Each entry: ``{"node", "reason", "ts", "stalled_s"}`` — the attributed
    record of a trainer the watchdog hard-exited (the blackboard flush in
    ``StepWatchdog`` runs *before* the ``os._exit``, so the evidence
    survives the process).
    """
    out: list[dict] = []
    for node, events in sorted(events_by_node.items()):
        for ev in events:
            if ev.get("name") != STALL_EVENT:
                continue
            attrs = ev.get("attrs") or {}
            out.append({"node": node,
                        "reason": attrs.get("reason", "step stall"),
                        "ts": ev.get("ts"),
                        "stalled_s": attrs.get("stalled_s")})
    out.sort(key=lambda e: e.get("ts") or 0)
    return out
