"""Pipeline flight recorder: per-stage time attribution + bottleneck verdicts.

PRs 3 and 5 rebuilt both hot data planes and proved 3.4-4.6x with end-to-end
rows/sec — but a rows/sec figure cannot tell a feed-starved step from a
compute-bound one, which is exactly the distinction the MPI characterization
literature (arXiv:1603.02339, arXiv:1810.11112) used to justify overlap
designs: stage-level time attribution, not aggregate throughput, names the
bottleneck.  This module is that attribution layer, always on and cheap
enough to leave on:

- **recorders** (:func:`recorder`): one :class:`FlightRecorder` per
  pipeline *plane* per process.  The instrumented planes:

  - ``"feed"`` — the SPARK-mode training feed consumed in the trainer
    process: ``wait`` (blocked on the TFManager queue / prefetch pump),
    ``ingest`` (shm read + chunk intake), ``collate`` (column
    concatenation + mapping), ``stage`` (an in-feed ``device_put``),
    ``shard`` (the trainer's own shard call), ``compute`` (the jitted
    step dispatch), ``allreduce`` (the bucketed gradient exchange —
    modelled against the roofline's delivered ICI bandwidth; always
    recorded ``_bg``: a model is an upper bound on exposed comm and
    must not name the bottleneck — the measured ``comm_bound`` verdict
    comes from bench's step-collectives A/B, which times a no-reduce
    twin).  ``TFNode.DataFeed`` adds the wait/ingest/
    collate/stage parts, ``trainer.Trainer`` adds shard/compute/
    allreduce and commits one record per step — every stage name is
    recorded by exactly one call site, so each histogram stays one
    observation per batch.
  - ``"serve"`` — the bucketed serving plane in ``pipeline._RunModel``:
    ``ingest``/``pad``/``stage`` on the prefetch pump (overlapped),
    ``wait``/``compute``/``emit`` on the consumer; ``emit`` includes the
    generator-suspension time while the downstream consumer drains rows,
    so a slow consumer shows up as emit-bound.
  - ``"feeder"`` — the Spark-task side of the training feed
    (``TFSparkNode._TrainFn``): ``encode`` (columnarize + shm write) and
    ``backpressure`` (blocked in the manager queue ``put`` — the
    byte-bound back-pressure signal).
  - ``"online"`` — the continuous-batching online serving tier
    (``tensorflowonspark_torch.online.OnlineServer``): ``coalesce``/``pad``
    on the coalescer thread (always overlapped — it is its own thread at
    any prefetch depth), ``wait``/``compute``/``reply`` on the compute
    thread —
    ``wait`` is blocked-on-the-coalescer (no requests / deadline not
    reached), ``reply`` is the per-row scatter back to waiting callers.

- **verdicts** (:func:`classify`): each committed record is classified
  from its stage shares into ``feed_starved`` / ``device_bound`` /
  ``emit_bound`` / ``queue_backpressured`` / ``ingest_bound`` /
  ``balanced``.  Overlapped stages (recorded with ``overlapped=True``,
  stored under a ``_bg`` suffix) ran on a pump thread concurrently with
  the critical path and are excluded from classification and from the
  additive stage sum.

- **export**: every stage observation lands in a registry histogram
  (``flight_<plane>_<stage>_seconds``) and every verdict in a counter
  (``flight_<plane>_verdict_<verdict>_total``), so the attribution rides
  the existing MetricsReporter publications to the driver, where
  :func:`report_from_metrics` renders the per-node breakdown behind the
  ``/pipeline`` endpoint and :func:`detect_feed_starvation` feeds
  ``TFCluster.check_anomalies()``.  ``bench.py`` stamps
  :meth:`FlightRecorder.breakdown` into every artifact, and
  ``tools/bench_gate.py`` fails any breakdown whose additive stage sum
  does not reconcile with measured wall time.

Env knobs: ``TFOS_FLIGHT=0`` disables recording entirely (every ``add``
returns after one env check); ``TFOS_FLIGHT_SAMPLE=N`` records the stage
*histograms* for every Nth committed batch only — verdict counting and the
additive totals stay exact, so bench breakdowns are unaffected.
"""

from __future__ import annotations

import os
import re
import threading
from collections import Counter, defaultdict, deque
from typing import Any, Mapping

#: the additive-stage → verdict mapping; ``_bg``-suffixed (overlapped)
#: stages never classify
STAGE_VERDICT = {
    "wait": "feed_starved",
    "backpressure": "queue_backpressured",
    "encode": "ingest_bound",
    "ingest": "ingest_bound",
    "collate": "ingest_bound",
    "coalesce": "ingest_bound",
    "pad": "ingest_bound",
    "stage": "ingest_bound",
    "shard": "ingest_bound",
    "compute": "device_bound",
    "allreduce": "comm_bound",
    # sharded weight update (reduce-scatter path): the gradient
    # reduce-scatter and the post-update parameter all-gather are
    # interconnect legs; the 1/N optimizer update is device work
    "scatter": "comm_bound",
    "gather": "comm_bound",
    "update": "device_bound",
    "emit": "emit_bound",
    "reply": "emit_bound",
    # generative decode plane: prefill (prompt ingestion — the chunked
    # multi-sequence step, or one sequence per call in legacy mode) and
    # decode (the batched token step over every active slot) are
    # SEPARATE phases with separate economics — a prefill_bound tier
    # needs a smaller chunk budget or a longer ladder, a decode_bound
    # tier needs more slots per step — so they classify apart
    "prefill": "prefill_bound",
    "prefill_chunk": "prefill_bound",
    "decode": "decode_bound",
    # speculative decode splits the token step further: "speculate"
    # (drafting — host n-gram lookup or the draft-model forward) and
    # "verify" (the one fixed-shape k+1-position target forward).  A
    # speculate_bound tier is paying more for proposals than they save
    # — shrink k or switch drafter; a verify-dominated tier is just the
    # decode step under another name, so it classifies decode_bound
    "speculate": "speculate_bound",
    "verify": "decode_bound",
}

#: every verdict :func:`classify` can return
VERDICTS = ("feed_starved", "device_bound", "comm_bound", "emit_bound",
            "queue_backpressured", "ingest_bound", "prefill_bound",
            "decode_bound", "speculate_bound", "balanced")

#: a verdict needs this share of the additive batch time to be named
DOMINANCE = 0.5

_OVERLAP_SUFFIX = "_bg"


def enabled() -> bool:
    """Recording on?  ``TFOS_FLIGHT=0`` opts out (re-read per call so tests
    and the bench overhead measurement can toggle it live)."""
    return os.environ.get("TFOS_FLIGHT", "1").strip().lower() not in (
        "0", "false", "no")


def sample_every() -> int:
    """``TFOS_FLIGHT_SAMPLE=N``: stage histograms recorded every Nth batch
    (default 1 = every batch).  Totals and verdicts stay exact."""
    try:
        return max(1, int(os.environ.get("TFOS_FLIGHT_SAMPLE", "1")))
    except ValueError:
        return 1


def classify(stages: Mapping[str, float],
             dominance: float = DOMINANCE) -> str:
    """Name the bottleneck of one batch from its additive stage seconds.

    The verdict whose stages hold ≥ ``dominance`` of the additive total
    wins; no dominant category (or an all-zero record) is ``"balanced"``.
    Stages with the ``_bg`` suffix (overlapped pump work) and unknown
    stage names are ignored — they are context, not critical path.
    """
    shares: dict[str, float] = defaultdict(float)
    for name, secs in stages.items():
        if name.endswith(_OVERLAP_SUFFIX):
            continue
        verdict = STAGE_VERDICT.get(name)
        if verdict is not None and secs > 0:
            shares[verdict] += float(secs)
    total = sum(shares.values())
    if total <= 0:
        return "balanced"
    verdict, top = max(shares.items(), key=lambda kv: kv[1])
    return verdict if top >= dominance * total else "balanced"


class FlightRecorder:
    """Per-plane stage-time accumulator: batches in, verdicts out.

    Thread-safe by design: the serving pump thread adds its (overlapped)
    ingest stages while the consumer thread adds wait/compute and commits.
    A pump-side add racing a commit lands in the *next* batch's record —
    one-batch attribution skew, exact run totals.
    """

    def __init__(self, plane: str, window: int = 128):
        self.plane = plane
        self._lock = threading.Lock()
        self._pending: dict[str, float] = {}
        self._totals: dict[str, float] = defaultdict(float)
        self._verdicts: Counter = Counter()
        self._window: deque = deque(maxlen=window)
        self._batches = 0
        self._sample_histograms = True
        # instrument handles cached per stage/verdict: the hot path must
        # not pay a name format + registry lock per observation (serving
        # batches are ~ms; the recorder budget is <3% of that, measured
        # and stamped by bench.py)
        self._hists: dict[str, Any] = {}
        self._counters: dict[str, Any] = {}

    # -- recording (hot path) ------------------------------------------------

    def _hist(self, stage: str):
        h = self._hists.get(stage)
        if h is None:
            from tensorflowonspark_torch import obs

            h = self._hists[stage] = obs.histogram(
                f"flight_{self.plane}_{stage}_seconds",
                f"per-batch {stage} stage time on the {self.plane} "
                "pipeline plane")
        return h

    def _counter(self, suffix: str, help: str):
        c = self._counters.get(suffix)
        if c is None:
            from tensorflowonspark_torch import obs

            c = self._counters[suffix] = obs.counter(
                f"flight_{self.plane}_{suffix}", help)
        return c

    def add(self, overlapped: bool = False, **stages: float) -> None:
        """Merge stage seconds into the pending batch record.

        ``overlapped=True`` marks the stages as pump-thread work running
        concurrently with the critical path (stored with a ``_bg`` suffix:
        excluded from classification and the additive stage sum, still
        totalled and exported).  No-op when ``TFOS_FLIGHT=0``.
        """
        if not enabled():
            return
        sample = self._sample_histograms
        with self._lock:
            for name, secs in stages.items():
                if overlapped:
                    name = name + _OVERLAP_SUFFIX
                secs = float(secs)
                self._pending[name] = self._pending.get(name, 0.0) + secs
                self._totals[name] += secs
        if sample:
            for name, secs in stages.items():
                if overlapped:
                    name = name + _OVERLAP_SUFFIX
                self._hist(name).observe(float(secs))

    def commit(self) -> str | None:
        """Classify and close the pending batch record; returns the verdict
        (None when nothing was recorded — e.g. recorder disabled).

        A disabled commit DISCARDS any pending record instead of
        classifying it: a record left pending across an enabled→disabled
        edge (e.g. the bench's interleaved ``TFOS_FLIGHT=0`` reps meeting
        a deliberately-uncommitted trailing emit) is a fragment, and
        committing it would manufacture a verdict its batch never earned.
        Its stage seconds were already totalled at add time.
        """
        if not enabled():
            with self._lock:
                self._pending.clear()
            return None
        with self._lock:
            if not self._pending:
                return None
            stages, self._pending = self._pending, {}
            verdict = classify(stages)
            self._verdicts[verdict] += 1
            self._batches += 1
            self._window.append((stages, verdict))
            self._sample_histograms = (self._batches
                                       % sample_every() == 0)
        self._counter(
            "batches_total",
            f"batches attributed on the {self.plane} plane").inc()
        self._counter(
            f"verdict_{verdict}_total",
            f"batches whose {self.plane}-plane bottleneck verdict was "
            f"{verdict}").inc()
        return verdict

    def reset(self) -> None:
        """Zero the run-local accumulation (bench runs reset per
        measurement; registry instruments are cumulative and unaffected)."""
        with self._lock:
            self._pending.clear()
            self._totals.clear()
            self._verdicts.clear()
            self._window.clear()
            self._batches = 0
            self._sample_histograms = True

    # -- reading -------------------------------------------------------------

    @property
    def batches(self) -> int:
        return self._batches

    def totals(self) -> dict[str, float]:
        """Additive (critical-path) stage seconds since the last reset."""
        with self._lock:
            return {k: v for k, v in self._totals.items()
                    if not k.endswith(_OVERLAP_SUFFIX)}

    def totals_overlapped(self) -> dict[str, float]:
        """Overlapped (pump-thread) stage seconds since the last reset."""
        with self._lock:
            return {k[: -len(_OVERLAP_SUFFIX)]: v
                    for k, v in self._totals.items()
                    if k.endswith(_OVERLAP_SUFFIX)}

    def verdict(self) -> str:
        """The run's dominant verdict (most-counted; ``balanced`` when no
        batches committed)."""
        with self._lock:
            if not self._verdicts:
                return "balanced"
            return self._verdicts.most_common(1)[0][0]

    def snapshot(self) -> dict[str, Any]:
        """JSON-able run summary for the ``/pipeline`` local view."""
        with self._lock:
            verdicts = dict(self._verdicts)
            batches = self._batches
        return {
            "plane": self.plane,
            "batches": batches,
            "stages_s": {k: round(v, 4) for k, v in self.totals().items()},
            "overlapped_stages_s": {
                k: round(v, 4)
                for k, v in self.totals_overlapped().items()},
            "verdicts": verdicts,
            "verdict": self.verdict(),
        }

    def breakdown(self, wall_s: float) -> dict[str, Any]:
        """The bench-artifact stage breakdown for a run that took
        ``wall_s`` on the consumer critical path.

        ``stage_sum_s`` sums only the additive stages — single-thread
        critical-path time that must reconcile with ``wall_s`` (the gate
        fails the artifact when it doesn't).  Overlapped pump stages are
        reported beside it, uncounted.
        """
        with self._lock:
            # one consistent read: a pump/feeder thread committing
            # concurrently must not mutate the Counter mid-serialization
            verdicts = dict(self._verdicts)
            batches = self._batches
        tot = self.totals()
        ssum = sum(tot.values())
        return {
            "wall_s": round(float(wall_s), 4),
            "stage_sum_s": round(ssum, 4),
            "stage_sum_frac": (round(ssum / wall_s, 4)
                               if wall_s > 0 else None),
            "stages_s": {k: round(v, 4) for k, v in sorted(tot.items())},
            "overlapped_stages_s": {
                k: round(v, 4)
                for k, v in sorted(self.totals_overlapped().items())},
            "batches": batches,
            "verdicts": verdicts,
            "verdict": self.verdict(),
        }


# -- per-process recorder table ----------------------------------------------

_RECORDERS: dict[str, FlightRecorder] = {}
_RECORDERS_LOCK = threading.Lock()


def recorder(plane: str) -> FlightRecorder:
    """The process-wide recorder for one pipeline plane (get-or-create)."""
    rec = _RECORDERS.get(plane)
    if rec is None:
        with _RECORDERS_LOCK:
            rec = _RECORDERS.setdefault(plane, FlightRecorder(plane))
    return rec


def local_report() -> dict[str, Any]:
    """Snapshots of every plane recorded in THIS process (the driver's own
    serving/bench activity on the ``/pipeline`` view)."""
    with _RECORDERS_LOCK:
        recs = list(_RECORDERS.values())
    return {rec.plane: rec.snapshot() for rec in recs if rec.batches}


# -- driver-side rendering over shipped registries ---------------------------

_HIST_RE = re.compile(r"^flight_([a-z0-9]+)_(.+)_seconds$")
_VERDICT_RE = re.compile(r"^flight_([a-z0-9]+)_verdict_(.+)_total$")
_BATCHES_RE = re.compile(r"^flight_([a-z0-9]+)_batches_total$")


def report_from_metrics(agg: dict[str, Any]) -> dict[str, Any]:
    """Per-node, per-plane stage/verdict rollup from a
    ``TFCluster.metrics()`` aggregate.

    Reads each node's own registry snapshot (the merge would sum away the
    per-node attribution): stage histograms become ``{p50, p95, total_s,
    count}`` per stage, verdict counters become per-node tallies with the
    dominant verdict named.  Pure function, no RPCs — safe on every
    ``/pipeline`` scrape.
    """
    from tensorflowonspark_torch.obs import anomaly

    planes: dict[str, dict[str, Any]] = {}

    def node_plane(plane: str, node: str) -> dict[str, Any]:
        return planes.setdefault(plane, {"nodes": {}})["nodes"].setdefault(
            node, {"stages": {}, "verdicts": {}, "batches": 0})

    for node, snap in sorted((agg.get("nodes") or {}).items()):
        reg = (snap or {}).get("registry") or {}
        for name, h in (reg.get("histograms") or {}).items():
            m = _HIST_RE.match(name)
            if not m or not h.get("count"):
                continue
            plane, stage = m.group(1), m.group(2)
            buckets = h.get("buckets") or []
            node_plane(plane, node)["stages"][stage] = {
                "p50": anomaly.hist_quantile(buckets, 0.50),
                "p95": anomaly.hist_quantile(buckets, 0.95),
                "total_s": round(h.get("sum", 0.0), 4),
                "count": h["count"],
                "overlapped": stage.endswith(_OVERLAP_SUFFIX),
            }
        for name, val in (reg.get("counters") or {}).items():
            m = _VERDICT_RE.match(name)
            if m:
                node_plane(m.group(1), node)["verdicts"][m.group(2)] = \
                    int(val)
                continue
            m = _BATCHES_RE.match(name)
            if m:
                node_plane(m.group(1), node)["batches"] = int(val)
    for plane_doc in planes.values():
        totals: Counter = Counter()
        for node_doc in plane_doc["nodes"].values():
            verdicts = node_doc["verdicts"]
            node_doc["verdict"] = (
                max(verdicts.items(), key=lambda kv: kv[1])[0]
                if verdicts else "balanced")
            totals.update(verdicts)
        plane_doc["verdicts"] = dict(totals)
        plane_doc["verdict"] = (totals.most_common(1)[0][0]
                                if totals else "balanced")
    return {"planes": planes}


def detect_feed_starvation(agg: dict[str, Any], *,
                           min_batches: int = 20,
                           min_ratio: float = 0.5) -> list[dict[str, Any]]:
    """Persistent feed starvation findings for ``check_anomalies()``.

    A node whose feed-plane verdicts are ≥ ``min_ratio`` ``feed_starved``
    over ≥ ``min_batches`` classified batches is spending most of its step
    wall blocked on Spark — the trainer is healthy, the feed is the
    bottleneck.  Each finding carries the evidence (verdict ratio plus the
    node's wait/compute p50s) so the anomaly names *why*, not just *who*.
    """
    from tensorflowonspark_torch.obs import anomaly

    findings: list[dict[str, Any]] = []
    for node, snap in sorted((agg.get("nodes") or {}).items()):
        reg = (snap or {}).get("registry") or {}
        counters = reg.get("counters") or {}
        verdicts = {m.group(2): int(v) for name, v in counters.items()
                    if (m := _VERDICT_RE.match(name))
                    and m.group(1) == "feed"}
        total = sum(verdicts.values())
        starved = verdicts.get("feed_starved", 0)
        if total < min_batches or starved < min_ratio * total:
            continue
        evidence: dict[str, Any] = {}
        for stage in ("wait", "ingest", "collate", "compute"):
            h = (reg.get("histograms") or {}).get(
                f"flight_feed_{stage}_seconds")
            if h and h.get("count"):
                evidence[f"{stage}_p50_s"] = anomaly.hist_quantile(
                    h.get("buckets") or [], 0.50)
        findings.append({
            "node": node,
            "plane": "feed",
            "ratio": round(starved / total, 4),
            "batches": total,
            "verdicts": verdicts,
            **evidence,
        })
    return findings
