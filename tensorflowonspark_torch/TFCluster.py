"""Cluster lifecycle API — the driver-side entry point.

Reference anchor: ``tensorflowonspark/TFCluster.py`` (``run``, ``TFCluster``
with ``train/inference/shutdown/tensorboard_url``, ``InputMode``).

Flow (``SURVEY.md §3.1``): compute the cluster template (roles per executor),
start the rendezvous server, launch one bootstrap task per executor on a
background thread, wait for every node to register, hand back a
:class:`TFCluster`.  ``InputMode.SPARK`` pushes RDD partitions through
per-executor queues into the trainer; ``InputMode.TENSORFLOW`` lets the
trainer read files (TFRecords on HDFS/GCS) directly, with the bootstrap task
blocking for the whole training run.

A copy of ``tensorflowonspark_tpu/TFCluster.py`` with its imports
rewritten.  The rendezvous barrier seeds ``torch.distributed`` (executor 0
publishes the address on the kv blackboard) instead of writing
``TF_CONFIG``; ``num_ps`` is recorded on the node context, as in the JAX
package, for model code (the port trains data parallel only so far).
The JAX profiler endpoint (``profiler_address``) is not ported yet.
"""

from __future__ import annotations

import logging
import secrets
import threading
import uuid
from enum import Enum
from typing import Any, Callable

from tensorflowonspark_torch import TFSparkNode, obs, reservation

logger = logging.getLogger(__name__)


class InputMode(Enum):
    """Reference anchor: ``TFCluster.py::InputMode``."""

    TENSORFLOW = 0  # trainer reads its own data (files on HDFS/GCS)
    SPARK = 1  # Spark feeds RDD/DataFrame partitions through queues


class TFCluster:
    def __init__(self, sc, cluster_meta, cluster_info, server, input_mode,
                 bootstrap_thread):
        self.sc = sc
        self.cluster_meta = cluster_meta
        self.cluster_info = cluster_info
        self.server = server
        self.input_mode = input_mode
        self._thread = bootstrap_thread
        self._thread_error: list[BaseException] = []
        self.num_executors = cluster_meta["num_executors"]
        #: last snapshot seen per node — keeps a finished node's final
        #: numbers visible after its manager dies (marked "stale")
        self._last_node_metrics: dict[str, dict] = {}
        #: (wall_time, aggregate) samples appended by the train-time poller
        self.metrics_history: list[tuple[float, dict]] = []
        #: node error-queue messages drained eagerly (before the manager
        #: orphan-watch grace window can reap the evidence)
        self._node_error_cache: list[str] = []
        #: cache index up to which messages were already attached to a
        #: raised exception (so train() surfaces poller-drained evidence
        #: exactly once instead of dropping or repeating it)
        self._node_errors_surfaced = 0
        #: anomaly keys already recorded as driver trace events (dedup)
        self._reported_anomalies: set = set()
        #: last state string seen per node (health() keeps a finished
        #: node's verdict after its manager is reaped)
        self._last_node_state: dict[str, str] = {}
        #: last anomaly report from :meth:`check_anomalies`
        self.last_anomaly_report: dict | None = None
        self._obs_server = None
        #: elastic supervisor, when one is attached
        #: (:class:`tensorflowonspark_torch.elastic.ElasticSupervisor`);
        #: :meth:`health` surfaces its state on ``/healthz``
        self._elastic = None

    # -- data plane --------------------------------------------------------

    def train(self, dataRDD, num_epochs: int = 1, feed_timeout: float = 600.0,
              qname: str = "input", metrics_interval: float = 30.0) -> None:
        """Feed an RDD through the cluster for ``num_epochs``.

        Reference anchor: ``TFCluster.py::TFCluster.train`` (it re-submits
        the RDD once per epoch; each partition lands on an executor and is
        pushed into the co-located node's queue).

        While feeding, a driver-side poller samples :meth:`metrics` every
        ``metrics_interval`` seconds into :attr:`metrics_history` (and an
        INFO log line), so long jobs have live observability instead of a
        single end-of-run snapshot.  ``metrics_interval=0`` disables it.
        """
        if self.input_mode is not InputMode.SPARK:
            raise RuntimeError("train(dataRDD) requires InputMode.SPARK")
        self._check_bootstrap_error()
        poller = self._start_metrics_poller(metrics_interval)
        try:
            with obs.span("cluster.train", epochs=num_epochs):
                for epoch in range(num_epochs):
                    logger.info("feeding epoch %d/%d", epoch + 1, num_epochs)
                    with obs.span("cluster.feed_epoch", epoch=epoch + 1):
                        dataRDD.foreachPartition(
                            TFSparkNode.train(self.cluster_info,
                                              self.cluster_meta,
                                              feed_timeout, qname)
                        )
                    self._check_bootstrap_error()
        except Exception as e:
            # drain node error queues NOW: the evidence (a StepWatchdog
            # stall attribution, a map_fun traceback) lives on managers
            # whose orphan watch reaps them ~15 s after their trainer dies
            # — by the time the user handles this exception
            # it may be gone.  Attach every attribution not yet SURFACED
            # in an exception: that includes messages the anomaly
            # poller's node_died handler drained into the cache moments
            # before the feed failed (fresh-only would drop exactly the
            # watchdog's last words).  An unrelated exception with
            # nothing new to attribute keeps its type.
            self._drain_node_errors()
            pending = self._node_error_cache[self._node_errors_surfaced:]
            if pending:
                self._node_errors_surfaced = len(self._node_error_cache)
                detail = "".join(f"\n  node error: {m}" for m in pending)
                raise RuntimeError(f"training failed{detail}") from e
            raise
        finally:
            if poller is not None:
                poller()

    def _start_metrics_poller(self, interval: float):
        """Background sampling of :meth:`metrics` into
        :attr:`metrics_history`; returns a stop() callable (None when
        disabled)."""
        if not interval or interval <= 0:
            return None
        import threading
        import time as _time

        stop = threading.Event()

        def poll() -> None:
            while not stop.wait(interval):
                try:
                    agg = self.metrics()
                except Exception as e:  # observability must not kill train
                    logger.warning("metrics poll failed: %s", e)
                    continue
                self.metrics_history.append((_time.time(), agg))
                logger.info(
                    "cluster metrics: %s nodes, %s examples/sec, loss %s",
                    agg.get("num_reporting"),
                    agg.get("total_examples_per_sec"), agg.get("mean_loss"))
                try:  # straggler/stall judgment rides every sample
                    self.check_anomalies(agg)
                except Exception as e:
                    logger.warning("anomaly check failed: %s", e)

        t = threading.Thread(target=poll, daemon=True,
                             name="tfos-metrics-poller")
        t.start()

        def stopper() -> None:
            stop.set()
            t.join(timeout=5.0)

        return stopper

    def train_stream(self, dstream, feed_timeout: float = 600.0,
                     qname: str = "input") -> None:
        """Feed a Spark Streaming DStream through the cluster.

        Reference anchor: ``TFCluster.py::TFCluster.train`` accepts a DStream
        in streaming jobs — every micro-batch RDD's partitions are pushed
        into the same per-executor queues as :meth:`train`.  Works with any
        object exposing ``foreachRDD`` (a pyspark ``DStream``); pair with
        ``shutdown(ssc=...)`` which drains the queues before stopping the
        streaming context.
        """
        if self.input_mode is not InputMode.SPARK:
            raise RuntimeError("train_stream(dstream) requires InputMode.SPARK")
        self._check_bootstrap_error()
        feed_fn = TFSparkNode.train(self.cluster_info, self.cluster_meta,
                                    feed_timeout, qname)
        dstream.foreachRDD(lambda rdd: rdd.foreachPartition(feed_fn))

    def inference(self, dataRDD, qname_in: str = "input",
                  qname_out: str = "output", timeout: float = 600.0):
        """Run distributed inference; returns an RDD of predictions.

        Reference anchor: ``TFCluster.py::TFCluster.inference``.
        """
        if self.input_mode is not InputMode.SPARK:
            raise RuntimeError("inference(dataRDD) requires InputMode.SPARK")
        self._check_bootstrap_error()
        return dataRDD.mapPartitions(
            TFSparkNode.inference(self.cluster_info, self.cluster_meta,
                                  qname_in, qname_out, timeout)
        )

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, ssc=None, grace_secs: float = 30.0,
                 timeout: float = 600.0, qname: str = "input") -> None:
        """Stop all nodes, propagate trainer errors, stop the rendezvous.

        Reference anchor: ``TFCluster.py::TFCluster.shutdown``.  In SPARK
        mode, sends a stop marker to every node's feed queue and waits up to
        ``grace_secs`` for each trainer to finish; in TENSORFLOW mode waits
        for the (blocking) bootstrap job to complete.

        ``ssc`` (streaming jobs): the reference waits for the input queues to
        drain, then stops the StreamingContext gracefully without stopping
        the SparkContext — same here.  Pass the context whose DStream was fed
        via :meth:`train_stream`.
        """
        if ssc is not None:
            self._drain_and_stop_streaming(ssc, timeout, qname)
        try:
            with obs.span("cluster.shutdown", grace_secs=grace_secs):
                if self.input_mode is InputMode.SPARK:
                    n = self.num_executors
                    self.sc.parallelize(range(n), n).foreachPartition(
                        TFSparkNode.shutdown(self.cluster_info,
                                             self.cluster_meta,
                                             grace_secs, qname)
                    )
                self._thread.join(timeout=timeout)
                if self._thread.is_alive():
                    raise RuntimeError(
                        f"cluster bootstrap job still running after {timeout}s"
                    )
                self._check_bootstrap_error()
        finally:
            if self._obs_server is not None:
                try:
                    self._obs_server.stop()
                except Exception:
                    pass
                self._obs_server = None
            self.server.stop()

    def _drain_and_stop_streaming(self, ssc, timeout: float, qname: str) -> None:
        """Wait until every node's feed queue is empty, then stop ``ssc``
        gracefully (keeping the SparkContext alive, reference semantics)."""
        import time as _time

        from tensorflowonspark_torch import TFManager

        authkey = bytes.fromhex(self.cluster_meta["authkey_hex"])
        try:
            queues = [
                TFManager.connect(tuple(m["addr"]), authkey).get_queue(qname)
                for m in self.cluster_info
            ]
        except Exception:
            queues = []  # nodes already gone; nothing left to drain
        deadline = _time.monotonic() + timeout
        while queues and _time.monotonic() < deadline:
            try:
                pending = sum(q.qsize() for q in queues)
            except Exception:
                break
            if pending == 0:
                break
            _time.sleep(0.25)
        else:
            logger.warning("streaming queues not drained after %ss", timeout)
        try:
            ssc.stop(stopSparkContext=False, stopGraceFully=True)
        except TypeError:  # older pyspark: positional-only
            ssc.stop(False, True)

    def metrics(self, key: str = "metrics") -> dict:
        """Collect per-node step metrics and the cluster rollup.

        Nodes publish snapshots via :class:`metrics.MetricsReporter` (a
        ``Trainer`` step callback writing to the node kv blackboard); this
        gathers them and sums throughput.  Returns ``metrics.aggregate``'s
        shape: ``{"nodes": {...}, "total_examples_per_sec": N, ...}``.
        Replaces the reference-era ad-hoc per-example kv entries.
        """
        from tensorflowonspark_torch import TFManager, metrics as metrics_lib

        authkey = bytes.fromhex(self.cluster_meta["authkey_hex"])
        per_node: dict[str, dict] = {}
        for meta in self.cluster_info:
            name = f"{meta['job_name']}:{meta['task_index']}"
            try:
                mgr = TFManager.connect(tuple(meta["addr"]), authkey)
                snap = mgr.get(key)
            except Exception as e:
                logger.warning("metrics: node %s unreachable: %s", name, e)
                snap = None
            else:
                # remember each node's lifecycle state while its manager
                # is reachable: health() consults this memo so a node
                # that finished cleanly and was then reaped reads
                # "finished", not a 503-triggering "unreachable" (the
                # train-time poller calls this every sample, keeping the
                # memo fresher than /healthz's own scrape cadence).  Own
                # try: a failure HERE must not void the good snapshot.
                try:
                    state = mgr.get("state")
                    if state:
                        self._last_node_state[name] = state
                except Exception:
                    pass
            if snap:
                per_node[name] = dict(snap)
                self._last_node_metrics[name] = dict(snap)
            elif name in self._last_node_metrics:
                # node finished / manager gone: keep its final numbers
                # visible rather than silently dropping the node
                per_node[name] = {**self._last_node_metrics[name],
                                  "stale": True}
        return metrics_lib.aggregate(per_node)

    def metrics_prometheus(self, key: str = "metrics") -> str:
        """Prometheus text exposition of the cluster's merged metrics.

        One scrape-able document: per-node step metrics (``node``-labelled
        gauges), the cluster rollup, and the merged obs registry
        (counters/histograms summed across nodes, registry gauges kept
        per node).  Serve it from any HTTP handler — the framework stays
        transport-agnostic, matching the reference's "bring your own
        serving" posture.
        """
        from tensorflowonspark_torch.obs import registry as reg

        agg = self.metrics(key)
        parts: list[str] = []
        # per-node step gauges go through the merged-shape emitter so each
        # metric family gets ONE "# TYPE" line with all node-labelled
        # samples grouped under it — a second TYPE line for the same name
        # is a text-exposition-format violation scrapers reject
        node_gauges: dict[str, dict[str, Any]] = {}
        for node, snap in sorted((agg.get("nodes") or {}).items()):
            for k in ("step", "loss", "examples_per_sec", "total_examples"):
                if isinstance(snap.get(k), (int, float)):
                    node_gauges.setdefault(f"node_{k}", {})[node] = snap[k]
        if node_gauges:
            parts.append(reg.merged_to_prometheus({"gauges": node_gauges}))
        rollup = {
            f"cluster_{k}": agg[k]
            for k in ("num_reporting", "total_examples_per_sec", "mean_loss")
            if isinstance(agg.get(k), (int, float))
        }
        if rollup:
            parts.append(reg.snapshot_to_prometheus({"gauges": rollup}))
        merged = agg.get("registry")
        if merged:
            parts.append(reg.merged_to_prometheus(merged))
        # the DRIVER's own registry rides along too — the elastic
        # supervisor's counters (elastic_regroups_total, recovery_seconds)
        # live here, not on any node.  Families the node merge already
        # emitted are dropped: a second "# TYPE" line for the same name is
        # an exposition-format violation scrapers reject.
        drv = obs.get_registry().snapshot()
        merged = merged or {}
        drv = {section: {k: v for k, v in (drv.get(section) or {}).items()
                         if k not in (merged.get(section) or {})}
               for section in ("counters", "gauges", "histograms")}
        if any(drv.values()):
            parts.append(reg.snapshot_to_prometheus(drv))
        return "".join(parts)

    def dump_trace(self, path: str) -> str:
        """Merge driver + every node's trace events into one
        Chrome-trace-format file at ``path``; returns ``path``.

        Each node process (bootstrap task and spawned trainer) ships its
        event ring buffer to its own ``trace:<node>:<pid>`` key on the
        node's kv blackboard (:mod:`tensorflowonspark_torch.obs`); this
        collects them all, adds the driver's own buffer, and writes the
        merged timeline (``obs.chrome``) — open it in ``chrome://tracing``
        / Perfetto to see exactly where cluster time went.  Unreachable
        nodes are skipped
        with a warning, so a post-mortem dump after a crash still writes
        whatever shipped before the death.

        The driver's own buffer is process-lifetime (a driver that runs
        several clusters sees all its spans on one timeline — that is the
        point of a trace); executor-side buffers are cleared when a reused
        worker bootstraps a new cluster, so node tracks never mix runs.
        """
        by_node = self._trace_events_by_node()
        logger.info("dump_trace: %d nodes, %d events → %s", len(by_node),
                    sum(len(v) for v in by_node.values()), path)
        return obs.chrome.write(path, by_node)

    def _trace_events_by_node(self) -> dict[str, list[dict]]:
        """Driver buffer + every reachable node's shipped trace events —
        the shared collection step behind :meth:`dump_trace`, the
        ``/trace`` endpoint, and stall attribution
        (:meth:`check_anomalies`)."""
        from tensorflowonspark_torch import TFManager

        tracer = obs.get_tracer()
        by_node: dict[str, list[dict]] = {tracer.node: tracer.snapshot()}
        # retained request traces (tail-sampled span trees: SLO breaches,
        # sheds, errors + the uniform sample) merge into the same
        # timeline — their spans carry trace ids into the Chrome args
        by_node[tracer.node].extend(obs.get_trace_store().events())
        authkey = bytes.fromhex(self.cluster_meta["authkey_hex"])
        for meta in self.cluster_info:
            name = f"{meta['job_name']}:{meta['task_index']}"
            try:
                mgr = TFManager.connect(tuple(meta["addr"]), authkey)
                shipped = obs.collect_blackboard(mgr.kv_snapshot())
            except Exception as e:
                logger.warning("trace collect: node %s unreachable: %s",
                               name, e)
                continue
            for node, events in shipped.items():
                by_node.setdefault(node, []).extend(events)
        return by_node

    # -- anomaly attribution -------------------------------------------------

    def check_anomalies(self, agg: dict | None = None, *,
                        factor: float = 1.75,
                        stall_after_s: float = 60.0,
                        scan_traces: bool | None = None) -> dict:
        """Judge the cluster for stragglers and stalls; returns the report.

        Straggler detection runs over the per-node step-time histograms
        already riding the metrics publications
        (:func:`tensorflowonspark_torch.obs.anomaly.detect`); stall
        attribution additionally scans the shipped trace events for the
        StepWatchdog's ``health.step_stall`` last words.  Each *new*
        finding is recorded once as a driver trace event
        (``anomaly.straggler`` / ``anomaly.stall``) and logged at WARNING
        — so a degraded run's trace and logs name the sick node instead
        of leaving a bare dead executor.  Runs automatically on every
        train-time metrics-poll sample.

        ``scan_traces`` controls the expensive half (pulling every node's
        kv blackboard to look for shipped ``health.step_stall`` events):
        default (None) scans only when the cheap judgment over the
        already-collected aggregate found something to attribute — a
        healthy poll tick costs no extra RPCs.  Pass True to force a scan
        (post-mortem inspection), False to skip it.
        """
        import time as _time

        from tensorflowonspark_torch.obs import anomaly

        if agg is None:
            agg = self.metrics()
        # a single LIVE reporting node has no peer to lag behind: judge
        # its heartbeat against the driver's wall clock instead.  Stale
        # (finished, manager-reaped) nodes' gauges linger in the merge
        # and must not count as peers — a sole survivor wedging after its
        # peers finished would otherwise never be judged.  Multi-node
        # keeps peer comparison, which stays quiet through collective
        # pauses like a cluster-wide recompile (tradeoff: with exactly
        # one live reporter the wall clock can flag a >stall_after_s
        # feed/compile pause as a stall — a WARNING, not a kill).
        heartbeats = ((agg.get("registry") or {}).get("gauges") or {}).get(
            anomaly.LAST_STEP_GAUGE) or {}
        stale_nodes = {n for n, s in (agg.get("nodes") or {}).items()
                       if s and s.get("stale")}
        live_heartbeats = {n: ts for n, ts in heartbeats.items()
                           if n not in stale_nodes}
        now = _time.time() if len(live_heartbeats) == 1 else None
        report = anomaly.detect(agg, factor=factor,
                                stall_after_s=stall_after_s, now=now)
        # a node whose manager became unreachable WITHOUT reporting
        # "finished" died mid-run (watchdog os._exit, executor loss): the
        # shipped evidence is on a ~15 s fuse (orphan-watch grace), so
        # attribute NOW rather than waiting out the heartbeat window
        report["died"] = [
            {"node": n, "last_state": self._last_node_state.get(n,
                                                                "unknown")}
            for n, s in sorted((agg.get("nodes") or {}).items())
            if s and s.get("stale")
            and self._last_node_state.get(n) != "finished"]
        # manager-reported trainer deaths: where the executor process
        # survives its trainer (persistent workers, the local substrate),
        # the node's manager stays REACHABLE — the stale-based judgment
        # above never fires — but its orphan watch marked the node "lost"
        # the moment the trainer pid vanished without reporting
        seen_died = {d["node"] for d in report["died"]}
        # dict() snapshot: the metrics poller / health() threads insert
        # into _last_node_state concurrently, and iterating the live dict
        # here could raise mid-detection (the copy itself is atomic under
        # the GIL)
        report["died"] += [
            {"node": n, "last_state": "lost"}
            for n, state in sorted(dict(self._last_node_state).items())
            if state == "lost" and n not in seen_died]
        if scan_traces is None:
            # only a finding not yet reported justifies the RPCs: a node
            # that STAYS stalled would otherwise re-pull every blackboard
            # on every poll tick for the rest of the run
            scan_traces = any(
                (kind, f["node"]) not in self._reported_anomalies
                for kind, findings in (("straggler", report["stragglers"]),
                                       ("stalled", report["stalled"]),
                                       ("died", report["died"]))
                for f in findings)
        # persistent feed starvation (flight recorder): a node spending
        # most of its classified step wall blocked on the Spark feed is an
        # anomaly with the evidence (verdict ratio + wait/compute p50s)
        # attached — the trainer is healthy, the feed is the bottleneck
        from tensorflowonspark_torch.obs import flight as flight_lib

        report["feed_starved"] = flight_lib.detect_feed_starvation(agg)
        report["stall_events"] = []
        if scan_traces:
            try:
                events_by_node = self._trace_events_by_node()
                report["stall_events"] = anomaly.stall_events(
                    events_by_node)
                # step-scoped trace ids: a straggler/stall finding cites
                # the exact step windows it judged (trainer.step spans),
                # addressable by id in the merged Chrome trace
                anomaly.cite_step_traces(report, events_by_node)
            except Exception as e:
                logger.warning("stall-event collection failed: %s", e)
        for s in report["stragglers"]:
            key = ("straggler", s["node"])
            if key not in self._reported_anomalies:
                self._reported_anomalies.add(key)
                logger.warning(
                    "straggler: node %s step-time %s %.1fx the cluster "
                    "median (p50 %.4fs vs %.4fs)", s["node"],
                    "/".join(s["quantiles_flagged"]), s["ratio"],
                    s["p50"], s["cluster_p50"])
                obs.event("anomaly.straggler", **s)
        for s in report["stalled"]:
            key = ("stalled", s["node"])
            if key not in self._reported_anomalies:
                self._reported_anomalies.add(key)
                logger.warning("stalled: node %s last step %.0fs behind "
                               "the freshest node", s["node"], s["behind_s"])
                obs.event("anomaly.stall", **s)
        for s in report["died"]:
            key = ("died", s["node"])
            if key not in self._reported_anomalies:
                self._reported_anomalies.add(key)
                logger.warning(
                    "node %s became unreachable without finishing (last "
                    "state: %s) — draining its error queue for the "
                    "attribution before the evidence is reaped",
                    s["node"], s["last_state"])
                obs.event("anomaly.node_died", **s)
                try:  # preserve error-queue evidence while it exists
                    self._drain_node_errors()
                except Exception:
                    pass
        for s in report["feed_starved"]:
            key = ("feed_starved", s["node"])
            if key not in self._reported_anomalies:
                self._reported_anomalies.add(key)
                logger.warning(
                    "feed-starved: node %s spent %.0f%% of %d classified "
                    "steps blocked on the Spark feed (wait p50 %ss vs "
                    "compute p50 %ss) — scale/unthrottle the feeders, not "
                    "the trainer", s["node"], s["ratio"] * 100,
                    s["batches"], s.get("wait_p50_s"),
                    s.get("compute_p50_s"))
                obs.event("anomaly.feed_starved", **s)
        for s in report["stall_events"]:
            key = ("stall_event", s["node"], s.get("ts"))
            if key not in self._reported_anomalies:
                self._reported_anomalies.add(key)
                logger.warning("watchdog stall on node %s: %s", s["node"],
                               s["reason"])
                obs.event("anomaly.stall", node=s["node"],
                          reason=s["reason"], stalled_s=s.get("stalled_s"))
        self.last_anomaly_report = report
        return report

    # -- live endpoint -------------------------------------------------------

    def health(self, key: str = "state",
               node_timeout_s: float = 5.0) -> dict:
        """Node-health rollup from the per-node kv blackboards.

        ``{"status": "ok"|"degraded", "nodes": {name: state}}`` — a node
        is unhealthy when unreachable or in state ``"failed"``.  Each
        node read is bounded by ``node_timeout_s`` (a black-holed host
        must not hang every ``/healthz`` scrape for the kernel TCP
        timeout), and a node that was last seen ``"finished"`` before its
        manager went away reports ``"finished"`` instead of flipping a
        *completed* run to a permanent 503.
        """
        import threading
        import time as _time

        from tensorflowonspark_torch import TFManager

        authkey = bytes.fromhex(self.cluster_meta["authkey_hex"])
        results: dict[str, str] = {}

        def read_state(name, meta) -> None:
            try:
                results[name] = TFManager.connect(
                    tuple(meta["addr"]), authkey).get(key) or "unknown"
            except Exception:
                pass  # absent result = unreachable

        threads = {}
        for meta in self.cluster_info:
            name = f"{meta['job_name']}:{meta['task_index']}"
            # daemon threads: one blocked on a black-holed host must hold
            # hostage neither this scrape nor interpreter exit
            t = threading.Thread(target=read_state, args=(name, meta),
                                 name=f"tfos-health-{name}", daemon=True)
            t.start()
            threads[name] = t
        deadline = _time.monotonic() + node_timeout_s
        nodes: dict[str, str] = {}
        healthy = True
        for name, t in threads.items():
            t.join(timeout=max(0.0, deadline - _time.monotonic()))
            state = results.get(name)
            if state is not None:
                self._last_node_state[name] = state
            elif self._last_node_state.get(name) == "finished":
                # unreachable, but its last word was "finished": the run
                # completed cleanly and the manager was reaped — not a
                # reason to flip a healthy endpoint to a permanent 503
                state = "finished"
            else:
                state = "unreachable"
                healthy = False
            if state in ("failed", "lost"):
                healthy = False
            nodes[name] = state
        doc = {"status": "ok" if healthy else "degraded", "nodes": nodes,
               "num_nodes": len(nodes)}
        if self._elastic is not None:
            # degraded-but-recovering vs dead: a regroup in
            # flight reports "recovering" (work in progress, not a 503 —
            # the lost node is expected to be unreachable and the
            # survivors are mid-rejoin); a dead supervisor (budget
            # exhausted / barrier timeout) is a real "degraded".  Already-
            # mourned nodes are annotated "lost" for the reader.
            sup = self._elastic.status()
            doc["elastic"] = sup
            mourned = set(sup.get("lost_nodes") or [])
            for n in mourned:
                if nodes.get(n) in (None, "unreachable"):
                    nodes[n] = "lost"
            if sup["state"] == "dead":
                doc["status"] = "degraded"
            elif sup["state"] == "regrouping":
                doc["status"] = "recovering"
            elif doc["status"] == "degraded" and all(
                    s not in ("unreachable", "failed")
                    and (s != "lost" or n in mourned)
                    for n, s in nodes.items()):
                # the only unhealthy nodes were the regrouped-away ones
                # (mourned, annotated "lost"): the surviving cluster is
                # whole again
                doc["status"] = "ok"
        return doc

    def pipeline_report(self) -> dict:
        """Live pipeline flight-recorder view: where each node's batch
        time goes, and what the bottleneck verdict is.

        Renders the flight stage histograms/verdict counters that ride
        every node's metrics publication
        (:func:`tensorflowonspark_torch.obs.flight.report_from_metrics`)
        plus each manager's watch-thread runtime stats (queue occupancy /
        ``/dev/shm`` residency, kv key ``pipeline_stats``) and this
        process's own recorders (driver-side serving/bench activity).
        Served as ``GET /pipeline`` by :meth:`serve_observability`.
        """
        import threading
        import time as _time

        from tensorflowonspark_torch import TFManager
        from tensorflowonspark_torch.obs import flight as flight_lib

        agg = self.metrics()
        report = flight_lib.report_from_metrics(agg)
        report["feed_starved"] = flight_lib.detect_feed_starvation(agg)
        # per-node kv reads in bounded daemon threads (same pattern as
        # health()): a black-holed host must not hang every /pipeline
        # scrape for the kernel TCP connect timeout — connection-refused
        # fails fast, dropped SYNs do not
        results: dict[str, Any] = {}
        authkey = bytes.fromhex(self.cluster_meta["authkey_hex"])

        def read_stats(name, meta) -> None:
            try:
                stats = TFManager.connect(tuple(meta["addr"]),
                                          authkey).get("pipeline_stats")
            except Exception as e:
                logger.debug("pipeline stats: node %s unreachable: %s",
                             name, e)
                return
            if stats:
                results[name] = stats

        threads = {}
        for meta in self.cluster_info:
            name = f"{meta['job_name']}:{meta['task_index']}"
            t = threading.Thread(target=read_stats, args=(name, meta),
                                 name=f"tfos-pipeline-{name}", daemon=True)
            t.start()
            threads[name] = t
        deadline = _time.monotonic() + 5.0
        for t in threads.values():
            t.join(timeout=max(0.0, deadline - _time.monotonic()))
        # snapshot per known key, never iterating the live dict: a
        # straggler thread completing AFTER the join deadline must not
        # mutate what the /pipeline handler is serializing
        report["node_runtime"] = {
            name: results[name] for name in threads if name in results}
        report["driver"] = flight_lib.local_report()
        return report

    def serve_observability(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the live driver HTTP endpoint; returns the server.

        Routes (stdlib ``http.server`` thread, no new dependencies):
        ``/metrics`` → Prometheus text of :meth:`metrics_prometheus`,
        ``/healthz`` → JSON from :meth:`health` (HTTP 503 when degraded),
        ``/trace`` → the merged Chrome-trace document (the
        :meth:`dump_trace` content, served live),
        ``/pipeline`` → JSON from :meth:`pipeline_report` (per-node stage
        time attribution + bottleneck verdicts + live queue/shm
        residency),
        ``/debug/requests`` → the driver process's retained request
        traces (tail-sampled span trees, slowest-first).
        The returned server exposes ``.port`` /
        ``.url(path)`` / ``.stop()``; it is stopped automatically by
        :meth:`shutdown`.
        """
        import json as _json

        from tensorflowonspark_torch.obs import httpd

        def _metrics():
            return (200, httpd.PROMETHEUS_CONTENT_TYPE,
                    self.metrics_prometheus())

        def _healthz():
            # "recovering" (elastic regroup in flight) serves 200: the
            # endpoint names the state, and flapping to 503 mid-recovery
            # would page for exactly the condition the supervisor is
            # already handling; only "degraded" (truly unhealthy / dead
            # supervisor) is a 503
            doc = self.health()
            return (503 if doc["status"] == "degraded" else 200,
                    "application/json", _json.dumps(doc))

        def _trace():
            doc = obs.chrome.merge(self._trace_events_by_node())
            return (200, "application/json", _json.dumps(doc))

        def _pipeline():
            return (200, "application/json",
                    _json.dumps(self.pipeline_report()))

        def _debug_requests():
            # the driver's own retained request traces (tail-sampled) —
            # same body shape as the online tier's /debug/requests
            return (200, "application/json",
                    _json.dumps(obs.get_trace_store().to_doc()))

        if self._obs_server is not None:
            # re-serving (e.g. to move ports) must not leak the previous
            # listener thread + socket until process exit
            try:
                self._obs_server.stop()
            except Exception:
                pass
            self._obs_server = None
        server = httpd.ObservabilityServer(
            {"/metrics": _metrics, "/healthz": _healthz, "/trace": _trace,
             "/pipeline": _pipeline, "/debug/requests": _debug_requests},
            host=host, port=port)
        addr = server.start()
        logger.info("observability endpoint serving on http://%s:%s "
                    "(/metrics /healthz /trace /pipeline /debug/requests)",
                    *addr)
        self._obs_server = server
        return server

    def tensorboard_url(self, timeout: float = 0.0) -> str | None:
        """URL of the cluster's TensorBoard, if one was started.

        Reference anchor: ``TFCluster.py::TFCluster.tensorboard_url`` (the
        reference polls the manager kv; here it lives on the rendezvous kv).
        """
        client = reservation.Client(
            tuple(self.cluster_meta["server_addr"]), self.cluster_meta["auth_token"]
        )
        try:
            return client.get("tensorboard_url", timeout=timeout)
        except KeyError:
            return None

    def _check_bootstrap_error(self) -> None:
        if self._thread_error:
            detail = ""
            for msg in self._drain_node_errors():
                detail += f"\n  node error: {msg}"
            self._node_errors_surfaced = len(self._node_error_cache)
            raise RuntimeError(
                "cluster bootstrap/training job failed" + detail
            ) from self._thread_error[0]

    def _drain_node_errors(self) -> list:
        """Best-effort read of every node's error queue, so a trainer that
        attributed its own death (e.g. the mid-run wedge watchdog's
        ``ctx.report_error`` before ``os._exit``) names itself in the
        driver's exception instead of leaving only the substrate's generic
        'executor died' message.

        Drained messages are *cached* on the cluster (the queues are
        consumed destructively, and the node managers themselves are
        reaped by the orphan watch ~15 s after their trainer dies) —
        whoever drains first preserves the evidence for every later
        caller.  The bootstrap job thread drains eagerly the moment it
        fails, so the attribution survives even when the
        driver only inspects the error minutes later.
        """
        from tensorflowonspark_torch import TFManager

        msgs = list(self._node_error_cache)
        seen = set(msgs)

        def add(msg) -> None:
            if isinstance(msg, str) and msg not in seen:
                seen.add(msg)
                self._node_error_cache.append(msg)
                msgs.append(msg)

        # durable copies first: ctx.report_error mirrors every attributed
        # failure onto the rendezvous kv (this process!), which outlives
        # the node managers — a watchdog stall is recoverable here even
        # minutes after the orphan watch reaped the node's queue
        try:
            for value in self.server.kv_items("node_error:").values():
                for msg in (value if isinstance(value, list) else [value]):
                    add(msg)
        except Exception:
            pass
        try:
            authkey = bytes.fromhex(self.cluster_meta["authkey_hex"])
        except Exception:
            return msgs
        for meta in self.cluster_info or []:
            try:
                q = TFManager.connect(
                    tuple(meta["addr"]), authkey).get_queue("error")
                while True:  # drain until Empty (raises) or manager gone
                    add(q.get(block=False))
            except Exception:
                continue
        return msgs


def run(
    sc,
    map_fun: Callable,
    tf_args: Any = None,
    num_executors: int | None = None,
    num_ps: int = 0,
    tensorboard: bool = False,
    input_mode: InputMode = InputMode.SPARK,
    log_dir: str | None = None,
    driver_ps_nodes: bool = False,
    master_node: str | None = None,
    reservation_timeout: float = 600.0,
    queues: list[str] | None = None,
    eval_node: bool = False,
    num_chips_per_executor: int | None = None,
    feed_chunk: int = 256,
    default_fs: str | None = None,
    health_probe: bool | None = None,
    health_probe_timeout: float = 60.0,
) -> TFCluster:
    """Launch the accelerator cluster on Spark executors.

    Reference anchor: ``TFCluster.py::run`` — same signature shape.  Notes on
    reference params:

    - ``num_ps`` / ``driver_ps_nodes``: there are no parameter servers.  All
      ``num_executors`` nodes train; ``num_ps > 0`` is recorded on the node
      context (``ctx.num_ps``) for model code.  A warning says so.
    - ``master_node`` names the chief job (e.g. ``"chief"``); executor 0
      takes that role.  ``eval_node=True`` makes the last executor an
      ``evaluator`` (excluded from the training mesh).
    - ``health_probe``: card health check at rendezvous (SURVEY §5).
      ``None`` (default) probes only on executors that claimed cards; a
      wedged card becomes a fast bootstrap failure naming the sick
      executor instead of a silent hang.  See
      :mod:`tensorflowonspark_torch.health`.
    """
    if num_executors is None:
        num_executors = getattr(sc, "defaultParallelism", 1)
    local_execs = getattr(sc, "num_executors", None)
    if local_execs is not None and num_executors != local_execs:
        raise ValueError(
            f"num_executors={num_executors} must equal the local substrate's "
            f"executor count ({local_execs}) so every data partition lands on "
            "an executor that hosts a cluster node"
        )
    if num_ps > 0:
        logger.warning(
            "num_ps=%d requested: there are no parameter servers; all %d "
            "executors will train (ctx.num_ps is set for model code)",
            num_ps, num_executors,
        )
    if driver_ps_nodes:
        logger.warning("driver_ps_nodes is ignored (no parameter servers)")

    # role template (reference: cluster_template computation in TFCluster.run)
    cluster_template: dict[int, tuple[str, int]] = {}
    worker_idx = 0
    for eid in range(num_executors):
        if eval_node and eid == num_executors - 1:
            cluster_template[eid] = ("evaluator", 0)
        elif master_node and eid == 0:
            cluster_template[eid] = (master_node, 0)
        else:
            cluster_template[eid] = ("worker", worker_idx)
            worker_idx += 1

    server = reservation.Server(num_executors)
    server_addr = server.start()

    if num_chips_per_executor is None:
        from tensorflowonspark_torch import chip_info

        num_chips_per_executor = chip_info.get_num_host_chips()

    cluster_meta = {
        "id": uuid.uuid4().hex[:12],
        "num_executors": num_executors,
        "server_addr": list(server_addr),
        "auth_token": server.auth_token,
        "authkey_hex": secrets.token_hex(16),
        "cluster_template": cluster_template,
        "input_mode": "spark" if input_mode is InputMode.SPARK else "tensorflow",
        "queues": queues or ["input", "output", "error"],
        "num_chips": num_chips_per_executor,
        "num_ps": num_ps,
        "feed_chunk": feed_chunk,
        "default_fs": default_fs or "file://",
        "reservation_timeout": reservation_timeout,
        "health_probe": health_probe,
        "health_probe_timeout": health_probe_timeout,
    }

    node_fn = TFSparkNode.run(map_fun, tf_args, cluster_meta, tensorboard, log_dir)
    cluster_holder: dict[str, Any] = {}
    thread_error: list[BaseException] = []

    def _bootstrap_job():
        try:
            sc.parallelize(range(num_executors), num_executors).foreachPartition(
                node_fn
            )
        except BaseException as e:  # surfaced via _check_bootstrap_error
            logger.error("cluster bootstrap job failed: %s", e)
            thread_error.append(e)
            # drain the node error queues NOW, while their managers are
            # still alive: the orphan watch reaps a dead trainer's manager
            # after ~15 s, and with it the stall/stacktrace attribution
            # Cached on the cluster for
            # _check_bootstrap_error to attach later.
            cluster = cluster_holder.get("cluster")
            if cluster is not None:
                try:
                    cluster._drain_node_errors()
                except Exception:
                    pass

    t = threading.Thread(target=_bootstrap_job, name="tfos-bootstrap", daemon=True)
    t.start()

    # wait in short chunks so a fast bootstrap failure (chip exhaustion,
    # collision guard, …) surfaces immediately instead of after the timeout
    import time as _time

    deadline = _time.monotonic() + reservation_timeout
    with obs.span("cluster.reserve", num_executors=num_executors,
                  cluster_id=cluster_meta["id"]):
        while True:
            sick = server.kv_get("health_error")
            if sick:
                server.stop()
                raise RuntimeError(f"node failed chip health probe: {sick}")
            if thread_error:
                server.stop()
                raise RuntimeError(
                    "cluster bootstrap failed") from thread_error[0]
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                server.stop()
                raise TimeoutError(
                    f"timed out after {reservation_timeout}s waiting for "
                    f"{server.reservations.remaining()} of {num_executors} "
                    "nodes"
                )
            try:
                cluster_info = server.await_reservations(
                    timeout=min(1.0, remaining))
                break
            except TimeoutError:
                continue
    logger.info("cluster formed: %d nodes", len(cluster_info))

    cluster = TFCluster(sc, cluster_meta, cluster_info, server, input_mode, t)
    cluster._thread_error = thread_error
    cluster_holder["cluster"] = cluster  # lets the job thread drain eagerly
    return cluster
