"""Observability subsystem: tracing + structured event log + metrics export.

A copy of ``tensorflowonspark_tpu/obs`` with its imports rewritten, less
``roofline`` (it measures bandwidth with JAX programs and waits for its
port), so the copied cluster modules keep their instrumentation as it is.

Three layers over ONE event model (SURVEY.md §5 notes the
reference had "Python logging ... no metrics registry"):

- **tracing** (:mod:`.trace`) — ``obs.span("reserve")`` context-manager /
  decorator spans and ``obs.event(...)`` instants, recorded into a bounded
  per-process ring buffer and shipped executor→driver over the TFManager
  kv blackboard;
- **structured event log / Chrome trace** (:mod:`.chrome`) —
  ``TFCluster.dump_trace(path)`` merges every node's events into one
  Chrome-trace-format file (deterministic; schema-checked by
  ``tools/check_trace.py``);
- **metrics export** (:mod:`.registry`) — counters / gauges / histograms
  with Prometheus text exposition and a JSON snapshot, published with the
  step metrics and aggregated by ``TFCluster.metrics()`` /
  ``TFCluster.metrics_prometheus()``.

Plus the measurement-integrity layer on top:

- **anomaly attribution** (:mod:`.anomaly`) — driver-side straggler /
  stall detection over the shipped per-node step-time histograms
  (``TFCluster.check_anomalies()``);
- **live endpoint** (:mod:`.httpd`) — ``TFCluster.serve_observability``'s
  stdlib HTTP server (``/metrics`` Prometheus, ``/healthz``, ``/trace``,
  ``/pipeline``).

And the pipeline flight recorder:

- **flight recorder** (:mod:`.flight`) — always-on per-stage time
  attribution across the training feed and serving data planes, with a
  per-batch bottleneck verdict (feed-starved / device-bound / emit-bound /
  queue-backpressured); rendered live on ``/pipeline``, judged by
  ``TFCluster.check_anomalies()`` (persistent feed starvation is a
  finding), and stamped by ``bench.py`` into every artifact as a
  wall-time-reconciled stage breakdown.  ``TFOS_FLIGHT=0`` disables,
  ``TFOS_FLIGHT_SAMPLE=N`` thins the histogram traffic.

The flight recorder also attributes the continuous-batching online
serving tier (plane ``"online"``:
``wait``/``coalesce``/``pad``/``compute``/``reply``) and the generative
decode tier (plane ``"decode"``: ``wait``/``prefill``/``decode`` with
``prefill_bound``/``decode_bound`` verdicts — the two decode phases have
different remedies, so they classify apart), and those tiers' counters
and latency histograms (per-tenant request seconds; decode TTFT/ITL SLO
histograms) live in the same registry
(:mod:`tensorflowonspark_torch.online`,
:mod:`tensorflowonspark_torch.decode`).

And the fleet incident plane:

- **event journal** (:mod:`.journal`) — every control-plane transition
  (placement flips + applied confirmations, replica join/death/regroup
  with its generation fence, admission sheds, ``slo.burn`` fire/clear,
  compile-cache spools, decode slot lifecycle) appended as a typed event
  with a hybrid ``(gen, ts, node, pid, seq)`` ordering key so one total
  causal order survives clock skew; cadence-flushed through the fs seam
  (``TFOS_JOURNAL_DIR``) so it survives SIGKILL; federated with
  since-cursor pagination on ``GET /fleet/events``; black-box crash
  dumps bundle journal tail + trace ring + flight records + metrics on
  SIGTERM/anomaly; ``tools/incident.py`` merges it all into one
  Perfetto timeline.  ``TFOS_JOURNAL=0`` disables.

And the cost accounting plane:

- **cost + goodput ledgers** (:mod:`.ledger`) — per-tenant device-second
  / row / token / byte / compile-second apportionment across the online,
  decode, and serve planes (labeled Prometheus families with an
  un-apportioned engine denominator, so Σ tenants ≡ engine busy — the
  conservation identity ``bench.py --costs`` proves), plus a training
  goodput ledger folding flight stages, checkpoint saves, and elastic
  recovery windows into a productive / input_wait / compile /
  checkpoint / recovery / stall wall-clock breakdown; federated into
  ``GET /fleet/costs`` and the ``fleet.cost_skew`` finding, merged into
  chargeback reports by ``tools/costs.py``.  ``TFOS_LEDGER=0``
  disables.

Instrumented out of the box: cluster lifecycle (``TFCluster`` /
``TFSparkNode`` bootstrap, reserve, probe, shutdown), the trainer
(``trainer.Trainer`` init + step counters, and step spans), the data feed
(``TFNode.DataFeed`` / ``readers``), checkpointing (``ckpt``), health
probes (``health``), serving (``pipeline``), and ``bench.py`` (which
writes a trace artifact even for degraded runs, attributing the probe
timeout).  ``TFOS_TRACE=0`` disables recording.
"""

from tensorflowonspark_torch.obs import (  # noqa: F401
    anomaly,
    chrome,
    fleet,
    flight,
    httpd,
    journal,
    ledger,
    trace,
)
from tensorflowonspark_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    gauge,
    get_registry,
    histogram,
    merge_snapshots,
    merged_to_prometheus,
    relabel_snapshot,
    snapshot_to_openmetrics,
    snapshot_to_prometheus,
)
from tensorflowonspark_torch.obs.trace import (  # noqa: F401
    TRACE_KV_PREFIX,
    RequestTrace,
    TraceContext,
    TraceStore,
    Tracer,
    collect_blackboard,
    configure,
    event,
    flush,
    format_traceparent,
    get_trace_store,
    get_tracer,
    merge_request_docs,
    parse_traceparent,
    span,
    trace_context,
    with_context,
)

__all__ = [
    "anomaly", "chrome", "fleet", "flight", "httpd", "journal",
    "trace",
    "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "histogram", "get_registry",
    "merge_snapshots", "merged_to_prometheus", "relabel_snapshot",
    "snapshot_to_prometheus", "snapshot_to_openmetrics",
    "TRACE_KV_PREFIX", "Tracer", "collect_blackboard", "configure",
    "event", "flush", "get_tracer", "span",
    "TraceContext", "RequestTrace", "TraceStore", "get_trace_store",
    "parse_traceparent", "format_traceparent", "merge_request_docs",
    "trace_context", "with_context",
]
