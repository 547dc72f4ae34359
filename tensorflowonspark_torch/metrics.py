"""Step-metrics hook: one code path from trainer loop to driver aggregation.

A copy of ``tensorflowonspark_tpu/metrics.py`` with its imports rewritten;
a snapshot forces the loss with torch, which reads a tensor on the card.

Reference anchor: the reference has **no metrics registry** (``SURVEY.md §5``
metrics row: "Python logging ... no metrics registry"); its examples log
ad-hoc strings and the TFManager kv doubles as a blackboard.  The TPU
rebuild keeps the blackboard but formalises the path:

- :class:`StepMetrics` — rolling window over ``(loss, examples, dt)``
  records; snapshots expose ``step``, ``loss``, ``examples_per_sec``.
- :class:`MetricsReporter` — a ``Trainer`` step callback that publishes
  snapshots to the node's kv blackboard (``ctx.mgr.set("metrics", ...)``)
  every ``interval`` steps.  Loss is forced to a host float only at publish
  time, so the async dispatch pipeline is not broken per-step.
- ``TFCluster.metrics()`` (driver side) collects every node's snapshot and
  sums throughput — replacing ad-hoc ``ctx.mgr.set("images_per_sec")``
  calls.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any

logger = logging.getLogger(__name__)


class StepMetrics:
    """Rolling per-step training metrics.

    ``record`` is cheap (deque append); ``snapshot`` computes the windowed
    examples/sec and forces the last loss to a host float (one device sync).
    """

    def __init__(self, window: int = 50):
        self.window = window
        self.step = 0
        self.total_examples = 0
        self._records: collections.deque = collections.deque(maxlen=window)
        self._last_loss: Any = None
        self._t_start = time.perf_counter()

    def record(self, loss: Any, examples: int, dt: float) -> None:
        self.step += 1
        self.total_examples += examples
        if dt > 0:  # step 1 has no predecessor: a (n, 0.0) record would
            self._records.append((examples, dt))  # inflate the windowed rate
        self._last_loss = loss

    def snapshot(self) -> dict[str, Any]:
        ex = sum(e for e, _ in self._records)
        secs = sum(d for _, d in self._records)
        loss = self._last_loss
        if loss is not None:
            try:  # device scalars are forced only here
                import torch

                loss = float(torch.as_tensor(loss).float().mean())
            except Exception:
                loss = None
        return {
            "step": self.step,
            "loss": loss,
            "examples_per_sec": round(ex / secs, 2) if secs > 0 else None,
            "total_examples": self.total_examples,
            "elapsed_sec": round(time.perf_counter() - self._t_start, 3),
        }


class MetricsReporter:
    """Trainer step callback that publishes to the node kv blackboard.

    Usable directly: ``trainer.add_step_callback(MetricsReporter(ctx))``.
    The published dict lands under the ``"metrics"`` key of the node's
    manager, where ``TFCluster.metrics()`` collects it.
    """

    def __init__(self, ctx=None, interval: int = 10, window: int = 50,
                 key: str = "metrics", mgr=None, registry=None):
        self._mgr = mgr if mgr is not None else (ctx.mgr if ctx else None)
        self.interval = max(1, interval)
        self.key = key
        self.stats = StepMetrics(window=window)
        #: obs registry whose snapshot rides along with each publication
        #: (None → the process-default registry; pass a fresh
        #: ``obs.Registry()`` to isolate).  The driver's
        #: ``TFCluster.metrics()`` merges the per-node snapshots.
        self._registry = registry

    def __call__(self, loss: Any, examples: int, dt: float) -> None:
        self.stats.record(loss, examples, dt)
        if self.stats.step % self.interval == 0:
            self.publish()

    def publish(self) -> dict[str, Any]:
        snap = self.stats.snapshot()
        reg = self._registry
        if reg is None:
            from tensorflowonspark_torch import obs

            reg = obs.get_registry()
        if len(reg):
            snap["registry"] = reg.snapshot()
        if self._mgr is not None:
            try:
                self._mgr.set(self.key, snap)
            except Exception as e:  # metrics must never kill training
                logger.warning("metrics publish failed: %s", e)
            # piggyback a trace flush on the same cadence: the trainer's
            # spans reach the blackboard while it runs, not only at exit
            try:
                from tensorflowonspark_torch import obs

                obs.get_tracer().flush(self._mgr)
            except Exception:
                pass
        return snap


def aggregate(node_metrics: dict[str, dict[str, Any]]) -> dict[str, Any]:
    """Cluster-level rollup of per-node snapshots (driver side).

    ``mean_loss`` is weighted by each node's ``total_examples`` (nodes that
    processed more data count proportionally; falls back to an unweighted
    mean when no node reports example counts).  Nodes marked ``stale``
    (finished/unreachable, last snapshot retained by ``TFCluster.metrics``)
    keep contributing to the loss but are excluded from the live
    ``total_examples_per_sec`` sum.

    Node snapshots may carry an obs-registry section (``"registry"``,
    published by :class:`MetricsReporter` when the node recorded any
    counters/gauges/histograms); those merge cluster-wide into the
    rollup's ``"registry"`` key (``obs.merge_snapshots`` semantics:
    counters and histograms sum, gauges stay per-node).
    """
    totals = [m.get("examples_per_sec") for m in node_metrics.values()
              if m and m.get("examples_per_sec") and not m.get("stale")]
    weighted = [(m["loss"], m.get("total_examples") or 0)
                for m in node_metrics.values()
                if m and m.get("loss") is not None]
    mean_loss = None
    if weighted:
        wsum = sum(w for _, w in weighted)
        if wsum > 0:
            mean_loss = sum(l * w for l, w in weighted) / wsum
        else:
            mean_loss = sum(l for l, _ in weighted) / len(weighted)
        mean_loss = round(mean_loss, 6)
    out = {
        "nodes": node_metrics,
        "num_reporting": len(node_metrics),
        "total_examples_per_sec": round(sum(totals), 2) if totals else None,
        "mean_loss": mean_loss,
    }
    registries = {name: m["registry"] for name, m in node_metrics.items()
                  if m and isinstance(m.get("registry"), dict)}
    if registries:
        from tensorflowonspark_torch import obs

        out["registry"] = obs.merge_snapshots(registries)
        # per-node step-time p50/p95 straight in the rollup: the merged
        # registry sums histograms cluster-wide, but straggler judgment
        # (obs.anomaly) and operators both need the PER-NODE view without
        # digging through raw buckets
        quantiles = obs.anomaly.step_time_quantiles(out)
        if quantiles:
            out["step_time_quantiles"] = quantiles
    return out
