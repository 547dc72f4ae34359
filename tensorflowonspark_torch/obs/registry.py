"""Metrics registry: counters, gauges, histograms → Prometheus / JSON.

Extends the step-metrics hook (``metrics.StepMetrics`` /
``MetricsReporter``) into a small general registry (the reference has none —
SURVEY.md §5).  Same delivery path as the step metrics: instruments record
locally (lock-protected, allocation-free on the hot path), the per-node
snapshot rides the kv blackboard inside the ``MetricsReporter`` publication,
and the driver's generalized ``TFCluster.metrics()`` merges node snapshots
(:func:`merge_snapshots`).  Two export formats:

- :meth:`Registry.snapshot` — a plain JSON-able dict;
- :meth:`Registry.to_prometheus` — Prometheus text exposition (v0.0.4),
  driver-side ``TFCluster.metrics_prometheus()`` exposes the merged view
  with a ``node`` label per series.

Two extensions ride the same model:

- **labeled series**: ``counter/gauge/histogram(..., labels={"tenant":
  "a"})`` get-or-create one series per label set under a shared family
  (one ``# TYPE`` line, standard ``name{tenant="a"}`` exposition).  A
  series is stored under its full series key (``name{k="v"}``, sorted
  labels), so snapshots and cross-node merges need no schema change.
  Cardinality is bounded per family (``TFOS_METRIC_SERIES_MAX``, default
  128): past the bound new label sets collapse into one ``_overflow``
  series (loud, once) instead of growing without limit, and
  :meth:`Registry.remove` evicts a series with its owner (a removed
  tenant takes its series with it).
- **exemplars**: ``Histogram.observe(v, exemplar={"trace_id": ...})``
  remembers the last exemplar per bucket; classic exposition is
  byte-identical with or without them, the OpenMetrics flavor
  (:func:`snapshot_to_openmetrics`, ``Accept:
  application/openmetrics-text``) appends ``# {trace_id="..."} value ts``
  to the owning bucket line — the link from an alerting p99 straight to a
  retained request trace.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import Any, Iterable

logger = logging.getLogger(__name__)

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    60.0, float("inf"))


class Counter:
    """Monotonically increasing value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable value (last write wins; inc/dec for up-down counting)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != float("inf"):
            bounds.append(float("inf"))
        self.bounds = tuple(bounds)
        self._counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0
        #: last exemplar per bucket index: (labels, value, unix ts) — set
        #: only when an observe carries one, so a histogram that never
        #: sees exemplars exports exactly what it always did
        self._exemplars: dict[int, tuple[dict[str, str], float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, v: float,
                exemplar: dict[str, str] | None = None) -> None:
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    if exemplar:
                        self._exemplars[i] = (dict(exemplar), float(v),
                                              time.time())
                    break

    def cumulative(self) -> list[tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` — Prometheus bucket shape."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for b, c in zip(self.bounds, counts):
            running += c
            out.append((b, running))
        return out

    def export(self) -> dict[str, Any]:
        """Atomic ``{"buckets", "sum", "count"}`` export: buckets, sum and
        count are read under ONE lock acquisition so a concurrent
        ``observe`` cannot tear the snapshot (count must equal the +Inf
        bucket — the Prometheus histogram invariant scrape consumers
        rely on).  An ``"exemplars"`` key (``{le_str: [labels, value,
        ts]}``) is present only when exemplars were ever recorded, so the
        exemplar-free export shape is unchanged."""
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
            exemplars = {i: (dict(lab), v, ts)
                         for i, (lab, v, ts) in self._exemplars.items()}
        buckets, running = [], 0
        for b, c in zip(self.bounds, counts):
            running += c
            buckets.append(["+Inf" if b == float("inf") else b, running])
        out: dict[str, Any] = {"buckets": buckets, "sum": s, "count": total}
        if exemplars:
            out["exemplars"] = {
                _fmt(self.bounds[i]): [lab, v, ts]
                for i, (lab, v, ts) in sorted(exemplars.items())}
        return out


#: per-family labeled-series cap (``TFOS_METRIC_SERIES_MAX`` overrides):
#: past it, new label sets collapse into one ``_overflow`` series — a
#: tenant-per-series registry must not become an unbounded memory leak
#: when tenant names are attacker- or workload-controlled
_DEFAULT_SERIES_MAX = 128


def _series_max() -> int:
    try:
        return max(1, int(os.environ.get("TFOS_METRIC_SERIES_MAX",
                                         _DEFAULT_SERIES_MAX)))
    except ValueError:
        return _DEFAULT_SERIES_MAX


_LABEL_NAME_OK_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_LABEL_NAME_BAD_RE = re.compile(r"[^a-zA-Z0-9_]")


def _safe_label(name: str) -> str:
    """Coerce an arbitrary string into a legal Prometheus label name.

    Caller-supplied label keys (tenant ids, exemplar annotations) can
    carry characters the exposition grammar forbids; emitting them
    verbatim would poison the whole scrape.  Invalid runes become ``_``,
    a leading digit gets an underscore prefix, empty becomes ``_``.
    Distinct unsafe names may collide after sanitization — that loses a
    label dimension, never the exposition."""
    name = str(name)
    if _LABEL_NAME_OK_RE.match(name):
        return name
    name = _LABEL_NAME_BAD_RE.sub("_", name) or "_"
    if name[0].isdigit():
        name = "_" + name
    return name


def series_key(name: str, labels: dict[str, str] | None) -> str:
    """Full series key: ``name{k="v",...}`` with sorted, escaped labels
    (the snapshot/merge key AND the exposition series identity).  Label
    names are sanitized (:func:`_safe_label`) so no caller-supplied key
    can emit an unparseable series."""
    if not labels:
        return name
    safe: dict[str, str] = {}
    for k, v in sorted(labels.items()):  # collisions: last raw key wins
        safe[_safe_label(k)] = v
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(safe.items()))
    return f"{name}{{{inner}}}"


_SERIES_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def split_series(series: str) -> tuple[str, dict[str, str]]:
    """``'fam{a="b"}'`` → ``("fam", {"a": "b"})``; plain names pass
    through with empty labels.  Inverse of :func:`series_key` for the
    keys this module generates."""
    i = series.find("{")
    if i < 0:
        return series, {}
    return series[:i], {
        k: _unescape(v)
        for k, v in _SERIES_LABEL_RE.findall(series[i + 1:-1])}


class Registry:
    """Named instruments; get-or-create accessors are idempotent."""

    def __init__(self):
        self._instruments: dict[str, Any] = {}
        self._family_series: dict[str, int] = {}
        #: labeled series that COUNTED toward their family's bound —
        #: remove() must only decrement for these (the shared _overflow
        #: series is created uncounted; decrementing for it would erode
        #: the cardinality cap one removal at a time)
        self._counted_series: set[str] = set()
        self._family_warned: set[str] = set()
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, **kwargs)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"{name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def _labeled(self, family: str, labels: dict[str, str], cls, **kwargs):
        """Get-or-create one series of a labeled family, bounding the
        family's cardinality (over the bound, label sets collapse into a
        single ``_overflow`` series — loud once, never unbounded)."""
        key = series_key(family, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise TypeError(
                        f"{key!r} already registered as "
                        f"{type(inst).__name__}, not {cls.__name__}")
                return inst
            if self._family_series.get(family, 0) >= _series_max():
                if family not in self._family_warned:
                    self._family_warned.add(family)
                    logger.warning(
                        "metric family %r hit its %d-series label-"
                        "cardinality bound; further label sets collapse "
                        "into an '_overflow' series (raise "
                        "TFOS_METRIC_SERIES_MAX or remove() series with "
                        "their owners)", family, _series_max())
                key = series_key(family,
                                 {k: "_overflow" for k in labels})
                inst = self._instruments.get(key)
                if inst is None:
                    inst = self._instruments[key] = cls(key, **kwargs)
                return inst
            inst = self._instruments[key] = cls(key, **kwargs)
            self._family_series[family] = \
                self._family_series.get(family, 0) + 1
            self._counted_series.add(key)
            return inst

    def counter(self, name: str, help: str = "",
                labels: dict[str, str] | None = None) -> Counter:
        if labels:
            return self._labeled(name, labels, Counter, help=help)
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "",
              labels: dict[str, str] | None = None) -> Gauge:
        if labels:
            return self._labeled(name, labels, Gauge, help=help)
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = _DEFAULT_BUCKETS,
                  labels: dict[str, str] | None = None) -> Histogram:
        if labels:
            return self._labeled(name, labels, Histogram, help=help,
                                 buckets=buckets)
        return self._get(name, Histogram, help=help, buckets=buckets)

    def peek(self, name: str, labels: dict[str, str] | None = None):
        """The instrument if it already exists, else None — a read that
        never registers.  For consumers of someone else's measurement
        (e.g. the trainer reading the roofline probe's gauge): the
        get-or-create accessors would mint a phantom 0.0 series in every
        process that merely ASKED, indistinguishable on /metrics from a
        measured zero."""
        with self._lock:
            return self._instruments.get(series_key(name, labels))

    def remove(self, name: str,
               labels: dict[str, str] | None = None) -> bool:
        """Drop one series (labeled or plain); True when it existed.

        The eviction half of bounded cardinality: a labeled series is
        removed WITH its owner (e.g. an online tenant being deregistered)
        so the family's bound frees up instead of filling with the dead.
        """
        key = series_key(name, labels)
        with self._lock:
            if self._instruments.pop(key, None) is None:
                return False
            if key in self._counted_series:
                self._counted_series.discard(key)
                if self._family_series.get(name, 0) > 0:
                    self._family_series[name] -= 1
            return True

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._family_series.clear()
            self._counted_series.clear()
            self._family_warned.clear()

    def __len__(self) -> int:
        return len(self._instruments)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """JSON-able snapshot: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {"buckets": [[le, n], ...], "sum", "count"}}}``.
        ``inf`` bucket bounds serialize as the string ``"+Inf"`` so the
        snapshot round-trips through strict-JSON consumers."""
        out: dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            if isinstance(inst, Counter):
                out["counters"][inst.name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][inst.name] = inst.value
            elif isinstance(inst, Histogram):
                out["histograms"][inst.name] = inst.export()
        return out

    def to_prometheus(self, prefix: str = "tfos_",
                      labels: dict[str, str] | None = None) -> str:
        return snapshot_to_prometheus(self.snapshot(), prefix=prefix,
                                      labels=labels)

    def to_openmetrics(self, prefix: str = "tfos_",
                       labels: dict[str, str] | None = None) -> str:
        return snapshot_to_openmetrics(self.snapshot(), prefix=prefix,
                                       labels=labels)


def _label_str(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    # one left-to-right pass: chained str.replace would corrupt values
    # like 'C:\\new' (the escaped '\\\\n' must decode to backslash + 'n',
    # not to a newline)
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


#: OpenMetrics cap on an exemplar's combined label name+value runes
_EXEMPLAR_LABEL_BUDGET = 128


def _exemplar_suffix(h: dict[str, Any], le_s: str) -> str:
    """OpenMetrics exemplar annotation for one bucket line ('' if none):
    `` # {trace_id="..."} value timestamp``.

    The spec caps an exemplar's combined label name+value length at 128
    runes; oversized values are truncated (before escaping, so no escape
    sequence is ever cut in half) rather than rejected — a too-chatty
    label must not cost the trace linkage."""
    ex = (h.get("exemplars") or {}).get(le_s)
    if not ex:
        return ""
    ex_labels, ex_value, ex_ts = ex
    budget = _EXEMPLAR_LABEL_BUDGET
    items: list[tuple[str, str]] = []
    # trace_id claims budget first — it IS the linkage — then the rest
    # in sorted order; emission order stays sorted below
    ordered = sorted((ex_labels or {}).items(),
                     key=lambda kv: (kv[0] != "trace_id", kv[0]))
    for k, v in ordered:
        k, v = _safe_label(k), str(v)
        room = budget - len(k)
        if room <= 0:  # not even the name fits: drop the label
            continue
        v = v[:room]
        budget -= len(k) + len(v)
        items.append((k, v))
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(items))
    out = " # {" + inner + "} " + _fmt(ex_value)
    if ex_ts:
        out += f" {round(float(ex_ts), 3)}"
    return out


def snapshot_to_prometheus(snap: dict[str, Any], prefix: str = "tfos_",
                           labels: dict[str, str] | None = None,
                           openmetrics: bool = False) -> str:
    """One snapshot (from :meth:`Registry.snapshot`) → text exposition.

    Series keys may carry labels (``name{tenant="a"}``): series of one
    family group under a single ``# TYPE`` line, label-less output is
    byte-identical to what this always emitted.  ``openmetrics=True``
    additionally annotates histogram bucket lines with their exemplars
    (the classic v0.0.4 format has no exemplar syntax, so they are
    omitted there) — use :func:`snapshot_to_openmetrics` for the full
    OpenMetrics document (adds the ``# EOF`` terminator).
    """
    lines: list[str] = []

    def sorted_series(section: str):
        items = [(split_series(series), series, val)
                 for series, val in snap.get(section, {}).items()]
        # group a family's series together (grouped exposition), plain
        # names reduce to today's plain sorted() order
        items.sort(key=lambda it: (it[0][0], series_key(*it[0])))
        return [(fam, lab, val) for (fam, lab), _, val in items]

    def emit_simple(section: str, typ: str) -> None:
        typed: set[str] = set()
        for fam, lab, val in sorted_series(section):
            metric = prefix + fam
            if metric not in typed:
                typed.add(metric)
                lines.append(f"# TYPE {metric} {typ}")
            lines.append(
                f"{metric}{_label_str({**lab, **(labels or {})})} "
                f"{_fmt(val)}")

    emit_simple("counters", "counter")
    emit_simple("gauges", "gauge")
    typed: set[str] = set()
    for fam, lab, h in sorted_series("histograms"):
        metric = prefix + fam
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} histogram")
        base = {**lab, **(labels or {})}
        for le, n in h.get("buckets", []):
            le_s = "+Inf" if le in ("+Inf", float("inf")) else _fmt(le)
            bl = dict(base)
            bl["le"] = le_s
            line = f"{metric}_bucket{_label_str(bl)} {_fmt(n)}"
            if openmetrics:
                line += _exemplar_suffix(h, le_s)
            lines.append(line)
        lines.append(f"{metric}_sum{_label_str(base)} {_fmt(h['sum'])}")
        lines.append(f"{metric}_count{_label_str(base)} {_fmt(h['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_to_openmetrics(snap: dict[str, Any], prefix: str = "tfos_",
                            labels: dict[str, str] | None = None) -> str:
    """OpenMetrics-flavored exposition: same sample lines, histogram
    exemplars annotated onto their bucket lines, terminated by the
    mandatory ``# EOF``.  Served on ``/metrics`` when the scraper sends
    ``Accept: application/openmetrics-text``."""
    return snapshot_to_prometheus(snap, prefix=prefix, labels=labels,
                                  openmetrics=True) + "# EOF\n"


def relabel_snapshot(snap: dict[str, Any], labels: dict[str, str],
                     override: bool = True) -> dict[str, Any]:
    """A snapshot with ``labels`` merged into every series key.

    The federation primitive: the fleet collector relabels
    each replica's scraped snapshot with ``{"replica": id}`` before
    merging, so N per-process registries become one document whose
    series stay distinct per replica while families share one ``# TYPE``
    line.  Existing labels are preserved; on a clashing key,
    ``override=True`` (the default, for SCRAPED snapshots) lets
    ``labels`` win — a replica must not be able to spoof another's
    series — while ``override=False`` (for the federator's own TRUSTED
    registry) keeps the existing label: the router's per-replica
    ``fleet_scrape_stale_seconds{replica=…}`` gauges must not collapse
    into one ``replica="router"`` series.  Values are not copied
    deeply: the result shares histogram dicts with the input (treat
    both as read-only snapshots).
    """
    out: dict[str, Any] = {}
    for section in ("counters", "gauges", "histograms"):
        relabeled = {}
        for series, val in (snap.get(section) or {}).items():
            fam, lab = split_series(series)
            merged = {**lab, **labels} if override else {**labels, **lab}
            relabeled[series_key(fam, merged)] = val
        out[section] = relabeled
    return out


def merged_to_prometheus(merged: dict[str, Any],
                         prefix: str = "tfos_") -> str:
    """Exposition of a :func:`merge_snapshots` result: counters and
    histograms as single cluster-wide series, gauges one series per node
    (``node`` label)."""
    lines: list[str] = []
    single = {"counters": merged.get("counters", {}),
              "histograms": merged.get("histograms", {})}
    text = snapshot_to_prometheus(single, prefix=prefix)
    if text.strip():
        lines.append(text)
    typed: set[str] = set()
    for name, per_node in sorted(
            merged.get("gauges", {}).items(),
            key=lambda kv: (split_series(kv[0])[0], kv[0])):
        fam, lab = split_series(name)
        metric = prefix + fam
        if metric not in typed:
            typed.add(metric)
            lines.append(f"# TYPE {metric} gauge\n")
        for node, val in sorted(per_node.items()):
            lines.append(
                f"{metric}{_label_str({**lab, 'node': node})} "
                f"{_fmt(val)}\n")
    return "".join(lines)


def merge_snapshots(node_snaps: dict[str, dict[str, Any]]) -> dict[str, Any]:
    """Driver-side rollup of per-node registry snapshots.

    Counters and histograms sum across nodes (histograms bucket-wise by
    ``le``); gauges keep per-node values (summing a utilization gauge would
    be meaningless) under ``gauges[name][node]``.
    """
    out: dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
    for node in sorted(node_snaps):
        snap = node_snaps[node] or {}
        for name, val in snap.get("counters", {}).items():
            out["counters"][name] = out["counters"].get(name, 0.0) + val
        for name, val in snap.get("gauges", {}).items():
            out["gauges"].setdefault(name, {})[node] = val
        for name, h in snap.get("histograms", {}).items():
            agg = out["histograms"].setdefault(
                name, {"buckets": {}, "sum": 0.0, "count": 0})
            agg["sum"] += h.get("sum", 0.0)
            agg["count"] += h.get("count", 0)
            for le, n in h.get("buckets", []):
                key = "+Inf" if le in ("+Inf", float("inf")) else float(le)
                agg["buckets"][key] = agg["buckets"].get(key, 0) + n
            # exemplars: freshest per bucket wins across nodes (added
            # only when a node shipped some — exemplar-free merges keep
            # the historical shape)
            for le, ex in (h.get("exemplars") or {}).items():
                tgt = agg.setdefault("exemplars", {})
                cur = tgt.get(le)
                if cur is None or (ex[2] or 0) >= (cur[2] or 0):
                    tgt[le] = ex
    for h in out["histograms"].values():
        h["buckets"] = sorted(
            h["buckets"].items(),
            key=lambda kv: float("inf") if kv[0] == "+Inf" else kv[0])
        h["buckets"] = [[le, n] for le, n in h["buckets"]]
    return out


# -- module-level default registry (one per process) ------------------------

_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def counter(name: str, help: str = "",
            labels: dict[str, str] | None = None) -> Counter:
    return _REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: dict[str, str] | None = None) -> Gauge:
    return _REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = _DEFAULT_BUCKETS,
              labels: dict[str, str] | None = None) -> Histogram:
    return _REGISTRY.histogram(name, help, buckets, labels)
