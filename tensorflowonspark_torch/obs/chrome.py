"""Chrome-trace-format emission: merge per-node event logs into one file.

The output is the Trace Event Format JSON object consumed by
``chrome://tracing`` / Perfetto: ``{"traceEvents": [...]}`` where every
span is a *complete* event (``"ph": "X"`` with ``ts``/``dur`` in
microseconds), instants are ``"ph": "i"``, and one ``process_name``
metadata event (``"ph": "M"``) names each node — the driver and every
executor render as separate process tracks on one shared wall-clock
timeline: the "where did the 60 s go" view of a degraded run.

The merge is **deterministic**: node names sort lexicographically to
stable pids, events sort by ``(ts, pid, tid, name)``, and the emitted
JSON uses sorted keys — identical inputs always produce byte-identical
files (asserted by ``tests/test_obs.py``; schema-checked by
``tools/check_trace.py``).
"""

from __future__ import annotations

import json
from typing import Any

#: event phases the schema (and tools/check_trace.py) accepts
VALID_PHASES = ("X", "i", "M")

#: pid reserved for the driver so it always renders as the first track
DRIVER_NODE = "driver"


def merge(events_by_node: dict[str, list[dict[str, Any]]]) -> dict[str, Any]:
    """Merge per-node event lists into one Chrome-trace JSON object."""
    nodes = sorted(events_by_node,
                   key=lambda n: (n != DRIVER_NODE, n))  # driver first
    pids = {node: i + 1 for i, node in enumerate(nodes)}
    out: list[dict[str, Any]] = []
    for node in nodes:
        out.append({
            "ph": "M",
            "name": "process_name",
            "pid": pids[node],
            "tid": 0,
            "args": {"name": node},
        })
    rows: list[dict[str, Any]] = []
    for node in nodes:
        for ev in events_by_node[node]:
            ph = ev.get("ph", "X")
            if ph not in VALID_PHASES or ph == "M":
                continue
            row: dict[str, Any] = {
                "name": str(ev.get("name", "?")),
                "ph": ph,
                "ts": float(ev.get("ts", 0.0)),
                "pid": pids[node],
                "tid": int(ev.get("tid", 0)),
            }
            if ph == "X":
                row["dur"] = float(ev.get("dur", 0.0))
            if ph == "i":
                row["s"] = "t"  # thread-scoped instant
            attrs = ev.get("attrs")
            if attrs:
                row["args"] = dict(attrs)
            # trace identity rides into the Chrome args so a finding's
            # cited trace_id is searchable in the viewer (copied, never
            # mutating the source event)
            for field in ("trace_id", "span_id", "parent_span_id"):
                if ev.get(field):
                    row.setdefault("args", {})[field] = ev[field]
            rows.append(row)
    rows.sort(key=lambda r: (r["ts"], r["pid"], r["tid"], r["name"]))
    return {"traceEvents": out + rows, "displayTimeUnit": "ms"}


def write(path: str, events_by_node: dict[str, list[dict[str, Any]]]) -> str:
    """Write the merged trace to ``path``; returns ``path``."""
    doc = merge(events_by_node)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return path
