"""Admission pieces of the online serving tier that the decode tier uses.

Reference anchor: ``tensorflowonspark_tpu/online.py``.  This module holds
only :class:`Rejected` (``online.py:181``) and the tumbling shed window
(:class:`_ShedWindow` / :data:`ShedWindow`, ``:300``, ``:345``), copied
with their imports rewritten: ``decode.DecodeEngine`` raises the first and
surfaces the second on its ``/healthz`` admission block.  The rest of the
online tier (the request-granularity coalescer, tenants, the router's
view) is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import time
from typing import Any

#: tumbling shed-window interval (seconds); the window covers the last
#: one to two of them
SHED_WINDOW_INTERVAL_S = 30.0


class Rejected(RuntimeError):
    """Request shed by admission control — HTTP 429 semantics.

    The pending queue is over its bound; the caller should back off
    ``retry_after_s`` and retry.  Shedding is *loud by design*: the caller
    always gets this exception — there is no path on which a request is
    silently dropped or left waiting forever.
    """

    def __init__(self, message: str, retry_after_s: float = 0.05):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


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
#: its /healthz admission block)
ShedWindow = _ShedWindow
