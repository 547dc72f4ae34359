"""RDD subset for the local Spark substrate.

Lazy per-partition transform chains over driver-resident partition payloads;
actions ship ``(payload, chain, action)`` to executor processes via
``LocalSparkContext.run_job``.  Covers the RDD surface the orchestration
layer and its tests touch (``SURVEY.md §3``): ``mapPartitions`` /
``foreachPartition`` / ``map`` / ``collect`` are the load-bearing ones.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


def _fresh_copy(rows: list) -> list:
    """Deep copies via a pickle round-trip — the same copies executor IPC
    would have produced, minus the process hop."""
    import pickle

    try:
        return pickle.loads(pickle.dumps(rows))
    except Exception:  # exotic row types: cloudpickle, like run_job does
        import cloudpickle

        return pickle.loads(cloudpickle.dumps(rows))


def _collect_action(_pindex: int, it: Iterator) -> list:
    return list(it)


def _count_action(_pindex: int, it: Iterator) -> int:
    return sum(1 for _ in it)


class _Foreach:
    def __init__(self, f: Callable[[Iterator], Any]):
        self.f = f

    def __call__(self, _pindex: int, it: Iterator) -> None:
        self.f(it)
        return None


class _MapPartitions:
    def __init__(self, f: Callable[[Iterator], Iterable], with_index: bool):
        self.f = f
        self.with_index = with_index

    def __call__(self, pindex: int, it: Iterator) -> Iterator:
        out = self.f(pindex, it) if self.with_index else self.f(it)
        return iter(out)


class RDD:
    def __init__(self, sc, partitions: list[Any], chain: list | None = None):
        self._sc = sc
        self._partitions = partitions
        self._chain = chain or []
        self._cached = False

    # -- transformations (lazy) -------------------------------------------

    def mapPartitions(self, f: Callable[[Iterator], Iterable],
                      preservesPartitioning: bool = False) -> "RDD":
        return RDD(self._sc, self._partitions,
                   self._chain + [_MapPartitions(f, with_index=False)])

    def mapPartitionsWithIndex(self, f: Callable[[int, Iterator], Iterable],
                               preservesPartitioning: bool = False) -> "RDD":
        return RDD(self._sc, self._partitions,
                   self._chain + [_MapPartitions(f, with_index=True)])

    def map(self, f: Callable[[Any], Any]) -> "RDD":
        return self.mapPartitions(_MapImpl(f))

    def flatMap(self, f: Callable[[Any], Iterable]) -> "RDD":
        return self.mapPartitions(_FlatMapImpl(f))

    def filter(self, f: Callable[[Any], bool]) -> "RDD":
        return self.mapPartitions(_FilterImpl(f))

    def union(self, other: "RDD") -> "RDD":
        if self._chain or other._chain:
            # materialize both sides so the union has a single empty chain
            left = self._sc.run_job(self._partitions, self._chain, _collect_action)
            right = other._sc.run_job(other._partitions, other._chain, _collect_action)
            return RDD(self._sc, left + right)
        return RDD(self._sc, self._partitions + other._partitions)

    def repartition(self, numPartitions: int) -> "RDD":
        items = self.collect()
        return self._sc.parallelize(items, numPartitions)

    def coalesce(self, numPartitions: int, shuffle: bool = False) -> "RDD":
        return self.repartition(numPartitions)

    def cache(self) -> "RDD":
        """Materialize on first action, then reuse (single storage level)."""
        self._cached = True
        return self

    def persist(self, *_a, **_kw) -> "RDD":
        return self.cache()

    def _resolved(self) -> tuple[list, list]:
        """(partitions, chain), collapsing the chain once if cache() was
        requested — later actions reuse the computed partitions."""
        if self._cached and self._chain:
            self._partitions = self._sc.run_job(
                self._partitions, self._chain, _collect_action
            )
            self._chain = []
        return self._partitions, self._chain

    def zipWithIndex(self) -> "RDD":
        items = self.collect()
        return self._sc.parallelize(
            [(x, i) for i, x in enumerate(items)], self.getNumPartitions()
        )

    # -- actions -----------------------------------------------------------

    def getNumPartitions(self) -> int:
        return len(self._partitions)

    def collect(self) -> list:
        partitions, chain = self._resolved()
        if not chain:
            # already-materialized (cached / parallelized) data: no point
            # round-tripping it through worker IPC for an identity job.
            # Copies keep pyspark semantics (caller mutations must not
            # corrupt the stored partitions).
            return _fresh_copy([x for part in partitions for x in part])
        parts = self._sc.run_job(partitions, chain, _collect_action)
        return [x for part in parts for x in part]

    def count(self) -> int:
        partitions, chain = self._resolved()
        if not chain:
            return sum(len(part) for part in partitions)
        return sum(self._sc.run_job(partitions, chain, _count_action))

    def take(self, n: int) -> list:
        """Compute partitions incrementally until ``n`` items are collected
        (pyspark semantics — a 1-row sample does not run the whole job)."""
        partitions, chain = self._resolved()
        out: list = []
        for i, part in enumerate(partitions):
            if len(out) >= n:
                break
            if not chain:
                out.extend(_fresh_copy(list(part)))
                continue
            res = self._sc.run_job([part], chain, _collect_action,
                                   base_index=i)
            out.extend(res[0])
        return out[:n]

    def first(self) -> Any:
        out = self.take(1)
        if not out:
            raise ValueError("RDD is empty")
        return out[0]

    def foreachPartition(self, f: Callable[[Iterator], Any]) -> None:
        partitions, chain = self._resolved()
        self._sc.run_job(partitions, chain, _Foreach(f))

    def foreach(self, f: Callable[[Any], Any]) -> None:
        self.foreachPartition(_ForeachEach(f))

    def isEmpty(self) -> bool:
        return self.count() == 0


class _MapImpl:
    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        return (self.f(x) for x in it)


class _FlatMapImpl:
    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        return (y for x in it for y in self.f(x))


class _FilterImpl:
    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        return (x for x in it if self.f(x))


class _ForeachEach:
    def __init__(self, f):
        self.f = f

    def __call__(self, it):
        for x in it:
            self.f(x)
