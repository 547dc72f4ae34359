"""Driver-side context and executor pool for the local Spark substrate."""

from __future__ import annotations

import itertools
import logging
import multiprocessing
import queue as _queue_mod
import re
import threading
import time
import uuid
from typing import Any, Callable, Iterable, Sequence

from tensorflowonspark_torch.sparkapi.rdd import RDD

logger = logging.getLogger(__name__)

_MASTER_RE = re.compile(
    r"^(?:local\[(?P<n>\d+|\*)\]|local-cluster\[(?P<lc>\d+)\s*,[^\]]*\]|local)$"
)


class SparkConf:
    """Minimal stand-in for ``pyspark.SparkConf`` (get/set string pairs)."""

    def __init__(self) -> None:
        self._conf: dict[str, str] = {}

    def set(self, key: str, value: str) -> "SparkConf":
        self._conf[key] = str(value)
        return self

    def get(self, key: str, default: str | None = None) -> str | None:
        return self._conf.get(key, default)

    def setAppName(self, name: str) -> "SparkConf":
        return self.set("spark.app.name", name)

    def setMaster(self, master: str) -> "SparkConf":
        return self.set("spark.master", master)


class Broadcast:
    """Broadcast variable — shipped by value inside task closures."""

    def __init__(self, value: Any):
        self.value = value

    def unpersist(self, blocking: bool = False) -> None:  # pyspark parity
        pass

    def destroy(self) -> None:  # pyspark parity
        pass


class _Job:
    def __init__(self, num_tasks: int):
        self.results_q: _queue_mod.Queue = _queue_mod.Queue()
        self.num_tasks = num_tasks


class LocalSparkContext:
    """``pyspark.SparkContext`` subset over persistent executor processes.

    ``master`` accepts ``local[N]``, ``local-cluster[N, cores, mem]`` (cores
    and mem are accepted and ignored — every executor has one task slot), or
    ``local`` (one executor).  Tasks are routed ``partition_index %
    num_executors``, which guarantees that an n-partition job on n executors
    puts exactly one task on each — the property the cluster-formation
    barrier depends on (``SURVEY.md §3.1``).
    """

    def __init__(self, master: str = "local[2]", appName: str = "tfos-torch",
                 conf: SparkConf | None = None):
        m = _MASTER_RE.match(master.replace(" ", ""))
        if not m:
            raise ValueError(f"unsupported master: {master!r}")
        if m.group("lc"):
            n = int(m.group("lc"))
        elif m.group("n"):
            n = multiprocessing.cpu_count() if m.group("n") == "*" else int(m.group("n"))
        else:
            n = 1
        if n < 1:
            raise ValueError("need at least one executor")

        self.master = master
        self.appName = appName
        self._conf = conf or SparkConf()
        self.applicationId = f"local-{uuid.uuid4().hex[:12]}"
        self.defaultParallelism = n
        self._mp = multiprocessing.get_context("spawn")
        self._result_queue = self._mp.Queue()
        self._task_queues = []
        self._procs = []
        self._jobs: dict[int, _Job] = {}
        self._jobs_lock = threading.Lock()
        self._job_ids = itertools.count()
        self._stopped = threading.Event()

        from tensorflowonspark_torch.sparkapi.executor import executor_main

        for i in range(n):
            tq = self._mp.Queue()
            # NOT daemonic: executors must be able to spawn children (the
            # per-executor TFManager server and the background trainer);
            # daemonic processes are forbidden children.  Cleanup is explicit
            # in stop() plus an atexit hook for abandoned contexts.
            p = self._mp.Process(
                target=executor_main,
                args=(i, self.applicationId, tq, self._result_queue),
                name=f"tfos-executor-{i}",
                daemon=False,
            )
            p.start()
            self._task_queues.append(tq)
            self._procs.append(p)

        import atexit

        atexit.register(self.stop)

        self._router = threading.Thread(
            target=self._route_results, name="tfos-result-router", daemon=True
        )
        self._router.start()
        logger.info(
            "local spark substrate up: %d executors, appId=%s", n, self.applicationId
        )

    # -- pyspark API subset ------------------------------------------------

    @property
    def num_executors(self) -> int:
        return len(self._procs)

    def parallelize(self, data: Iterable[Any], numSlices: int | None = None) -> RDD:
        items = list(data)
        n = numSlices or min(self.defaultParallelism, max(1, len(items)))
        n = max(1, n)
        # same partitioning rule as Spark's parallelize: contiguous slices
        slices: list[list[Any]] = []
        for i in range(n):
            start = (i * len(items)) // n
            end = ((i + 1) * len(items)) // n
            slices.append(items[start:end])
        return RDD(self, slices)

    def range(self, start: int, end: int | None = None, step: int = 1,
              numSlices: int | None = None) -> RDD:
        if end is None:
            start, end = 0, start
        return self.parallelize(range(start, end, step), numSlices)

    def broadcast(self, value: Any) -> Broadcast:
        return Broadcast(value)

    def stop(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        for tq in self._task_queues:
            try:
                tq.put(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 10.0
        for p in self._procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
        self._result_queue.put(None)  # unblock the router

    # -- job execution -----------------------------------------------------

    def run_job(
        self,
        partitions: Sequence[Any],
        chain: Sequence[Callable],
        action: Callable,
        timeout: float | None = None,
        base_index: int = 0,
    ) -> list[Any]:
        """Run ``action(pindex, chain(...iter(partition)))`` per partition.

        Returns per-partition results in partition order.  Any task failure
        raises immediately with the executor traceback (maxFailures=1 — no
        retry, matching the reference's required Spark setting for SPMD).
        ``base_index`` offsets the partition index seen by indexed chains —
        used by ``RDD.take`` to run a partition-subset job whose tasks still
        observe their original indices.
        """
        import cloudpickle

        if self._stopped.is_set():
            raise RuntimeError("SparkContext has been stopped")
        job_id = next(self._job_ids)
        job = _Job(len(partitions))
        with self._jobs_lock:
            self._jobs[job_id] = job
        try:
            # chain+action serialized once — closures can capture large
            # broadcast values and must not be re-pickled per partition
            chain_blob = cloudpickle.dumps((list(chain), action))
            for pindex, part in enumerate(partitions):
                data_blob = cloudpickle.dumps(part)
                self._task_queues[pindex % len(self._task_queues)].put(
                    (job_id, pindex, base_index + pindex, data_blob, chain_blob)
                )
            results: dict[int, Any] = {}
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(results) < len(partitions):
                remaining = 1.0
                if deadline is not None:
                    remaining = min(1.0, deadline - time.monotonic())
                    if remaining <= 0:
                        raise TimeoutError(
                            f"job {job_id}: {len(partitions) - len(results)} tasks "
                            f"still outstanding after {timeout}s"
                        )
                try:
                    task_id, ok, payload = job.results_q.get(timeout=remaining)
                except _queue_mod.Empty:
                    self._check_executors()
                    continue
                if not ok:
                    raise RuntimeError(
                        f"task {task_id} of job {job_id} failed on executor "
                        f"{task_id % len(self._procs)}:\n{payload}"
                    )
                results[task_id] = cloudpickle.loads(payload)
            return [results[i] for i in range(len(partitions))]
        finally:
            with self._jobs_lock:
                self._jobs.pop(job_id, None)

    def _check_executors(self) -> None:
        for i, p in enumerate(self._procs):
            if not p.is_alive() and not self._stopped.is_set():
                raise RuntimeError(
                    f"executor {i} died (exitcode {p.exitcode}) with tasks outstanding"
                )

    def _route_results(self) -> None:
        while not self._stopped.is_set():
            try:
                item = self._result_queue.get(timeout=1.0)
            except _queue_mod.Empty:
                continue
            except (OSError, ValueError):
                break
            if item is None:
                break
            job_id, task_id, ok, payload = item
            with self._jobs_lock:
                job = self._jobs.get(job_id)
            if job is not None:
                job.results_q.put((task_id, ok, payload))
            else:
                logger.debug("dropping result for finished job %s", job_id)


def get_spark_context(master: str | None = None, app_name: str = "tfos-torch"):
    """Real ``pyspark.SparkContext`` when available, else the local substrate."""
    try:
        from pyspark import SparkConf as PySparkConf
        from pyspark import SparkContext as PySparkContext

        conf = PySparkConf().setAppName(app_name)
        if master:
            conf = conf.setMaster(master)
        return PySparkContext.getOrCreate(conf=conf)
    except ImportError:
        return LocalSparkContext(master or "local[2]", app_name)
