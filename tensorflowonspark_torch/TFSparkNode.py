"""Per-executor node runtime: bootstrap, feed, inference, shutdown closures.

Reference anchor: ``tensorflowonspark/TFSparkNode.py`` (``run``, ``train``,
``inference``, ``shutdown``, ``TFNodeContext``, ``_get_manager``).

Driver-side factories (:func:`run`, :func:`train`, :func:`inference`,
:func:`shutdown`) return picklable callables executed on Spark executors.
The bootstrap callable forms the accelerator cluster; the others are the
SPARK-input-mode data plane.

A copy of ``tensorflowonspark_tpu/TFSparkNode.py`` with its imports
rewritten.  Its deltas from the reference, as the JAX package's:

- GPU allocation: atomic card claiming (claim files) and
  ``CUDA_VISIBLE_DEVICES`` pinning before the trainer touches CUDA
  (:mod:`tensorflowonspark_torch.chip_info`).
- ``TF_CONFIG`` + TF grpc servers → ``torch.distributed`` seeded by the
  rendezvous: executor 0 publishes the process group's address on the kv
  blackboard (:mod:`tensorflowonspark_torch.parallel.distributed`).
- Row-at-a-time queue feed → chunked feed (lists of rows per queue item),
  consumed columnar by ``TFNode.DataFeed``.
- Background trainer uses **spawn**, not fork, and the context object
  reconnects its manager lazily so it survives the spawn pickle.

Where the JAX package pins its JAX platform, this copy resolves the node's
torch device (``util.select_device``: a CUDA request without a card
raises).  The JAX profiler server of the tensorboard branch is not ported
yet.
"""

from __future__ import annotations

import logging
import os
import queue as _queue_mod
import signal
import time
from typing import Any, Callable, Iterator

from tensorflowonspark_torch import (TFManager, chip_info, health, marker,
                                   obs, reservation, shm, util)

logger = logging.getLogger(__name__)

# Per-executor-process singleton managers, keyed by cluster id.  Reference
# anchor: ``TFSparkNode.py::TFSparkNode.mgr``.  Without this reference the
# BaseManager handle is garbage-collected when the bootstrap task returns,
# and its finalizer SHUTS DOWN the manager server process — killing the data
# plane before the first feed task arrives.
_MGRS: dict[str, Any] = {}


class TFNodeContext:
    """Node context handed to the user's ``map_fun(tf_args, ctx)``.

    Reference anchor: ``TFSparkNode.py::TFNodeContext`` (fields
    ``executor_id/job_name/task_index/cluster_spec/defaultFS/working_dir/
    mgr``).  Plain-data and picklable; ``mgr`` reconnects lazily in whichever
    process touches it (the reference's eager handle broke across forks).
    """

    def __init__(
        self,
        executor_id: int,
        job_name: str,
        task_index: int,
        cluster_spec: dict[str, list[str]],
        default_fs: str,
        working_dir: str,
        mgr_addr: tuple[str, int],
        authkey: bytes,
        cluster_info: list[dict[str, Any]],
        cluster_id: str,
        num_ps: int = 0,
        server_addr: tuple[str, int] | list | None = None,
        auth_token: str | None = None,
    ):
        self.executor_id = executor_id
        self.job_name = job_name
        self.task_index = task_index
        self.cluster_spec = cluster_spec
        self.defaultFS = default_fs
        self.working_dir = working_dir
        self.mgr_addr = tuple(mgr_addr)
        self.authkey = authkey
        self.cluster_info = cluster_info
        self.cluster_id = cluster_id
        self.num_ps = num_ps
        #: driver-side rendezvous endpoint — report_error's DURABLE sink
        #: (the rendezvous kv outlives this node's own manager)
        self.server_addr = tuple(server_addr) if server_addr else None
        self.auth_token = auth_token
        self._durable_errors: list[str] = []
        self._mgr = None

    @property
    def num_workers(self) -> int:
        return len(self.cluster_info)

    @property
    def mgr(self):
        if self._mgr is None:
            self._mgr = TFManager.connect(self.mgr_addr, self.authkey)
        return self._mgr

    def get_data_feed(
        self,
        train_mode: bool = True,
        qname_in: str = "input",
        qname_out: str = "output",
        input_mapping=None,
        prefetch: int = 0,
    ):
        """Build a :class:`tensorflowonspark_torch.TFNode.DataFeed` for this node."""
        from tensorflowonspark_torch.TFNode import DataFeed

        return DataFeed(self.mgr, train_mode, qname_in, qname_out, input_mapping,
                        prefetch=prefetch)

    def absolute_path(self, path: str) -> str:
        """Reference anchor: ``TFNode.py::hdfs_path`` (ctx method form)."""
        from tensorflowonspark_torch.TFNode import hdfs_path

        return hdfs_path(self, path)

    def report_error(self, message: str) -> None:
        """Push an attributed failure onto this node's error queue (the
        queue the driver re-raises from at ``train``/``shutdown``) AND
        onto the driver-side rendezvous kv.  Wire it as
        ``Trainer(error_sink=ctx.report_error)`` so the mid-run wedge
        watchdog (``health.StepWatchdog``) names the sick executor before
        hard-exiting the trainer process.

        The rendezvous copy is the DURABLE one: the error queue lives in
        this node's manager, which the orphan watch reaps ~15 s after the
        trainer dies — a driver that looks minutes later would find
        nothing.  The rendezvous server runs in the driver process and
        lives until ``TFCluster.shutdown``, so
        ``TFCluster._drain_node_errors`` can always recover the
        attribution from ``node_error:<job>:<idx>`` there.
        """
        msg = (f"executor {self.executor_id} "
               f"({self.job_name}:{self.task_index}): {message}")
        try:
            self.mgr.get_queue("error").put(msg)
        except Exception:
            pass  # manager may already be gone; the durable path remains
        self._report_durable(msg)

    def _report_durable(self, msg: str) -> None:
        """Best-effort publish onto the rendezvous kv (never raises)."""
        if not (self.server_addr and self.auth_token):
            return
        try:
            from tensorflowonspark_torch import reservation

            self._durable_errors.append(msg)
            reservation.Client(self.server_addr, self.auth_token).put(
                f"node_error:{self.job_name}:{self.task_index}",
                list(self._durable_errors))
        except Exception:
            pass  # best-effort: never mask the original failure

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_mgr"] = None  # manager proxies don't survive pickling
        return state


def _guard_name(cluster_id: str) -> str:
    return f"executor_id_{cluster_id}"


def _resolve_node(cluster_info, cluster_id,
                  lost_executors=None) -> dict[str, Any] | None:
    """Find the cluster node co-located with the current task's executor.

    Reference anchor: ``TFSparkNode.py::_get_manager`` — match by the
    executor-id file the bootstrap task wrote into this executor's cwd.

    ``lost_executors`` (elastic membership): executor ids regrouped away
    by the supervisor.  A task landing on one of those returns ``None``
    instead of raising — the caller discards the partition rather than
    failing the whole job on an executor the cluster already mourned.
    """
    eid = util.read_executor_id(name=_guard_name(cluster_id))
    if eid is None:
        raise RuntimeError(
            "no cluster node bootstrapped on this executor (executor_id file "
            f"missing for cluster {cluster_id}); was TFCluster.run started with "
            "as many partitions as executors?"
        )
    for meta in cluster_info:
        if meta["executor_id"] == eid:
            return meta
    if lost_executors and eid in set(lost_executors):
        return None
    raise RuntimeError(f"executor_id {eid} not present in cluster_info")


def _discard_partition(iterator: Iterator, cluster_meta: dict) -> None:
    """Consume and drop a partition routed to a lost executor.

    On real Spark, losing the executor loses its partition tasks too and
    the re-submitted task lands on a SURVIVING executor (whose co-located
    node consumes it); on the bundled local substrate tasks stay pinned to
    their executor index, so the data is dropped — the elastic feed replay
    re-feeds the epoch, and this is the slice of it a dead node would have
    trained.  Logged loudly so the loss is visible either way.
    """
    n = sum(1 for _ in iterator)
    logger.warning(
        "executor lost in a prior regroup (cluster %s): discarding its "
        "%d-row partition (a real Spark cluster reschedules the partition "
        "onto a surviving executor instead)", cluster_meta.get("id"), n)


def _connect_mgr(node_meta: dict[str, Any], authkey: bytes):
    return TFManager.connect(tuple(node_meta["addr"]), authkey)


def _raise_worker_error(mgr) -> None:
    """If the trainer pushed an error, re-raise it on the Spark side."""
    equeue = mgr.get_queue("error")
    try:
        err = equeue.get(block=False)
    except _queue_mod.Empty:
        return
    raise RuntimeError(f"exception in worker map_fun:\n{err}")


def _run_map_fun(fn_blob: bytes, args_blob: bytes, ctx: TFNodeContext,
                 mgr) -> None:
    """Instrumented run of the user's ``map_fun`` — the ONE copy of the
    span/flush/state choreography shared by both input modes (the spawned
    SPARK-mode trainer and the inline TENSORFLOW-mode bootstrap task).

    Invariants encoded here: the multi-process group forms BEFORE user
    code runs (reference: TF_CONFIG was exported by the node runtime, not
    by ``map_fun`` — a ``map_fun`` that forgets the call must not silently
    train per-host islands; no-op on single-node clusters); the trace
    flush happens BEFORE the "finished" state is visible, because shutdown
    (and a driver ``dump_trace`` right after it) keys on that state and
    the ``map_fun`` span must already be on the blackboard by then; a
    failure lands on the error queue + "failed" state before re-raising.
    """
    import cloudpickle

    try:
        from tensorflowonspark_torch.parallel import distributed

        with obs.span("node.distributed_init"):
            distributed.maybe_initialize(ctx)
        fn = cloudpickle.loads(fn_blob)
        tf_args = cloudpickle.loads(args_blob)
        with obs.span("node.map_fun", executor_id=ctx.executor_id):
            fn(tf_args, ctx)
        obs.flush(mgr)  # before "finished" becomes visible
        mgr.set("state", "finished")
    except BaseException:
        import traceback

        tb = traceback.format_exc()
        logger.error("map_fun failed on executor %s:\n%s", ctx.executor_id, tb)
        # the SAME prefixed text on both channels: the driver's drain
        # dedups by exact string, and the durable rendezvous copy must
        # collapse with the queue copy, not double the traceback
        msg = (f"executor {ctx.executor_id} "
               f"({ctx.job_name}:{ctx.task_index}): {tb}")
        try:
            mgr.get_queue("error").put(msg)
            mgr.set("state", "failed")
        except Exception:
            pass
        ctx._report_durable(msg)
        raise
    finally:
        obs.flush(mgr)


def _background_main(fn_blob: bytes, args_blob: bytes, ctx: TFNodeContext) -> None:
    """Entry point of the spawned trainer process (SPARK input mode)."""
    util.select_device()
    mgr = ctx.mgr
    # start tick BEFORE pid: the orphan watch keys liveness on the pair,
    # and a pid without its tick degrades to the reusable pid-only check
    mgr.set("trainer_pid_start", TFManager.proc_start_time(os.getpid()))
    mgr.set("trainer_pid", os.getpid())
    mgr.set("state", "running")
    # the spawned trainer is a fresh process: give its tracer the node
    # identity and the blackboard so its spans ship to the driver
    obs.configure(node=f"{ctx.job_name}:{ctx.task_index}", mgr=mgr)
    _run_map_fun(fn_blob, args_blob, ctx, mgr)


class _MapFn:
    """Cluster-bootstrap task body (one per executor).

    Reference anchor: ``TFSparkNode.py::run`` → ``_mapfn``.
    """

    def __init__(self, fn_blob, args_blob, cluster_meta, tensorboard, log_dir):
        self.fn_blob = fn_blob
        self.args_blob = args_blob
        self.meta = cluster_meta
        self.tensorboard = tensorboard
        self.log_dir = log_dir

    def __call__(self, iterator: Iterator) -> None:
        meta = self.meta
        cluster_id = meta["id"]
        part = list(iterator)
        if not part:
            raise RuntimeError("bootstrap partition was empty — need one element "
                               "per partition (sc.parallelize(range(n), n))")
        executor_id = int(part[0])

        # a reused python worker may have bootstrapped an EARLIER cluster:
        # that run's events were already shipped to its own blackboard, so
        # drop them now — flush publishes the full buffer, and stale spans
        # with old timestamps would corrupt this cluster's trace timeline
        obs.get_tracer().clear()

        # collision guard (reference: util.write_executor_id + cross-check)
        existing = util.read_executor_id(name=_guard_name(cluster_id))
        if existing is not None:
            raise RuntimeError(
                f"executor already hosts node {existing} of cluster {cluster_id}; "
                "two bootstrap tasks landed on one executor (Spark re-scheduling?)"
            )
        util.write_executor_id(executor_id, name=_guard_name(cluster_id))

        # card pinning before the trainer touches CUDA (reference:
        # gpu_info.get_gpus → CUDA_VISIBLE_DEVICES)
        chips = []
        if meta.get("num_chips", 0) > 0:
            with obs.span("node.chip_claim", executor_id=executor_id,
                          num_chips=meta["num_chips"]):
                chips = chip_info.claim_chips(
                    meta["num_chips"], cluster_id, f"executor_{executor_id}"
                )
                chip_info.set_visibility_env(chips)

        # data-plane manager: loopback for SPARK mode, routable for
        # TENSORFLOW mode (reference: TFManager.start local/remote)
        mode = "local" if meta["input_mode"] == "spark" else "remote"
        authkey = bytes.fromhex(meta["authkey_hex"])
        with obs.span("node.manager_start", executor_id=executor_id):
            mgr = TFManager.start(authkey, meta["queues"], mode=mode)
        _MGRS[cluster_id] = mgr  # keep the server alive past this task
        mgr.set("state", "bootstrapping")

        host, port = util.find_free_port()
        job_name, task_index = meta["cluster_template"].get(
            executor_id, ("worker", executor_id)
        )
        # the bootstrap process's events ship through this node's own
        # blackboard once the identity is known; everything recorded before
        # this (chip claim, manager start) rides along in the same buffer
        obs.configure(node=f"{job_name}:{task_index}", mgr=mgr)
        node_meta = {
            "executor_id": executor_id,
            "host": host,
            "port": port,
            "job_name": job_name,
            "task_index": task_index,
            "addr": list(mgr.address),
            "pid": os.getpid(),
            "chips": chips,
        }

        client = reservation.Client(tuple(meta["server_addr"]), meta["auth_token"])

        # health check at rendezvous (SURVEY §5 failure detection): a
        # wedged card must become a fast, attributed bootstrap
        # failure here — if it registers, the first collective hangs the
        # whole mesh with nothing shorter than feed_timeout to notice
        if health.should_probe(meta, chips):
            probe_err = health.probe_chip_health(
                meta.get("health_probe_timeout", health.DEFAULT_TIMEOUT_S)
            )
            if probe_err:
                msg = (f"executor {executor_id} ({job_name}:{task_index}) "
                       f"failed chip health probe at rendezvous: {probe_err}")
                try:  # name the sick executor on the driver's rendezvous kv
                    client.put("health_error", msg)
                except Exception:
                    pass
                try:
                    mgr.get_queue("error").put(msg)
                except Exception:
                    pass
                obs.flush(mgr)  # ship the failed-probe span before dying
                raise RuntimeError(msg)

        # executor 0 publishes the torch.distributed address before
        # registering, so every node can read it after the barrier
        if executor_id == 0:
            from tensorflowonspark_torch.parallel import distributed

            client.put(distributed.MASTER_KEY, f"{host}:{port}")
        with obs.span("node.register_await", executor_id=executor_id,
                      job=f"{job_name}:{task_index}"):
            client.register(node_meta)
            cluster_info = client.await_reservations(
                timeout=meta.get("reservation_timeout", 600.0)
            )

        cluster_spec: dict[str, list[str]] = {}
        for m in cluster_info:
            cluster_spec.setdefault(m["job_name"], []).append(
                f"{m['host']}:{m['port']}"
            )

        ctx = TFNodeContext(
            executor_id=executor_id,
            job_name=job_name,
            task_index=task_index,
            cluster_spec=cluster_spec,
            default_fs=meta.get("default_fs", "file://"),
            working_dir=os.getcwd(),
            mgr_addr=mgr.address,
            authkey=authkey,
            cluster_info=cluster_info,
            cluster_id=cluster_id,
            num_ps=meta.get("num_ps", 0),
            server_addr=meta.get("server_addr"),
            auth_token=meta.get("auth_token"),
        )

        if self.tensorboard and job_name in ("chief", "worker") and task_index == 0:
            self._start_tensorboard(client, ctx)

        if meta["input_mode"] == "spark":
            import multiprocessing

            mp = multiprocessing.get_context("spawn")
            p = mp.Process(
                target=_background_main,
                args=(self.fn_blob, self.args_blob, ctx),
                name=f"tfos-trainer-{executor_id}",
                daemon=True,
            )
            p.start()
            # the manager's orphan watch keys liveness to this pid: the
            # bootstrap worker may be reaped long before the trainer is
            # done (spark.python.worker.reuse=false), and the data plane
            # must outlive the worker, not the trainer.  The start tick
            # rides along so a recycled pid cannot impersonate the trainer
            # (TFManager._pid_alive)
            mgr.set("trainer_pid_start", TFManager.proc_start_time(p.pid))
            mgr.set("trainer_pid", p.pid)
            logger.info(
                "executor %s: trainer started in background pid %s", executor_id, p.pid
            )
            obs.event("node.trainer_spawned", executor_id=executor_id,
                      trainer_pid=p.pid)
            obs.flush(mgr)  # bootstrap spans ship before this task returns
            # bootstrap task returns; the executor is free for feed tasks
        else:
            util.select_device()
            mgr.set("state", "running")
            mgr.set("trainer_pid_start",
                    TFManager.proc_start_time(os.getpid()))
            mgr.set("trainer_pid", os.getpid())
            _run_map_fun(self.fn_blob, self.args_blob, ctx, mgr)

    def _start_tensorboard(self, client, ctx) -> None:
        """TensorBoard, when the binary exists.

        Reference anchor: ``TFSparkNode.py::_mapfn`` tensorboard branch: spawn
        the ``tensorboard`` CLI and publish its URL on the kv blackboard
        (see ``TFCluster.py::tensorboard_url``).
        """
        tb_bin = util.find_in_path(os.environ.get("PATH", ""), "tensorboard")
        if tb_bin:
            import subprocess

            host, tb_port = util.find_free_port()
            logdir = self.log_dir or os.path.join(os.getcwd(), "tensorboard_logs")
            subprocess.Popen(
                [tb_bin, f"--logdir={logdir}", f"--port={tb_port}", "--bind_all"],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            client.put("tensorboard_url", f"http://{host}:{tb_port}")
        else:
            logger.info("tensorboard binary not found")


class _TrainFn:
    """Feed one RDD partition into the co-located node's input queue.

    Reference anchor: ``TFSparkNode.py::train``.  Ships chunks, not rows —
    and columnarizes each chunk ONCE here on the Spark-task side
    (``shm.encode_chunk``): fixed-dtype columns ride a shared-memory
    segment (only the descriptor crosses the manager), or one pickled
    ``ColumnarChunk`` when shm is unavailable/opted out; ragged or
    object-dtype rows keep the legacy pickled-rows path.
    """

    def __init__(self, cluster_info, cluster_meta, feed_timeout, qname):
        self.cluster_info = cluster_info
        self.meta = cluster_meta
        self.feed_timeout = feed_timeout
        self.qname = qname

    def __call__(self, iterator: Iterator) -> None:
        node = _resolve_node(self.cluster_info, self.meta["id"],
                             lost_executors=self.meta.get("lost_executors"))
        if node is None:  # this executor's node was lost in a regroup
            _discard_partition(iterator, self.meta)
            return
        mgr = _connect_mgr(node, bytes.fromhex(self.meta["authkey_hex"]))
        _raise_worker_error(mgr)
        state = mgr.get("state")
        if state in ("terminating", "finished", "failed", "lost"):
            logger.info("node state %s: discarding partition", state)
            for _ in iterator:
                pass
            _raise_worker_error(mgr)
            return
        q = mgr.get_queue(self.qname)
        chunk_size = self.meta.get("feed_chunk", 256)
        deadline = time.monotonic() + self.feed_timeout
        chunk: list[Any] = []
        # feeder-plane flight attribution: `encode` (columnarize + shm
        # write) vs `backpressure` (blocked in the queue put — the wire +
        # byte-bound back-pressure).  A feeder whose verdicts are
        # queue_backpressured is outrunning the trainer, not slow itself.
        rec = obs.flight.recorder("feeder")

        def send_chunk(rows: list[Any]) -> None:
            t0 = time.perf_counter()
            payload = shm.encode_chunk(rows)
            t1 = time.perf_counter()
            self._put(q, payload, deadline)
            rec.add(encode=t1 - t0,
                    backpressure=time.perf_counter() - t1)
            rec.commit()

        try:
            for row in iterator:
                chunk.append(row)
                if len(chunk) >= chunk_size:
                    send_chunk(chunk)
                    chunk = []
            if chunk:
                send_chunk(chunk)
            self._put(q, marker.EndPartition(), deadline)
        except _queue_mod.Full:
            raise RuntimeError(
                f"feed timed out after {self.feed_timeout}s: trainer not "
                "consuming (hung or finished?)"
            ) from None
        # wait for consumption so Spark doesn't consider the epoch done while
        # data is still queued (reference used queue.join()).  The state
        # check runs BEFORE the qsize==0 early-return: the manager that
        # marked its node "lost" also DRAINS the dead trainer's queues, and
        # a drained queue must still abort this epoch with the attribution
        # (a feed that "completed" into a corpse would never be replayed by
        # the elastic supervisor) instead of reading as consumed
        while True:
            if mgr.get("state") in ("terminating", "finished", "failed",
                                    "lost"):
                _raise_worker_error(mgr)
                return
            if q.qsize() == 0:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"feed timed out after {self.feed_timeout}s waiting for "
                    f"{q.qsize()} queued chunks to be consumed"
                )
            time.sleep(0.05)

    def _put(self, q, item, deadline) -> None:
        timeout = max(0.0, deadline - time.monotonic())
        try:
            q.put(item, block=True, timeout=timeout)
        except Exception:
            # a descriptor that never made it onto the queue references a
            # segment nobody will ever consume — reclaim it now
            shm.maybe_unlink_payload(item)
            raise


class _InferenceFn:
    """Push one partition through the node and yield its predictions.

    Reference anchor: ``TFSparkNode.py::inference``.
    """

    def __init__(self, cluster_info, cluster_meta, qname_in, qname_out, timeout):
        self.cluster_info = cluster_info
        self.meta = cluster_meta
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.timeout = timeout

    def __call__(self, iterator: Iterator):
        import uuid

        node = _resolve_node(self.cluster_info, self.meta["id"],
                             lost_executors=self.meta.get("lost_executors"))
        if node is None:
            # executor mourned by a regroup: no co-located node to score
            # this partition — discard it (real Spark reschedules the
            # partition onto a surviving executor) and return no results
            _discard_partition(iterator, self.meta)
            return []
        mgr = _connect_mgr(node, bytes.fromhex(self.meta["authkey_hex"]))
        _raise_worker_error(mgr)
        qin = mgr.get_queue(self.qname_in)
        # per-task result queue: chunks are tagged with this task's identity
        # and DataFeed.batch_results routes each row's result back to
        # "output:<tag>", so concurrent partition tasks on one executor
        # (multi-slot) cannot steal each other's predictions
        tag = uuid.uuid4().hex[:12]
        qout = mgr.get_queue(f"{self.qname_out}:{tag}")
        chunk_size = self.meta.get("feed_chunk", 256)
        deadline = time.monotonic() + self.timeout

        count = 0
        chunk: list[Any] = []

        def send(payload) -> None:
            # tagged chunks columnarize feeder-side too (shm or pickled
            # columnar, TaggedChunk fallback); a payload that fails to
            # enqueue must not strand its shm segment
            try:
                qin.put(payload, timeout=max(0.0, deadline - time.monotonic()))
            except Exception:
                shm.maybe_unlink_payload(payload)
                raise

        try:
            for row in iterator:
                chunk.append(row)
                count += 1
                if len(chunk) >= chunk_size:
                    send(shm.encode_chunk(chunk, tag=tag))
                    chunk = []
            if chunk:
                send(shm.encode_chunk(chunk, tag=tag))
            send(marker.EndPartition())
        except _queue_mod.Full:
            _raise_worker_error(mgr)
            raise RuntimeError(
                f"inference feed timed out after {self.timeout}s: trainer not "
                "consuming (hung or finished?)"
            ) from None

        results: list[Any] = []
        try:
            while len(results) < count:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"inference timed out: got {len(results)} of {count} results"
                    )
                try:
                    batch = qout.get(timeout=min(1.0, remaining))
                except _queue_mod.Empty:
                    _raise_worker_error(mgr)
                    continue
                results.extend(batch if isinstance(batch, list) else [batch])
        finally:
            try:  # drop the per-task queue so the server doesn't accumulate
                mgr.del_queue(f"{self.qname_out}:{tag}")
            except Exception:
                pass
        if len(results) != count:
            raise RuntimeError(
                f"inference produced {len(results)} results for {count} inputs"
            )
        return results


class _ShutdownFn:
    """Stop the co-located node and surface trainer errors.

    Reference anchor: ``TFSparkNode.py::shutdown``.
    """

    def __init__(self, cluster_info, cluster_meta, grace_secs, qname):
        self.cluster_info = cluster_info
        self.meta = cluster_meta
        self.grace_secs = grace_secs
        self.qname = qname

    def __call__(self, iterator: Iterator) -> None:
        list(iterator)  # consume the placeholder partition element
        node = _resolve_node(self.cluster_info, self.meta["id"],
                             lost_executors=self.meta.get("lost_executors"))
        if node is None:
            # node lost in a regroup: its trainer is dead and its manager
            # reaped — there is nothing left here to stop
            logger.info("shutdown: executor was lost in a prior regroup; "
                        "nothing to stop")
            return
        mgr = _connect_mgr(node, bytes.fromhex(self.meta["authkey_hex"]))
        state = mgr.get("state")
        if state in ("finished", "failed", "lost"):
            # "lost": the trainer vanished (SIGKILL/preemption) — the
            # error queue carries the manager's attribution; raise it
            # rather than burning the grace period on a corpse
            _raise_worker_error(mgr)
            return
        mgr.set("state", "terminating")
        try:
            # bounded put: a wedged trainer leaves the queue full, and a
            # blocking put here would hang shutdown forever, never reaching
            # the kill path below
            mgr.get_queue(self.qname).put(
                marker.StopFeed(), timeout=max(1.0, self.grace_secs)
            )
        except _queue_mod.Full:
            logger.warning("input queue full; trainer not consuming — will kill")
        deadline = time.monotonic() + max(1.0, self.grace_secs)
        while time.monotonic() < deadline:
            if mgr.get("state") in ("finished", "failed"):
                break
            time.sleep(0.1)
        else:
            pid = mgr.get("trainer_pid")
            logger.warning(
                "trainer (pid %s) did not stop within %ss; killing", pid, self.grace_secs
            )
            if pid:
                try:
                    os.kill(int(pid), signal.SIGKILL)
                except OSError:
                    pass
            _raise_worker_error(mgr)
            raise RuntimeError(
                f"trainer on executor {node['executor_id']} did not shut down "
                f"within grace period ({self.grace_secs}s) and was killed"
            )
        _raise_worker_error(mgr)


# -- public factories (reference-parity signatures) -------------------------


def run(fn: Callable, tf_args: Any, cluster_meta: dict, tensorboard: bool = False,
        log_dir: str | None = None) -> _MapFn:
    import cloudpickle

    return _MapFn(
        cloudpickle.dumps(fn), cloudpickle.dumps(tf_args), cluster_meta,
        tensorboard, log_dir,
    )


def train(cluster_info, cluster_meta, feed_timeout: float = 600.0,
          qname: str = "input") -> _TrainFn:
    return _TrainFn(cluster_info, cluster_meta, feed_timeout, qname)


def inference(cluster_info, cluster_meta, qname_in: str = "input",
              qname_out: str = "output", timeout: float = 600.0) -> _InferenceFn:
    return _InferenceFn(cluster_info, cluster_meta, qname_in, qname_out, timeout)


def shutdown(cluster_info, cluster_meta, grace_secs: float = 30.0,
             qname: str = "input") -> _ShutdownFn:
    return _ShutdownFn(cluster_info, cluster_meta, grace_secs, qname)
