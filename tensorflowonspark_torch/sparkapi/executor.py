"""Executor process main loop for the local Spark substrate.

One instance of :func:`executor_main` runs per executor process.  It mirrors
what a Spark executor's python worker does with a task: deserialize the
function chain, apply it to the partition iterator, ship the result (or the
traceback) back to the driver.

Each executor gets its own working directory under the app scratch dir —
this preserves the reference's executor-id collision-guard semantics
(``tensorflowonspark/util.py::write_executor_id`` writes to the executor's
cwd, which Spark keeps distinct per executor).
"""

from __future__ import annotations

import os
import traceback


def executor_main(executor_id: int, app_id: str, task_queue, result_queue) -> None:
    import queue as queue_mod

    import cloudpickle

    from tensorflowonspark_torch import util

    wd = os.path.join(util.single_node_scratch_dir(app_id), f"executor_{executor_id}")
    os.makedirs(wd, exist_ok=True)
    os.chdir(wd)
    os.environ["TFOS_EXECUTOR_ID"] = str(executor_id)
    os.environ["TFOS_APP_ID"] = app_id
    driver_pid = os.getppid()

    while True:
        try:
            item = task_queue.get(timeout=5.0)
        except queue_mod.Empty:
            # executors are non-daemonic (they must spawn the manager and
            # trainer); if the driver died without running stop()/atexit
            # (SIGKILL, os._exit), exit instead of lingering forever
            if os.getppid() != driver_pid:
                break
            continue
        if item is None:
            break
        job_id, task_id, pindex, data_blob, chain_blob = item
        try:
            data = cloudpickle.loads(data_blob)
            chain, action = cloudpickle.loads(chain_blob)
            it = iter(data)
            for f in chain:
                it = f(pindex, it)
            result = action(pindex, it)
            result_queue.put((job_id, task_id, True, cloudpickle.dumps(result)))
        except BaseException:
            result_queue.put((job_id, task_id, False, traceback.format_exc()))
