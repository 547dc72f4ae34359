"""Unit tests for the per-executor TFManager data plane.

The port's copy of ``tests/test_manager.py``, run against
``tensorflowonspark_torch``.
"""

import multiprocessing
import queue

import pytest

from tensorflowonspark_torch import TFManager


@pytest.fixture()
def mgr():
    m = TFManager.start(b"secret", ["input", "output", "error"], mode="local")
    yield m
    m.shutdown()


def test_queue_roundtrip(mgr):
    q = mgr.get_queue("input")
    q.put({"x": [1, 2, 3]})
    q.put({"x": [4, 5, 6]})
    assert q.get()["x"] == [1, 2, 3]
    assert q.get()["x"] == [4, 5, 6]
    assert q.qsize() == 0


def test_kv(mgr):
    assert mgr.get("state") is None
    mgr.set("state", "running")
    assert mgr.get("state") == "running"
    mgr.set("state", "stopped")
    assert mgr.get("state") == "stopped"


def test_connect_from_other_process(mgr):
    addr = mgr.address
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_child_push, args=(addr, b"secret"))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 0
    q = mgr.get_queue("input")
    assert q.get(timeout=10) == "from-child"
    assert mgr.get("child_key") == 42


def _child_push(addr, authkey):
    m = TFManager.connect(addr, authkey)
    m.get_queue("input").put("from-child")
    m.set("child_key", 42)


def test_queue_maxsize_backpressure():
    m = TFManager.start(b"k", ["input"], mode="local", maxsize=2)
    try:
        q = m.get_queue("input")
        q.put(1)
        q.put(2)
        with pytest.raises(queue.Full):
            q.put(3, block=False)
    finally:
        m.shutdown()


def test_wrong_authkey_rejected(mgr):
    """A peer with the wrong authkey must not reach the queues (the data
    plane's authentication — same contract as the reservation token)."""
    from multiprocessing.context import AuthenticationError

    with pytest.raises((AuthenticationError, OSError)):
        TFManager.connect(mgr.address, b"not-the-secret")
    # the real key still works afterwards
    ok = TFManager.connect(mgr.address, b"secret")
    ok.get_queue("input").put(1)
    assert ok.get_queue("input").get(timeout=5) == 1


def test_pid_identity_detects_reuse():
    """The orphan watch keys trainer liveness on (pid, start tick), not
    pid alone — a recycled pid naming an unrelated process must read as
    DEAD or the manager server leaks forever."""
    import os

    me = os.getpid()
    start = TFManager.proc_start_time(me)
    assert start is not None and start > 0  # Linux CI: /proc available
    # same process, matching tick → alive
    assert TFManager._pid_alive(me, start) is True
    # recorded tick from a DIFFERENT incarnation of this pid → dead
    assert TFManager._pid_alive(me, start + 12345) is False
    # no recorded tick (legacy writer) degrades to the pid-only check
    assert TFManager._pid_alive(me, None) is True
    # a pid that is actually gone → dead regardless of tick
    import multiprocessing

    p = multiprocessing.get_context("spawn").Process(target=int)
    p.start()
    dead_pid = p.pid
    p.join()
    # reaped pid → dead; if the OS already recycled it, the recorded tick
    # (1: boot-time, unmatchable) still reads as a different process
    assert TFManager._pid_alive(dead_pid, 1) is False


def test_byte_bound_blocks_puts_over_budget():
    """The byte-aware back-pressure satellite: with columnar chunks a
    chunk-count bound alone can pin GBs; queued payload bytes are bounded
    too (descriptor-side accounting via each payload's ``nbytes``)."""
    import numpy as np

    from tensorflowonspark_torch import marker

    q = TFManager._ByteBoundedQueue(maxsize=1024, max_bytes=1000)
    small = marker.ColumnarChunk([np.zeros(100, np.uint8)])  # 100 B
    big = marker.ColumnarChunk([np.zeros(950, np.uint8)])    # 950 B
    q.put(small)
    with pytest.raises(queue.Full):  # 100 + 950 > 1000
        q.put(big, block=False)
    assert q.get() is small  # draining releases the budget
    q.put(big, block=False)  # now fits
    assert q.inflight_bytes() == big.nbytes


def test_byte_bound_admits_oversized_item_when_empty():
    """A single item larger than the whole budget is admitted when the
    queue is byte-empty — back-pressure, not a message-size limit."""
    import numpy as np

    from tensorflowonspark_torch import marker

    q = TFManager._ByteBoundedQueue(maxsize=4, max_bytes=100)
    huge = marker.ColumnarChunk([np.zeros(10_000, np.uint8)])
    q.put(huge, block=False)
    assert q.inflight_bytes() == 10_000
    with pytest.raises(queue.Full):  # but nothing rides alongside it
        q.put(huge, block=False)
    q.get()
    assert q.inflight_bytes() == 0


def test_byte_bound_keeps_chunk_count_floor():
    """Legacy payloads (no nbytes) stay bounded by chunk count alone."""
    q = TFManager._ByteBoundedQueue(maxsize=2, max_bytes=10**9)
    q.put([1, 2, 3])
    q.put([4, 5, 6])
    with pytest.raises(queue.Full):
        q.put([7], block=False)
    assert q.inflight_bytes() == 0  # row lists: no byte accounting


def test_queue_gauges_track_residency():
    """Continuous occupancy/byte gauges on the
    byte-bounded queue — incremented at put, decremented at get, summed
    across this process's queues."""
    import numpy as np

    from tensorflowonspark_torch import marker, obs

    g_chunks = obs.gauge("feed_queue_chunks")
    g_bytes = obs.gauge("feed_queue_bytes")
    c0, b0 = g_chunks.value, g_bytes.value
    q = TFManager._ByteBoundedQueue(maxsize=8, max_bytes=0)
    a = marker.ColumnarChunk([np.zeros(100, np.uint8)])
    b = marker.ColumnarChunk([np.zeros(50, np.uint8)])
    q.put(a)
    q.put(b)
    q.put([1, 2, 3])  # legacy rows payload: a chunk with no byte account
    assert g_chunks.value - c0 == 3
    assert g_bytes.value - b0 == a.nbytes + b.nbytes
    got = q.get()
    # the consumer-held-headroom caveat (_ByteBoundedQueue
    # docstring): the gauges track QUEUE residency — a dequeued shm
    # descriptor's segment is still pinned in /dev/shm until read_chunk,
    # but it has left these gauges; shm_bytes_resident is the instrument
    # that still sees it
    assert got is a
    assert g_chunks.value - c0 == 2
    assert g_bytes.value - b0 == b.nbytes
    q.get()
    q.get()
    assert g_chunks.value - c0 == 0
    assert g_bytes.value - b0 == 0


def test_queue_gauges_under_headroom_caveat_with_shm_descriptor():
    """Fill/drain with a real shm descriptor: after get() the queue gauges
    drop while the segment is still resident — exactly the documented
    headroom between queue accounting and true /dev/shm residency."""
    import numpy as np

    from tensorflowonspark_torch import obs, shm

    if not shm.shm_available():
        pytest.skip("/dev/shm unavailable")
    g_bytes = obs.gauge("feed_queue_bytes")
    b0 = g_bytes.value
    q = TFManager._ByteBoundedQueue(maxsize=8, max_bytes=0)
    ref = shm.encode_chunk([(np.ones(64, np.float32), 0)])
    assert isinstance(ref, shm.ShmChunkRef)
    try:
        q.put(ref)
        assert g_bytes.value - b0 == ref.nbytes
        held = q.get()
        # dequeued but unconsumed: gone from the queue gauge...
        assert g_bytes.value - b0 == 0
        # ...while the /dev/shm scan still counts the bytes
        segs, resident = shm.resident_stats()
        assert segs >= 1 and resident >= ref.nbytes
    finally:
        shm.maybe_unlink_payload(ref)
    assert held is ref


def test_del_queue_releases_residency_gauges():
    """Dropping a queue with items still enqueued must release their
    gauge residency — a failed task's undrained per-task queue must not
    read as phantom residency forever."""
    import numpy as np

    from tensorflowonspark_torch import marker, obs

    g_chunks = obs.gauge("feed_queue_chunks")
    g_bytes = obs.gauge("feed_queue_bytes")
    c0, b0 = g_chunks.value, g_bytes.value
    q = TFManager._ByteBoundedQueue(maxsize=8, max_bytes=0)
    TFManager._queues["output:ghost"] = q
    try:
        q.put(marker.ColumnarChunk([np.zeros(128, np.uint8)]))
        q.put([1, 2])
        assert g_chunks.value - c0 == 2
        assert g_bytes.value - b0 == 128
        assert TFManager._del_queue("output:ghost") is True
        assert g_chunks.value - c0 == 0
        assert g_bytes.value - b0 == 0
        assert TFManager._del_queue("output:ghost") is False
    finally:
        TFManager._queues.pop("output:ghost", None)


def test_trainer_pid_start_rides_the_kv(mgr):
    """The node runtime records the start tick beside the pid; both are
    plain kv values any process can read back."""
    import os

    mgr.set("trainer_pid_start", TFManager.proc_start_time(os.getpid()))
    mgr.set("trainer_pid", os.getpid())
    assert mgr.get("trainer_pid") == os.getpid()
    assert mgr.get("trainer_pid_start") == TFManager.proc_start_time(
        os.getpid())


def test_pid_alive_treats_zombie_as_dead():
    """A SIGKILLed child lingers as a zombie (same pid, same start tick,
    accepts signal 0) until reaped — it must still read as DEAD, or the
    orphan watch and the elastic trainer-death detection never fire on a
    preempted trainer whose executor parent survives."""
    import os
    import signal
    import subprocess
    import sys
    import time

    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    try:
        start = TFManager.proc_start_time(child.pid)
        assert TFManager._pid_alive(child.pid, start) is True
        os.kill(child.pid, signal.SIGKILL)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            # deliberately NOT reaped: the kernel keeps the zombie entry
            if TFManager._pid_alive(child.pid, start) is False:
                break
            time.sleep(0.05)
        assert TFManager._pid_alive(child.pid, start) is False
    finally:
        child.kill()
        child.wait()


def test_manager_marks_node_lost_when_trainer_vanishes(mgr):
    """A trainer that vanishes (SIGKILL/preemption) while its
    node reads "running" is marked "lost" by the manager's watch thread,
    with an attributed message on the error queue — the detection path
    that works even where the executor (and so this manager) survives."""
    import os
    import signal
    import subprocess
    import sys
    import time

    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    try:
        mgr.set("trainer_pid_start", TFManager.proc_start_time(child.pid))
        mgr.set("trainer_pid", child.pid)
        mgr.set("state", "running")
        os.kill(child.pid, signal.SIGKILL)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if mgr.get("state") == "lost":
                break
            time.sleep(0.2)
        assert mgr.get("state") == "lost"
        msg = mgr.get_queue("error").get(timeout=5)
        assert "vanished" in msg and str(child.pid) in msg
    finally:
        child.kill()
        child.wait()


def test_manager_does_not_mark_finished_node_lost(mgr):
    """A trainer that reported "finished" before exiting is NOT a loss —
    the lost marking only covers deaths no code path could report."""
    import subprocess
    import sys
    import time

    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    mgr.set("trainer_pid_start", None)
    mgr.set("trainer_pid", child.pid)
    mgr.set("state", "finished")
    time.sleep(4.5)  # two watch cycles
    assert mgr.get("state") == "finished"
