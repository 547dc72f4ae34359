"""The zero-copy columnar shm transport (tensorflowonspark_torch/shm.py).

The port's copy of ``tests/test_shm.py``, run against
``tensorflowonspark_torch``.

Covers the full descriptor lifecycle — write/read round trip, pickled and
legacy fallbacks, the orphan sweep keyed on the (pid, start tick) identity,
the ``TFOS_FEED_SHM=0`` opt-out — and asserts after EVERY test that no
``tfos_feed_*`` segment is left behind in ``/dev/shm`` (the acceptance
criterion: the transport must never leak host shared memory).

Unlike the JAX package's file, the per-test leak check counts only the
segments this process created (``<prefix>_<pid>_...``) and the sweeps
exclude every segment but the test's own: the suite runs in several
workers at once, and other workers' feed tests create, strand and reap
segments of their own while a test here runs.
"""

import multiprocessing
import os
import pickle
import time

import numpy as np
import pytest

from tensorflowonspark_torch import marker, shm


def _segments():
    if not os.path.isdir("/dev/shm"):
        return []
    return sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(shm.SEG_PREFIX + "_"))


def _own_segments():
    """The segments this process created."""
    mine = f"{shm.SEG_PREFIX}_{os.getpid()}_"
    return [f for f in _segments() if f.startswith(mine)]


@pytest.fixture(autouse=True)
def no_segment_leaks():
    """The leak assertion: every test leaves this process's segments in
    /dev/shm exactly as it found them.  Tests that deliberately strand a
    segment (in a child) must reap it themselves (that is what they are
    testing).  The flight-recorder residency gauges (``shm_segments_live``
    / ``shm_bytes_resident``, refreshed by every manager watch cycle in
    production) must agree with the scan that set them."""
    before = _own_segments()
    yield
    assert _own_segments() == before, "test leaked shm feed segments"
    from tensorflowonspark_torch import obs

    count, nbytes = shm.update_gauges()
    assert obs.gauge("shm_segments_live").value == count
    assert obs.gauge("shm_bytes_resident").value == nbytes


pytestmark = pytest.mark.skipif(
    not shm.shm_available(), reason="/dev/shm not available on this host")


def _rows(n=6, dim=4):
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    return [(feats[i], i) for i in range(n)]


# -- columnarize: the one per-row loop, feeder-side --------------------------


def test_columnarize_matches_consumer_convention():
    rows = _rows()
    cols = shm.columnarize(rows)
    assert [c.shape for c in cols] == [(6, 4), (6,)]
    np.testing.assert_array_equal(cols[0], np.stack([r[0] for r in rows]))
    np.testing.assert_array_equal(cols[1], np.arange(6))
    for c in cols:
        assert c.flags["C_CONTIGUOUS"] and not c.dtype.hasobject


def test_columnarize_scalar_rows_single_column():
    cols = shm.columnarize([1.0, 2.0, 3.0])
    assert len(cols) == 1
    np.testing.assert_array_equal(cols[0], [1.0, 2.0, 3.0])


def test_columnarize_ragged_and_object_rows_fall_back():
    # ragged: per-row shapes differ → None (pickled-rows path)
    assert shm.columnarize([(np.ones(3), 0), (np.ones(4), 1)]) is None
    # object dtype: arbitrary Python payloads must keep riding pickle
    assert shm.columnarize([("a", object()), ("b", object())]) is None
    # mixed arity
    assert shm.columnarize([(1, 2), (1, 2, 3)]) is None
    assert shm.columnarize([]) is None


# -- segment round trip ------------------------------------------------------


def test_write_read_round_trip_zero_copy():
    cols = shm.columnarize(_rows())
    ref = shm.write_chunk(cols, tag="task-3")
    assert ref is not None and ref.nrows == 6
    assert _own_segments()  # parked
    out, tag = shm.read_chunk(ref)
    assert tag == "task-3"
    assert _own_segments() == []  # consumed: unlinked at read time
    for got, want in zip(out, cols):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the views stay readable after the unlink (POSIX: mapping survives)
    assert float(out[0].sum()) == pytest.approx(float(cols[0].sum()))


def test_read_chunk_copy_mode_equality():
    cols = shm.columnarize(_rows())
    ref = shm.write_chunk(cols)
    out, tag = shm.read_chunk(ref, copy=True)
    assert tag is None
    for got, want in zip(out, cols):
        np.testing.assert_array_equal(got, want)
    assert _own_segments() == []


def test_round_trip_equals_pickled_path():
    """Transport equivalence: the same chunk through shm and through the
    pickled ColumnarChunk fallback yields identical columns."""
    rows = _rows()
    via_shm = shm.encode_chunk(list(rows), tag="t", transport="shm")
    assert isinstance(via_shm, shm.ShmChunkRef)
    shm_cols, _ = shm.read_chunk(via_shm)
    via_pickle = shm.encode_chunk(list(rows), tag="t", transport="pickle")
    assert isinstance(via_pickle, marker.ColumnarChunk)
    # the pickled payload really pickles (it rides a manager proxy socket)
    via_pickle = pickle.loads(pickle.dumps(via_pickle))
    for a, b in zip(shm_cols, via_pickle.cols):
        np.testing.assert_array_equal(a, b)


def test_descriptor_is_small_and_picklable():
    cols = shm.columnarize(_rows(n=64, dim=1024))
    ref = shm.write_chunk(cols)
    try:
        wire = pickle.dumps(ref)
        assert len(wire) < 1024  # descriptors, not payloads, ride the queue
        back = pickle.loads(wire)
        assert back.name == ref.name and back.nbytes == ref.nbytes
    finally:
        shm.unlink_ref(ref)


def test_read_vanished_segment_raises():
    cols = shm.columnarize(_rows())
    ref = shm.write_chunk(cols)
    assert shm.unlink_ref(ref) is True
    with pytest.raises(RuntimeError, match="vanished"):
        shm.read_chunk(ref)
    assert shm.unlink_ref(ref) is False  # already gone


def test_maybe_unlink_payload_only_touches_descriptors():
    ref = shm.write_chunk(shm.columnarize(_rows()))
    shm.maybe_unlink_payload(ref)
    assert _own_segments() == []
    shm.maybe_unlink_payload([1, 2, 3])  # non-descriptors: no-op
    shm.maybe_unlink_payload(marker.EndPartition())


# -- transport selection -----------------------------------------------------


def test_encode_chunk_auto_uses_shm_when_enabled():
    payload = shm.encode_chunk(_rows())
    assert isinstance(payload, shm.ShmChunkRef)
    shm.unlink_ref(payload)


def test_encode_chunk_opt_out_env(monkeypatch):
    monkeypatch.setenv("TFOS_FEED_SHM", "0")
    assert not shm.enabled()
    payload = shm.encode_chunk(_rows(), tag="tA")
    assert isinstance(payload, marker.ColumnarChunk)
    assert payload.tag == "tA" and payload.nrows == 6
    monkeypatch.setenv("TFOS_FEED_SHM", "1")
    assert shm.enabled()


def test_encode_chunk_ragged_rows_keep_legacy_path():
    ragged = [(np.ones(3), 0), (np.ones(4), 1)]
    assert shm.encode_chunk(list(ragged)) == ragged  # untagged → plain list
    tagged = shm.encode_chunk(list(ragged), tag="tB")
    assert isinstance(tagged, marker.TaggedChunk) and tagged.tag == "tB"


def test_encode_chunk_forced_rows_transport():
    rows = _rows()
    assert shm.encode_chunk(list(rows), transport="rows") == rows


def test_write_failure_falls_back_to_none(monkeypatch):
    monkeypatch.setattr(shm, "_SHM_DIR", "/nonexistent-shm-dir")
    assert not shm.shm_available()
    assert shm.write_chunk(shm.columnarize(_rows())) is None
    # encode_chunk degrades to the pickled columnar payload, not an error
    payload = shm.encode_chunk(_rows())
    assert isinstance(payload, marker.ColumnarChunk)


# -- orphan sweep: (pid, start tick) identity --------------------------------


def _sweep(grace_s, ours, exclude=()):
    """``shm.sweep_orphans`` over this test's segments ``ours`` only: every
    other segment in /dev/shm is excluded, since other workers' tests strand
    and reap segments of their own meanwhile."""
    others = set(_segments()) - set(ours)
    return shm.sweep_orphans(grace_s=grace_s, exclude=others | set(exclude))


def _strand_segment(feats):
    """Child (spawn): park a chunk and exit WITHOUT consuming it — the
    killed-feeder failure mode the sweep exists for."""
    ref = shm.write_chunk([feats])
    os._exit(0 if ref is not None else 1)


def test_sweep_reaps_segment_of_dead_feeder_pid():
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_strand_segment,
                    args=(np.ones((4, 8), np.float32),))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 0
    stranded = [f for f in _segments() if f"_{p.pid}_" in f]
    assert len(stranded) == 1  # the child really left one behind
    # within the grace window nothing is touched (consumer may be attaching)
    assert _sweep(3600.0, stranded) == 0
    assert any(f"_{p.pid}_" in f for f in _segments())
    # past the grace window, the dead creator's segment is reaped
    assert _sweep(0.0, stranded) >= 1
    assert not any(f"_{p.pid}_" in f for f in _segments())


def test_sweep_never_reaps_excluded_inflight_segments():
    """A segment whose descriptor still sits in a manager queue is in
    flight no matter how old or how dead its creator — the manager passes
    those names as ``exclude`` (a short-lived feeder pid exits right after
    a successful handoff; queue residency can outlive it arbitrarily)."""
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_strand_segment,
                    args=(np.ones((4, 8), np.float32),))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 0
    stranded = [f for f in _segments() if f"_{p.pid}_" in f]
    assert len(stranded) == 1
    try:
        # dead creator + zero grace, but the name is excluded: kept
        assert _sweep(0.0, stranded, exclude={stranded[0]}) == 0
        assert stranded[0] in _segments()
    finally:
        # unexcluded it is ordinary orphan garbage again
        assert _sweep(0.0, stranded) >= 1
    assert stranded[0] not in _segments()


def test_read_chunk_corrupt_descriptor_surfaces_real_error():
    """A descriptor whose column metadata overruns the segment must raise
    the informative numpy error, not a masking BufferError from closing a
    still-exported mmap — and must still consume the segment."""
    ref = shm.write_chunk(shm.columnarize(_rows()))
    bad = shm.ShmChunkRef(ref.name, (((10**6, 10**6), "<f4", 0),),
                          ref.nrows, None, ref.nbytes)
    with pytest.raises((TypeError, ValueError)):
        shm.read_chunk(bad)
    assert ref.name not in _segments()  # consumed (read-once) either way


def test_keepalive_protects_inflight_segments_from_foreign_sweepers():
    """Exclusion only protects a segment from the excluding manager; on a
    multi-executor host OTHER managers' sweeps judge age from mtime — the
    owner's periodic ``keepalive`` touch is what keeps a long-queued
    descriptor's segment alive for everyone."""
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_strand_segment,
                    args=(np.ones((4, 8), np.float32),))
    p.start()
    p.join(timeout=60)
    assert p.exitcode == 0
    stranded = [f for f in _segments() if f"_{p.pid}_" in f]
    assert len(stranded) == 1
    path = os.path.join("/dev/shm", stranded[0])
    old = time.time() - 3600
    os.utime(path, (old, old))  # long queue residency, creator long dead
    try:
        shm.keepalive(stranded)  # the owning manager's watch-cycle touch
        # a FOREIGN sweeper (no exclusion — it can't know our queues) now
        # sees a fresh segment and keeps it
        assert _sweep(60.0, stranded) == 0
        assert stranded[0] in _segments()
        # keepalive on consumed/unknown names is a silent no-op
        shm.keepalive([f"{shm.SEG_PREFIX}_1_1_gonegonegone"])
    finally:
        assert _sweep(0.0, stranded) >= 1
    assert stranded[0] not in _segments()


def test_resident_gauges_see_parked_segments():
    """A parked segment shows up in resident_stats/update_gauges (the
    manager watch thread's leak visibility) and disappears on consume."""
    from tensorflowonspark_torch import obs

    ref = shm.write_chunk(shm.columnarize(_rows()))
    try:
        count, nbytes = shm.update_gauges()
        assert count >= 1
        assert nbytes >= ref.nbytes
        assert obs.gauge("shm_segments_live").value == count
        assert obs.gauge("shm_bytes_resident").value == nbytes
    finally:
        shm.unlink_ref(ref)
    assert ref.name not in _segments()


def test_sweep_keeps_live_creator_segments():
    ref = shm.write_chunk(shm.columnarize(_rows()))  # creator: this process
    try:
        assert _sweep(0.0, [ref.name]) == 0
        assert ref.name in _segments()  # still parked, still consumable
        out, _ = shm.read_chunk(ref)
        assert out[0].shape == (6, 4)
    finally:
        shm.unlink_ref(ref)


def test_sweep_ignores_foreign_and_malformed_names():
    # same pid, WRONG start tick → a recycled pid must read as dead
    name = f"{shm.SEG_PREFIX}_{os.getpid()}_1_deadbeef0000"
    path = os.path.join("/dev/shm", name)
    with open(path, "wb") as f:
        f.write(b"x")
    old = time.time() - 3600
    os.utime(path, (old, old))
    try:
        assert _sweep(60.0, [name]) == 1
        assert not os.path.exists(path)
    finally:
        if os.path.exists(path):
            os.unlink(path)
    # names that don't parse are never touched
    weird = os.path.join("/dev/shm", f"{shm.SEG_PREFIX}_notapid_x_y")
    with open(weird, "wb") as f:
        f.write(b"x")
    os.utime(weird, (old, old))
    try:
        assert _sweep(0.0, [os.path.basename(weird)]) == 0
        assert os.path.exists(weird)
    finally:
        os.unlink(weird)
