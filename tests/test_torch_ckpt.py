"""The port's checkpoint store (``tensorflowonspark_torch.ckpt``).

Ports of ``tests/test_ckpt.py``'s four cases, plus what the port's store
must hold because torch updates tensors in place: a half-written step is
never named, an asynchronous save writes the state as it was when the
save returned (not as the next steps left it), and a ``://`` directory
works through a scheme registered with ``fs.register``.
"""

import io
import os
import threading

import numpy as np
import pytest
import torch

from tensorflowonspark_torch import ckpt, compat, fs


def _tree_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))


class MemFS(fs.FileSystem):
    """In-memory filesystem for a mock scheme (``mock://…``)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.dirs: set[str] = set()

    def open(self, path, mode="rb"):
        if "w" in mode:
            outer = self

            class W(io.BytesIO):
                def close(self_inner):
                    outer.files[path] = self_inner.getvalue()
                    super().close()

            return W()
        if path not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[path])

    def listdir(self, path):
        prefix = path.rstrip("/") + "/"
        return sorted({p[len(prefix):].split("/")[0]
                       for p in list(self.files) + list(self.dirs)
                       if p.startswith(prefix)})

    def exists(self, path):
        prefix = path.rstrip("/") + "/"
        return (path in self.files or path in self.dirs
                or any(p.startswith(prefix) for p in self.files))

    def makedirs(self, path):
        self.dirs.add(path)

    def glob(self, pattern):
        import fnmatch

        return sorted(p for p in self.files if fnmatch.fnmatch(p, pattern))

    def remove(self, path):
        prefix = path.rstrip("/") + "/"
        for p in [p for p in self.files if p == path or p.startswith(prefix)]:
            del self.files[p]
        self.dirs = {d for d in self.dirs
                     if d != path and not d.startswith(prefix)}


@pytest.fixture()
def memfs():
    m = MemFS()
    fs.register("mock", m)
    yield m
    fs.unregister("mock")


def test_save_load_roundtrip(tmp_path):
    state = {
        "params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "b": np.zeros(3)},
        "step": np.int32(7),
    }
    path = ckpt.save_pytree(state, str(tmp_path / "export"))
    restored = ckpt.load_pytree(path)
    _tree_close(restored["params"]["w"], state["params"]["w"])
    _tree_close(restored["step"], 7)


def test_checkpoint_manager_retention_and_latest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"w": np.full((2,), float(step))})
    mgr.wait_until_finished()
    assert mgr.latest_step() == 3
    assert mgr.all_steps() == [2, 3]  # the oldest went
    restored = mgr.restore()
    _tree_close(restored["w"], np.full((2,), 3.0))
    mgr.close()


def test_export_saved_model_shim(tmp_path):
    out = compat.export_saved_model({"w": np.ones(4)}, str(tmp_path / "exp"))
    restored = ckpt.load_pytree(out)
    _tree_close(restored["w"], np.ones(4))


def test_targetless_restore_is_device_agnostic(tmp_path):
    """Without a target the restore is numpy, whatever device the tensors
    were on (a checkpoint written on the card loads on a CPU host); with
    one, it copies into the target's tensors in place."""
    w = torch.arange(16.0).reshape(8, 2)
    path = ckpt.save_pytree({"w": w, "step": 3}, str(tmp_path / "ck"))
    restored = ckpt.load_pytree(path)
    assert type(restored["w"]) is np.ndarray
    _tree_close(restored["w"], np.arange(16.0).reshape(8, 2))
    target = {"w": torch.zeros(8, 2), "step": 0}
    live = target["w"]
    out = ckpt.load_pytree(path, target)
    assert out["w"] is live and torch.equal(live, w)
    assert out["step"] == 3 and type(out["step"]) is int
    with pytest.raises(KeyError):
        ckpt.load_pytree(path, {"w": torch.zeros(8, 2)})
    with pytest.raises(ValueError):
        ckpt.load_pytree(path, {"w": torch.zeros(4, 2), "step": 0})


def test_half_written_step_is_never_named(tmp_path):
    """A step counts once it is committed: a write that died before its
    rename (the temporary directory) and a step directory without its
    file are not steps."""
    d = tmp_path / "ck"
    mgr = ckpt.CheckpointManager(str(d), max_to_keep=5)
    mgr.save(4, {"w": np.ones(3)})
    (d / ".tmp-8-123").mkdir()
    (d / ".tmp-8-123" / "pytree.npz").write_bytes(b"PK\x03\x04half")
    (d / "9").mkdir()  # a directory, no committed file
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [4]
    assert mgr.restore_latest()[0] == 4
    # and a failing write leaves the committed steps as they were
    orig = ckpt._write

    def dying_write(flat, path):
        os.makedirs(path, exist_ok=True)
        open(os.path.join(path, "pytree.npz"), "wb").write(b"PK")
        raise OSError("disk full")

    ckpt._write = dying_write
    try:
        with pytest.raises(OSError, match="disk full"):
            mgr.save(12, {"w": np.zeros(3)})
    finally:
        ckpt._write = orig
    assert mgr.latest_step() == 4
    _tree_close(mgr.restore()["w"], np.ones(3))


def test_async_save_writes_the_snapshot_not_the_live_tensors(
        tmp_path, monkeypatch):
    """The writer is held back while the params change in place (as the
    optimizer changes them): what commits is the state when ``save``
    returned, bit for bit."""
    gate = threading.Event()
    orig = ckpt._write

    def slow_write(flat, path):
        assert gate.wait(30)
        orig(flat, path)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    acc = torch.rand(100)
    snapshot = (w.clone(), acc.clone())
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.save(1, {"params": {"w": w}, "collections": {"acc": acc},
                 "step": 1})
    assert mgr.latest_step() is None  # in flight: not committed
    for _ in range(3):  # the next steps, in place
        w.mul_(0.5).add_(1.0)
        acc.add_(2.0)
    gate.set()
    mgr.wait_until_finished()
    assert mgr.latest_step() == 1
    back = mgr.restore()
    assert np.array_equal(back["params"]["w"], snapshot[0].numpy())
    assert np.array_equal(back["collections"]["acc"], snapshot[1].numpy())
    assert int(back["step"]) == 1
    mgr.close()


def test_async_save_reuses_no_buffer_a_write_still_reads(tmp_path,
                                                         monkeypatch):
    """Two saves in flight each keep their own snapshot; a third waits
    for the oldest and then reuses its buffers."""
    gate = threading.Event()
    orig = ckpt._write

    def slow_write(flat, path):
        assert gate.wait(30)
        orig(flat, path)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    w = torch.zeros(5)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), max_to_keep=None,
                                 async_save=True)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.save(2, {"w": w})
    w.add_(1.0)
    assert len(mgr._in_flight) == 2
    gate.set()
    mgr.save(3, {"w": w})
    mgr.wait_until_finished()
    for step in (1, 2, 3):
        _tree_close(mgr.restore(step)["w"], np.full(5, step - 1.0))
    mgr.close()


def test_reserve_allocates_the_snapshots_before_the_first_save(tmp_path):
    """``reserve`` allocates the buffers of every snapshot that may be in
    flight; the saves then take them as they are (nothing allocated on
    the step path).  A synchronous manager reserves nothing."""
    w = torch.arange(12.0).reshape(4, 3)
    mgr = ckpt.CheckpointManager(str(tmp_path / "a"), async_save=True)
    mgr.reserve({"w": w, "step": 0})
    reserved = {id(s): s.buffers["w"] for s in mgr._free}
    assert len(reserved) == ckpt._MAX_IN_FLIGHT
    for step in (1, 2):
        mgr.save(step, {"w": w, "step": step})
        snap = mgr._in_flight[-1][1]
        assert snap.buffers["w"] is reserved[id(snap)]
        w.add_(1.0)
    mgr.wait_until_finished()
    _tree_close(mgr.restore(2)["w"], np.arange(12.0).reshape(4, 3) + 1)
    mgr.close()
    sync = ckpt.CheckpointManager(str(tmp_path / "b"))
    sync.reserve({"w": w})
    assert sync._free == []


@pytest.mark.cuda
def test_async_snapshot_on_the_card_is_the_state_save_saw(tmp_path,
                                                          monkeypatch):
    """On a card the snapshot is a clone in one device block, which the
    writer copies into its pinned host block on a side stream: with the
    writer held back and kernels queued right after ``save`` changing the
    tensors in place (a channels_last one among them), what commits is
    the state ``save`` saw; ``reserve`` allocates both blocks and the
    saves reuse them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the clone and its side-stream "
                    "copy run only there")
    gate = threading.Event()
    orig = ckpt._write

    def slow_write(flat, path):
        assert gate.wait(60)
        orig(flat, path)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(64, 256, 7, 7, generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    big = torch.randn(4096, 4096, generator=gen, device="cuda")
    host = torch.arange(5.0)
    tree = {"params": {"w": w, "big": big}, "host": host, "step": 1}
    want = {"w": w.cpu().numpy(), "big": big.cpu().numpy(),
            "host": host.numpy().copy()}
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), async_save=True)
    mgr.reserve(tree)
    snap = mgr._free[-1]
    assert snap.block.is_cuda and snap.block.numel() >= 4 * (
        w.numel() + big.numel())
    pinned = mgr._staging.block(snap.block.numel())
    assert pinned.is_pinned()
    mgr.save(1, tree)
    assert mgr._in_flight[0][1] is snap
    for _ in range(20):  # queued behind the clone, before the writer runs
        big.copy_(big @ big * 1e-3)
        w.mul_(0.5).add_(1.0)
    host.add_(1.0)
    gate.set()
    mgr.wait_until_finished()
    back = mgr.restore(1)
    assert np.array_equal(back["params"]["w"], want["w"])
    assert np.array_equal(back["params"]["big"], want["big"])
    assert np.array_equal(back["host"], want["host"])
    assert int(back["step"]) == 1
    assert mgr._staging.block(snap.block.numel()) is pinned
    mgr.save(2, {**tree, "step": 2})
    assert mgr._in_flight[-1][1] is snap
    mgr.wait_until_finished()
    back = mgr.restore(2)
    assert np.array_equal(back["params"]["w"], w.cpu().numpy())
    assert np.array_equal(back["params"]["big"], big.cpu().numpy())
    mgr.close()


def test_async_write_error_surfaces(tmp_path, monkeypatch):
    def failing_write(flat, path):
        raise OSError("no space left")

    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"), async_save=True)
    monkeypatch.setattr(ckpt, "_write", failing_write)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="no space left"):
        mgr.wait_until_finished()
    assert mgr.latest_step() is None


def test_remote_directory_through_a_registered_scheme(memfs):
    """``mock://`` paths: one-shot save/load, and step checkpoints that
    commit by a marker, keep ``max_to_keep`` and never name a step whose
    marker is missing."""
    path = ckpt.save_pytree({"w": np.arange(3.0)}, "mock://bucket/export")
    assert path == "mock://bucket/export"
    _tree_close(ckpt.load_pytree(path)["w"], np.arange(3.0))

    mgr = ckpt.CheckpointManager("mock://bucket/ck", max_to_keep=2,
                                 async_save=True)
    for step in (2, 4, 6):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    mgr.wait_until_finished()
    assert mgr.all_steps() == [4, 6]
    assert not any(p.startswith("mock://bucket/ck/2/") for p in memfs.files)
    # a step whose file landed but whose marker did not
    ckpt._write({"w": np.zeros(2)}, "mock://bucket/ck/8")
    assert mgr.latest_step() == 6
    step, state = mgr.restore_latest()
    assert step == 6
    _tree_close(state["w"], np.full(2, 6.0))
    mgr.close()
