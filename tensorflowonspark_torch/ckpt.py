"""Save/load of nested dicts of arrays, and step-numbered training
checkpoints.

Reference anchor: ``tensorflowonspark_tpu/ckpt.py`` (Orbax there).  TFoS's
recovery model is ``spark.task.maxFailures=1`` plus a restart from the last
checkpoint; the framework persists nothing else of its own.

The port's format is a directory holding one ``pytree.npz``: every leaf
stored under its key path joined by ``/``, read back with
``allow_pickle=False`` so loading a checkpoint or an export runs no code.
Local paths and ``fs`` URIs (``gs://``, ``hdfs://``, a scheme registered
with ``fs.register``) both work.

- :func:`save_pytree` / :func:`load_pytree`: one-shot export and import
  (``compat.export_saved_model``, ``TFModel``, ``Trainer.save``).
- :class:`CheckpointManager`: step-numbered checkpoints with retention and
  an optional asynchronous write.  A step counts once it is committed: a
  local step is written under a temporary name and renamed into place, a
  remote one gets a ``COMMITTED`` marker after its file, so
  :meth:`CheckpointManager.latest_step` never names a half-written step.

Torch tensors are updated in place by the optimizer and the table kernel
(where JAX arrays are immutable), so an asynchronous save snapshots before
it returns: a clone on the card (copies into one device block on the
current stream, and an event), which the writer thread copies into one
pinned host block on a side stream; the step path pays the clone's launches and
nothing of the host copy (on the CPU, the copy itself).
:meth:`CheckpointManager.reserve` allocates both kinds of buffers before
the first save.  A buffer set is not reused while a write that reads it
is still running.
"""

from __future__ import annotations

import concurrent.futures
import io
import logging
import os
import threading
from typing import Any, Mapping

import numpy as np

from tensorflowonspark_torch import fs

logger = logging.getLogger(__name__)

_FILE = "pytree.npz"
_SEP = "/"
_COMMITTED = "COMMITTED"
#: asynchronous writes in flight before a save waits for the oldest
_MAX_IN_FLIGHT = 2


def _canonical(path: str) -> str:
    """Absolutize local paths; leave URIs (``gs://``, ``hdfs://``) alone."""
    if "://" in path:
        return path
    return os.path.abspath(path)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, Any]:
    """``{key path: leaf}``; leaves as given (tensors stay tensors)."""
    out = {}
    for k, v in tree.items():
        k = str(k)
        if not k or _SEP in k:
            raise ValueError(f"pytree key {k!r} is empty or holds {_SEP!r}")
        if isinstance(v, Mapping):
            if not v:
                raise ValueError(f"pytree node {prefix + k!r} is empty")
            out.update(_flatten(v, prefix + k + _SEP))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, name = key.split(_SEP)
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (a tensor is copied off its
    device)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _write(flat: Mapping[str, np.ndarray], path: str) -> None:
    """``flat`` as ``path/pytree.npz``; a local file appears whole (written
    under a temporary name, then renamed)."""
    local = fs.local_path(path)
    if local is not None:
        os.makedirs(local, exist_ok=True)
        tmp = os.path.join(local, f".{_FILE}.tmp{os.getpid()}."
                                  f"{threading.get_ident()}")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, os.path.join(local, _FILE))
        return
    buf = io.BytesIO()
    np.savez(buf, **flat)
    fs.makedirs(path)
    with fs.open(fs.join(path, _FILE), "wb") as f:
        f.write(buf.getvalue())


def _read(path: str) -> dict[str, np.ndarray]:
    local = fs.local_path(path)
    if local is not None:
        source = os.path.join(local, _FILE)
    else:
        with fs.open(fs.join(path, _FILE), "rb") as f:
            source = io.BytesIO(f.read())
    with np.load(source, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save_pytree(state: Mapping[str, Any], path: str) -> str:
    """Save a nested dict of arrays (numpy, tensors on any device, or
    anything ``np.asarray`` takes) into the directory ``path``.  Returns
    the canonical path."""
    from tensorflowonspark_torch import obs

    path = _canonical(path)
    with obs.span("ckpt.save", path=path):
        flat = {k: _host_array(v) for k, v in _flatten(state).items()}
        _write(flat, path)
    logger.info("saved %d arrays to %s", len(flat), path)
    return path


def load_pytree(path: str, target: Any | None = None) -> Any:
    """The nested dict saved by :func:`save_pytree`.

    Without ``target`` it holds **numpy** arrays, whatever device wrote
    them: a checkpoint written on the card loads on a CPU host.  With
    ``target`` (a nested dict of the same keys) each array is copied into
    the target's leaf: a tensor in place on its own device, a numpy array
    in place, a Python scalar converted to its type; the target is
    returned.  Keys, shapes and dtypes must match."""
    from tensorflowonspark_torch import obs

    path = _canonical(path)
    with obs.span("ckpt.restore", path=path, targeted=target is not None):
        tree = _unflatten(_read(path))
        if target is None:
            return tree
        return copy_into(target, tree)


def copy_into(target, tree, where: str = ""):
    """Copy the nested dict ``tree`` (numpy leaves) into ``target`` (see
    :func:`load_pytree`); returns the target's structure with its leaves
    (tensors and arrays updated in place, scalars converted)."""
    import torch

    if isinstance(target, Mapping):
        if not isinstance(tree, Mapping) or set(target) != set(tree):
            have = sorted(tree) if isinstance(tree, Mapping) else "a leaf"
            raise KeyError(f"checkpoint node {where or '/'!r} holds {have}; "
                           f"the target wants {sorted(target)}")
        return {k: copy_into(v, tree[k], f"{where}/{k}")
                for k, v in target.items()}
    if isinstance(tree, Mapping):
        raise KeyError(f"checkpoint node {where!r} is a dict; the target "
                       "wants a leaf")
    if isinstance(target, torch.Tensor):
        src = torch.as_tensor(np.asarray(tree))
        if src.shape != target.shape or src.dtype != target.dtype:
            raise ValueError(f"checkpoint leaf {where!r} is {src.dtype}"
                             f"{list(src.shape)}; the target is "
                             f"{target.dtype}{list(target.shape)}")
        with torch.no_grad():
            target.copy_(src)
        return target
    if isinstance(target, np.ndarray):
        if tree.shape != target.shape:
            raise ValueError(f"checkpoint leaf {where!r} has shape "
                             f"{tree.shape}; the target {target.shape}")
        target[...] = tree
        return target
    return type(target)(tree.item()) if np.ndim(tree) == 0 else tree


def _tensors(flat: Mapping[str, Any]) -> dict[str, Any]:
    import torch

    return {k: v.detach() for k, v in flat.items()
            if isinstance(v, torch.Tensor)}


def _layout(tensors: Mapping[str, Any]) -> tuple:
    return tuple((k, tuple(v.shape), v.stride(), v.dtype, v.device)
                 for k, v in tensors.items())


_ALIGN = 64


def _packing(tensors: Mapping[str, Any]) -> tuple[dict, int]:
    """``({key: (byte offset, bytes, dtype, shape)}, total bytes)``: the
    tensors packed C-contiguous into one byte block, each at a 64-byte
    boundary."""
    packing, total = {}, 0
    for k, v in tensors.items():
        nbytes = v.numel() * v.element_size()
        packing[k] = (total, nbytes, v.dtype, tuple(v.shape))
        total += -(-nbytes // _ALIGN) * _ALIGN
    return packing, total


def _unpack(block, packing: Mapping[str, tuple]) -> dict[str, Any]:
    """The tensors of ``packing`` as views of the byte tensor ``block``."""
    return {k: block[offset:offset + nbytes].view(dtype).view(shape)
            for k, (offset, nbytes, dtype, shape) in packing.items()}


class _Snapshot:
    """A tree's leaves copied off the live tensors: a card's tensors into
    one device block (C-contiguous views, copied on the current stream,
    with an event the writer waits on), CPU tensors into buffers of their
    own, numpy copies of everything else.  :meth:`arrays` runs on the
    writer thread: it copies the device block into the writer's pinned
    host block on a side stream, so the step path pays neither that copy
    nor host memory.  The buffers are allocated once for a layout of
    leaves and reused by the next :meth:`take` of the same layout."""

    def __init__(self):
        self.layout = None
        self.block = None
        self.packing: dict[str, tuple] = {}
        self.buffers: dict[str, Any] = {}
        self.event = None
        self.other: dict[str, np.ndarray] = {}

    def _allocate(self, tensors: Mapping[str, Any]) -> None:
        import torch

        cards = {k: v for k, v in tensors.items() if v.is_cuda}
        devices = {v.device for v in cards.values()}
        if len(devices) > 1:
            raise ValueError(f"a checkpoint's tensors lie on {devices}: "
                             "one card a process")
        self.packing, total = _packing(cards)
        self.block = (torch.empty(total, dtype=torch.uint8,
                                  device=devices.pop()) if cards else None)
        self.buffers = _unpack(self.block, self.packing) if cards else {}
        self.buffers.update({
            k: torch.empty_like(v, memory_format=torch.contiguous_format)
            for k, v in tensors.items() if not v.is_cuda})
        self.layout = _layout(tensors)

    def take(self, flat: Mapping[str, Any]) -> "_Snapshot":
        import torch

        tensors = _tensors(flat)
        self.other = {k: np.array(v) for k, v in flat.items()
                      if k not in tensors}
        if _layout(tensors) != self.layout:
            self._allocate(tensors)
        # one _foreach_copy_ a group: its multi-tensor route needs the same
        # device and strides on both sides, and the buffers are contiguous
        groups: dict[tuple, list[str]] = {}
        for k, v in tensors.items():
            groups.setdefault((v.device, v.is_contiguous()), []).append(k)
        for keys in groups.values():
            torch._foreach_copy_([self.buffers[k] for k in keys],
                                 [tensors[k] for k in keys])
        self.event = None
        if self.block is not None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.block.device))
        return self

    def arrays(self, staging: "_HostStaging") -> dict[str, np.ndarray]:
        """The snapshot's arrays on the host: the device block copied into
        ``staging``'s pinned block on a side stream that waits for the
        snapshot's event."""
        import torch

        host = dict(self.buffers)
        if self.block is not None:
            pinned = staging.block(self.block.numel())
            side = torch.cuda.Stream(self.block.device)
            with torch.cuda.stream(side):
                side.wait_event(self.event)
                pinned.copy_(self.block, non_blocking=True)
            side.synchronize()
            host.update(_unpack(pinned, self.packing))
        out = {k: b.numpy() for k, b in host.items()}
        out.update(self.other)
        return out


class _HostStaging:
    """The writer's pinned host block, which a snapshot's device block is
    copied into: allocated for a size and reused by every write of that
    size (the writer runs one write at a time)."""

    def __init__(self):
        self._block = None

    def block(self, nbytes: int):
        import torch

        if self._block is None or self._block.numel() != nbytes:
            self._block = None
            self._block = torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=True)
        return self._block


class CheckpointManager:
    """Step-numbered checkpoints with retention, for mid-training recovery.

    One directory per step (``<directory>/<step>/pytree.npz``); the newest
    ``max_to_keep`` committed steps are kept (``None`` or 0 keeps all).
    With ``async_save`` a save snapshots the state and returns; one
    writer thread commits the steps in order, at most two in flight."""

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 async_save: bool = False):
        self._directory = _canonical(directory)
        fs.makedirs(self._directory)
        self._local = fs.local_path(self._directory)
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._writer = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tfos-ckpt")
            if async_save else None)
        self._in_flight: list[tuple[concurrent.futures.Future,
                                    _Snapshot]] = []
        self._free: list[_Snapshot] = []
        self._staging = _HostStaging()

    @property
    def directory(self) -> str:
        return self._directory

    def reserve(self, state: Mapping[str, Any]) -> None:
        """Allocate now what asynchronous saves of ``state``'s layout use:
        the buffers of the snapshots that may be in flight, on the state's
        devices (filled once, so the copies' first launches are paid here
        too), the writer's pinned host block and its thread.  Otherwise
        the first saves allocate them: device memory on the step path,
        pinned memory on the writer thread while steps run (either
        allocation may hold back the card's other work)."""
        if self._writer is None:
            return
        import torch

        flat = _flatten(state)
        while len(self._free) < _MAX_IN_FLIGHT:
            self._free.append(_Snapshot().take(flat))
        block = self._free[-1].block
        if block is not None:
            self._staging.block(block.numel())
            # the writer thread started, with the stream its copies use
            self._writer.submit(torch.cuda.Stream, block.device).result()

    def _step_path(self, step: int) -> str:
        return fs.join(self._directory, str(int(step)))

    def save(self, step: int, state: Mapping[str, Any]) -> None:
        """Checkpoint ``state`` (a nested dict of tensors, arrays and
        scalars) as ``step``.  Asynchronous: returns once the snapshot is
        taken; the write runs behind.  A failed earlier write raises
        here."""
        from tensorflowonspark_torch import obs

        flat = _flatten(state)
        with obs.span("ckpt.save", path=self._directory, step=int(step)):
            if self._writer is None:
                self._commit(step, {k: _host_array(v)
                                    for k, v in flat.items()})
                return
            self._reap(block=len(self._in_flight) >= _MAX_IN_FLIGHT)
            snap = (self._free.pop() if self._free else _Snapshot()).take(
                flat)
            future = self._writer.submit(
                lambda: self._commit(step, snap.arrays(self._staging)))
            self._in_flight.append((future, snap))

    def _reap(self, block: bool) -> None:
        """Retire finished writes (the oldest one waited for with
        ``block``), returning their buffers; re-raise a write's error."""
        while self._in_flight and (block or self._in_flight[0][0].done()):
            future, snap = self._in_flight.pop(0)
            block = False
            try:
                future.result()
            finally:
                self._free.append(snap)

    def _commit(self, step: int, flat: Mapping[str, np.ndarray]) -> None:
        final = self._step_path(step)
        if self._local is not None:
            import shutil

            tmp = os.path.join(self._local, f".tmp-{int(step)}-"
                                            f"{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            _write(flat, tmp)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        else:
            marker = fs.join(final, _COMMITTED)
            if fs.exists(marker):
                fs.remove(marker)
            _write(flat, final)
            with fs.open(marker, "wb") as f:
                f.write(b"")
        logger.info("committed checkpoint step %d under %s", step,
                    self._directory)
        self._prune()

    def _prune(self) -> None:
        if not self._max_to_keep:
            return
        for step in self.all_steps()[:-self._max_to_keep]:
            try:
                fs.remove(self._step_path(step))
            except NotImplementedError:
                logger.warning("cannot delete old checkpoint %s: its "
                               "filesystem has no remove", step)
                return

    def all_steps(self) -> list[int]:
        """The committed steps, oldest first."""
        if not fs.exists(self._directory):
            return []
        proof = _FILE if self._local is not None else _COMMITTED
        return sorted(int(name) for name in fs.listdir(self._directory)
                      if name.isdigit() and fs.exists(
                          fs.join(self._directory, name, proof)))

    def latest_step(self) -> int | None:
        """The newest committed step (a write still in flight does not
        count), or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, target: Any | None = None
                ) -> Any:
        """Checkpoint ``step`` (default: the newest committed), as
        :func:`load_pytree` returns it for ``target``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._directory}")
        return load_pytree(self._step_path(step), target)

    def restore_latest(self, target: Any | None = None
                       ) -> tuple[int, Any] | None:
        """``(step, state)`` of the newest committed checkpoint, or None
        when none has committed yet."""
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, target=target)

    def wait_until_finished(self) -> None:
        """Block until every asynchronous write has committed; re-raise
        the first write's error."""
        while self._in_flight:
            self._reap(block=True)

    def close(self) -> None:
        self.wait_until_finished()
        if self._writer is not None:
            self._writer.shutdown()
