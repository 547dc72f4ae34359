"""The AdaGrad table update on the card: ``csrc/sparse_adagrad.cu``.

Two launches a table update, each one ``ctypes`` call on the current
stream, with no host synchronisation:

- :func:`group` groups the flat ids by row (the hand-written grouping
  kernel); :class:`Grouping` holds its outputs on the device.  Its plain
  version is ``embedding.group_ids_plain``, built on ``embedding.sort_ids``.
- :func:`update` updates one or two tables whose ids share that grouping
  (the wide&deep step's deep and wide tables in one launch).  Its plain
  version is ``embedding.sparse_adagrad_update_plain``, once a table.

Each checks what its kernel takes and raises on anything else; neither
falls back.  Launches count in :data:`launches` and
:data:`launches_by_path`: ``group`` once a grouping, and ``combine`` or
``sparse`` once an update launch, whether it updates one table or two.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch

#: Kernel launches in this process: one per :func:`group` or :func:`update`
#: (inside a CUDA graph's capture too; a replay of the graph calls no
#: wrapper and counts nothing: ``parallel.train.replayed_steps``).
launches = 0
#: The same launches by kernel and mode: ``group`` (the id grouping),
#: ``sparse`` (per-occurrence accumulation, the reference's
#: ``sparse_adagrad_update``) and ``combine`` (duplicates summed first, the
#: dense path's function).
launches_by_path = {"group": 0, "sparse": 0, "combine": 0}

#: The largest id count and vocab the grouping takes: positions and keys
#: (an out-of-range id's key is ``vocab``) are int32.
MAX_IDS = 2**31 - 1
MAX_VOCAB = 2**31 - 1

_LIB = None


class Grouping(NamedTuple):
    """The flat ids of one step grouped by row, on their device.

    ``keys`` (n int32): the wrapped ids, in-range ones first in row order,
    then every out-of-range occurrence with key ``vocab`` (the dropped
    tail); ``pos`` (n int32): each key's position in the batch, in batch
    order within a row; ``seg_start`` (n + 1 int32): the rows' segment
    starts in ``keys``, then the in-range count in every later entry (so a
    segment past the last is empty); ``seg_row`` (n int32): each segment's
    row (entries past the last segment undefined); ``meta`` (2 int32): the
    segment count and the in-range count.  ``n`` and ``vocab`` are the
    sizes it was made for, which :func:`update` checks (it cannot read the
    ids without a sync)."""

    keys: torch.Tensor
    pos: torch.Tensor
    seg_start: torch.Tensor
    seg_row: torch.Tensor
    meta: torch.Tensor
    n: int
    vocab: int

    @classmethod
    def empty(cls, n: int, vocab: int, device) -> "Grouping":
        """Uninitialised outputs: views of one int32 buffer, with the
        sort's scratch (2n) after ``pos``."""
        buf = torch.empty(6 * n + 3, dtype=torch.int32, device=device)
        return cls(buf[:n], buf[n:2 * n], buf[5 * n:6 * n + 1],
                   buf[4 * n:5 * n], buf[6 * n + 1:], n, vocab)

    def scratch(self) -> tuple[int, int]:
        """Device addresses of the sort's two scratch arrays (n int32
        each), between ``pos`` and ``seg_row``."""
        base = self.pos.data_ptr() + 4 * self.n
        return base, base + 4 * self.n


def reset_launches() -> None:
    """Zero :data:`launches` and :data:`launches_by_path`."""
    global launches
    launches = 0
    for k in launches_by_path:
        launches_by_path[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from tensorflowonspark_torch.kernels import _build

        lib = _build.load("sparse_adagrad")
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float)
        lib.tfos_group_ids.argtypes = [p, i32, i64, i64, p, p, p, p, p, p, p,
                                       p]
        lib.tfos_group_ids.restype = i32
        lib.tfos_adagrad_segments_f32.argtypes = [
            p, p, p, i64, i64, i32, p, p, p, i32, p, p, p, i32, f32, f32, i32,
            p]
        lib.tfos_adagrad_segments_f32.restype = i32
        _LIB = lib
    return _LIB


@contextlib.contextmanager
def _on(device: torch.device):
    """The current stream of ``device``, as a raw pointer."""
    index = device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        yield torch._C._cuda_getCurrentRawStream(index)


def _count(path: str) -> None:
    global launches
    launches += 1
    launches_by_path[path] += 1


def group(flat: torch.Tensor, vocab: int) -> Grouping:
    """Group the flat int32 or int64 ids ``flat`` (a contiguous CUDA tensor)
    for a table of ``vocab`` rows: one launch of the grouping kernel."""
    if flat.device.type != "cuda":
        raise ValueError(f"grouping kernel: ids on {flat.device}, want cuda")
    if flat.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"grouping kernel: ids must be int32 or int64, got "
                        f"{flat.dtype}")
    n = flat.numel()
    if flat.dim() != 1 or n > MAX_IDS:
        raise ValueError(f"grouping kernel: takes a flat tensor of at most "
                         f"{MAX_IDS} ids, got shape {tuple(flat.shape)}")
    if not 0 <= vocab <= MAX_VOCAB:
        raise ValueError(f"grouping kernel: takes 0 <= vocab <= {MAX_VOCAB} "
                         f"(int32 keys), got {vocab}")
    if not flat.is_contiguous():
        raise ValueError("grouping kernel: ids must be contiguous")
    out = Grouping.empty(n, vocab, flat.device)
    with _on(flat.device) as stream:
        err = _lib().tfos_group_ids(
            flat.data_ptr(), flat.element_size(), n, vocab,
            out.keys.data_ptr(), out.pos.data_ptr(), *out.scratch(),
            out.seg_start.data_ptr(), out.seg_row.data_ptr(),
            out.meta.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"grouping kernel launch failed: CUDA error {err}")
    _count("group")
    return out


def _check_table(table, acc, g, grouping: Grouping) -> int:
    device = grouping.keys.device
    for name, t in (("table", table), ("acc", acc), ("grads", g)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"sparse_adagrad kernel needs a contiguous "
                             f"float32 {name}, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
        if t.device != device:
            raise ValueError(f"sparse_adagrad kernel: {name} on {t.device}, "
                             f"grouping on {device}")
    if acc.shape != table.shape or table.dim() < 1:
        raise ValueError(f"sparse_adagrad kernel: acc {tuple(acc.shape)} and "
                         f"table {tuple(table.shape)} must match")
    if table.shape[0] != grouping.vocab or g.shape[0] != grouping.n:
        raise ValueError(
            f"sparse_adagrad kernel: the grouping is for {grouping.n} ids "
            f"and vocab {grouping.vocab}, got {g.shape[0]} gradient rows and "
            f"a table of {table.shape[0]} rows: pass embedding.group_ids(ids,"
            f" vocab) of these ids")
    if tuple(g.shape[1:]) != tuple(table.shape[1:]):
        raise ValueError(f"sparse_adagrad kernel: gradient rows "
                         f"{tuple(g.shape[1:])}, table rows "
                         f"{tuple(table.shape[1:])}")
    return math.prod(table.shape[1:])


def update(tables, grouping: Grouping, lr: float, eps: float,
           combine: bool) -> None:
    """Update in place one or two ``(table, acc, g)`` whose ids are
    ``grouping`` (:func:`group`): ``table`` and ``acc`` ``(vocab, *row)``
    f32, ``g`` the ``(n, *row)`` f32 gradient rows.  One launch."""
    tables = list(tables)
    if not 1 <= len(tables) <= 2:
        raise ValueError(f"sparse_adagrad kernel: takes 1 or 2 tables a "
                         f"launch, got {len(tables)}")
    args = []
    for t, a, g in tables:
        dim = _check_table(t, a, g, grouping)
        args += [g.data_ptr(), t.data_ptr(), a.data_ptr(), dim]
    args += [None, None, None, 0] * (2 - len(tables))  # no second table
    with _on(grouping.keys.device) as stream:
        err = _lib().tfos_adagrad_segments_f32(
            grouping.pos.data_ptr(), grouping.seg_start.data_ptr(),
            grouping.seg_row.data_ptr(), grouping.n, grouping.vocab,
            len(tables), *args, -float(lr), float(eps),
            int(bool(combine)), stream)
    if err != 0:
        raise RuntimeError(f"sparse_adagrad kernel launch failed: CUDA error "
                           f"{err}")
    _count("combine" if combine else "sparse")
