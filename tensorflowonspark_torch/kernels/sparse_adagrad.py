"""The AdaGrad table update on the card: ``csrc/sparse_adagrad.cu``.

:func:`launch` is what ``embedding.sparse_adagrad_update`` calls for a CUDA
tensor.  It checks what the kernel takes (f32 rows, contiguous, one
device) and the sort of the flat ids the caller passes
(``embedding.sort_ids``), launches the kernel on the current stream with
one ``ctypes`` call and counts the launch in :data:`launches` and
:data:`launches_by_path` (``"sparse"``, ``"combine"``), or raises.  It
never falls back.  The plain version is
``embedding.sparse_adagrad_update_plain``.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch

#: Kernel launches in this process: one per :func:`launch` call.
launches = 0
#: The same launches by mode: ``sparse`` (per-occurrence accumulation, the
#: reference's ``sparse_adagrad_update``) and ``combine`` (duplicates summed
#: first, the dense path's function).
launches_by_path = {"sparse": 0, "combine": 0}

_LIB = None


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

        fn = _build.load("sparse_adagrad").tfos_sparse_adagrad_f32
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, i32, p, p, p, p, i64, i64, i32, ctypes.c_float,
                       ctypes.c_float, i32, p]
        fn.restype = i32
        _LIB = fn
    return _LIB


def _check(table, acc, flat, order) -> None:
    for name, t in (("table", table), ("acc", acc)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"sparse_adagrad kernel needs a contiguous "
                             f"float32 {name}, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    sorted_ids, perm = order
    if (sorted_ids.shape != flat.shape or perm.shape != flat.shape
            or sorted_ids.dtype != flat.dtype or perm.dtype != torch.int64
            or sorted_ids.device != table.device
            or perm.device != table.device):
        raise ValueError("sparse_adagrad kernel: order must be "
                         "embedding.sort_ids(ids, vocab) for these ids")


def launch(table: torch.Tensor, acc: torch.Tensor, flat: torch.Tensor,
           g: torch.Tensor, lr: float, eps: float, combine: bool,
           order) -> None:
    """Update ``table`` and ``acc`` in place for the flat ids ``flat`` and
    their f32 gradient rows ``g`` (``(n, *row)``), on the card; ``order``
    is ``embedding.sort_ids(flat, vocab)``."""
    global launches
    _check(table, acc, flat, order)
    if flat.numel() == 0:
        return
    sorted_ids, perm = order
    g = g.contiguous()
    fn = _lib()
    device = table.device.index
    dim = math.prod(table.shape[1:])
    with (contextlib.nullcontext() if device == torch.cuda.current_device()
          else torch.cuda.device(device)):
        stream = torch._C._cuda_getCurrentRawStream(device)
        err = fn(sorted_ids.data_ptr(), sorted_ids.element_size(),
                 perm.data_ptr(), g.data_ptr(), table.data_ptr(),
                 acc.data_ptr(), flat.numel(), table.shape[0], dim,
                 -float(lr), float(eps), int(bool(combine)), stream)
    if err != 0:
        raise RuntimeError(f"sparse_adagrad kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launches_by_path["combine" if combine else "sparse"] += 1
