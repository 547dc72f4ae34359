"""Sparse embedding engine: update only the rows a step actually touched.

Reference anchor: ``tensorflowonspark_tpu/embedding.py``
(``sparse_adagrad_update`` at lines 36-58, ``sparse_sgd_update`` at 61-77).
The tables live outside the optimizer; the step hands the gradient with
respect to the gathered rows (``grad_rows``, shape ``ids.shape + row``) to
:func:`sparse_adagrad_update`, which reads and writes only the rows in
``ids``.

Two modes:

- ``combine=False`` (the reference's ``sparse_adagrad_update``): the
  squared gradients of every occurrence of a row go into its accumulator
  first, then each occurrence's update ``-lr·g·rsqrt(acc + eps)`` is added,
  scaled by the post-accumulation value.
- ``combine=True``: what ``_dense_adagrad``
  (``tensorflowonspark_tpu/models/widedeep.py:283-289``) computes after the
  gather's VJP, restricted to the touched rows: the occurrences' gradients
  are summed first, then squared into ``acc``, with one update a row.  On
  an untouched row the dense pass adds ``0`` to ``acc`` and ``-0.0`` to the
  table, and ``x + (-0.0) == x`` bit for bit, so this is the same function
  as the full-table pass.

On a CUDA tensor :func:`sparse_adagrad_update` launches the hand-written
kernel (``kernels/sparse_adagrad.py``, ``csrc/sparse_adagrad.cu``) or
raises; on a CPU tensor it computes :func:`sparse_adagrad_update_plain`.
What differs from the JAX package: the update is in place (the tables are
333 MB each at ``widedeep.Config()``; a functional copy would double
that), and the function returns the same ``(table, acc)`` tensors.  Ids
are taken as JAX's ``.at[ids]`` takes them: an id in ``[-vocab, 0)`` names
row ``id + vocab``, as a negative numpy index does, and an occurrence whose
id lies outside ``[-vocab, vocab)`` is dropped, as JAX's scatter drops it.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def _flat_rows(table: torch.Tensor, acc: torch.Tensor | None,
               ids: torch.Tensor, grad_rows: torch.Tensor, name: str):
    """``(flat ids, (n, *row) f32 gradients)`` after checking that the
    arguments fit together."""
    if table.dim() < 1:
        raise ValueError(f"{name}: table must have a vocab dimension, got "
                         f"shape {tuple(table.shape)}")
    if acc is not None and (acc.shape != table.shape
                            or acc.dtype != torch.float32
                            or acc.device != table.device):
        raise ValueError(f"{name}: acc must be a float32 tensor of the "
                         f"table's shape {tuple(table.shape)} on "
                         f"{table.device}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: ids must be int32 or int64, got "
                        f"{ids.dtype}")
    row = tuple(table.shape[1:])
    if tuple(grad_rows.shape) != tuple(ids.shape) + row:
        raise ValueError(f"{name}: grad_rows has shape "
                         f"{tuple(grad_rows.shape)}, want ids.shape + row = "
                         f"{tuple(ids.shape) + row}")
    if not grad_rows.is_floating_point():
        raise TypeError(f"{name}: grad_rows must be floating point, got "
                        f"{grad_rows.dtype}")
    for what, t in (("ids", ids), ("grad_rows", grad_rows)):
        if t.device != table.device:
            raise ValueError(f"{name}: {what} on {t.device}, table on "
                             f"{table.device}")
    flat = ids.reshape(-1)
    return flat, grad_rows.reshape((flat.shape[0],) + row).float()


def wrap_ids(flat: torch.Tensor, vocab: int) -> torch.Tensor:
    """``flat`` with each id in ``[-vocab, 0)`` replaced by ``id + vocab``,
    the row a negative index names in JAX and numpy; other ids unchanged."""
    return torch.where(flat < 0, flat + vocab, flat)


def _in_range(table, flat, g):
    """Wrap the negative ids (:func:`wrap_ids`) and drop the occurrences
    whose id still lies outside ``[0, vocab)``."""
    flat = wrap_ids(flat, table.shape[0])
    keep = (flat >= 0) & (flat < table.shape[0])
    if bool(keep.all()):
        return flat, g
    return flat[keep], g[keep]


def sparse_adagrad_update_plain(table: torch.Tensor, acc: torch.Tensor,
                                ids: torch.Tensor, grad_rows: torch.Tensor,
                                lr: float, eps: float = EPS,
                                combine: bool = False):
    """:func:`sparse_adagrad_update` as plain tensor ops, in place.

    ``combine=False``: ``index_add_`` of ``g²`` into ``acc``, a gather of
    the accumulated rows, ``index_add_`` of ``-lr·g·rsqrt(acc + eps)`` into
    the table.  ``combine=True``: the literal dense path — ``index_add_``
    of the occurrences into a zero table-sized gradient (the gather's VJP),
    then the full-table pass of ``_dense_adagrad``.  On the CPU
    ``index_add_`` adds duplicates in occurrence order; on the card it uses
    atomics, in no fixed order."""
    flat, g = _flat_rows(table, acc, ids, grad_rows,
                         "sparse_adagrad_update_plain")
    flat, g = _in_range(table, flat, g)
    if combine:
        full = torch.zeros_like(acc).index_add_(0, flat, g)
        acc.add_(full * full)
        table.add_(((-lr * full) * torch.rsqrt(acc + eps)).to(table.dtype))
    else:
        acc.index_add_(0, flat, g * g)
        scale = torch.rsqrt(acc[flat] + eps)
        table.index_add_(0, flat, ((-lr * g) * scale).to(table.dtype))
    return table, acc


def sparse_adagrad_update(table: torch.Tensor, acc: torch.Tensor,
                          ids: torch.Tensor, grad_rows: torch.Tensor,
                          lr: float, eps: float = EPS, combine: bool = False,
                          order=None):
    """One AdaGrad step on only the rows of ``table`` named in ``ids``, in
    place; returns ``(table, acc)``.

    ``table``: ``(vocab, *row)``; ``acc``: a float32 tensor of its shape;
    ``ids``: int32 or int64 of any shape; ``grad_rows``: the loss gradient
    with respect to ``table[ids]``, shape ``ids.shape + row``.  Rows not in
    ``ids`` stay bit-identical.  ``combine`` picks the mode (module
    docstring).  ``order``, on the card, is :func:`sort_ids` of ``ids``
    and the table's vocab, computed once for calls that share the ids and
    the vocab (the wide&deep step's two tables)."""
    device = table.device.type
    if device == "cpu":
        return sparse_adagrad_update_plain(table, acc, ids, grad_rows, lr,
                                           eps, combine)
    if device != "cuda":
        raise RuntimeError(
            f"sparse_adagrad_update: tensors on {table.device} are not "
            "supported (cpu takes the plain path, cuda the kernel)")
    from tensorflowonspark_torch.kernels import sparse_adagrad

    flat, g = _flat_rows(table, acc, ids, grad_rows, "sparse_adagrad_update")
    if order is None:
        order = sort_ids(flat, table.shape[0])
    sparse_adagrad.launch(table, acc, flat, g, lr, eps, combine, order)
    return table, acc


def sort_ids(ids: torch.Tensor, vocab: int):
    """``(sorted flat ids, int64 positions)``: the stable sort of ``ids``,
    its negative ids wrapped into ``[0, vocab)`` first (:func:`wrap_ids`),
    that groups each row's occurrences, in batch order, for the kernel."""
    return torch.sort(wrap_ids(ids.reshape(-1), vocab), stable=True)


def sparse_sgd_update(table: torch.Tensor, ids: torch.Tensor,
                      grad_rows: torch.Tensor, lr: float, momentum=None):
    """Plain sparse SGD on the gathered rows, in place (no per-row state);
    returns ``table``.  ``momentum`` is rejected: it is a dense statistic
    (it decays rows the step never touched), so a sparse variant would
    silently change the algorithm."""
    if momentum is not None:
        raise ValueError("momentum is a dense statistic; sparse SGD "
                         "supports none (see docstring)")
    flat, g = _flat_rows(table, None, ids, grad_rows, "sparse_sgd_update")
    flat, g = _in_range(table, flat, g)
    return table.index_add_(0, flat, (-lr * g).to(table.dtype))
