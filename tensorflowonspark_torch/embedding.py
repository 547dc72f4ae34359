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

On CUDA tensors :func:`sparse_adagrad_update` and
:func:`sparse_adagrad_update_tables` (several tables that share their ids,
as the wide&deep step's deep and wide tables do) launch the hand-written
kernels (``kernels/sparse_adagrad.py``, ``csrc/sparse_adagrad.cu``): one
that groups the ids by row (:func:`group_ids`) and one that updates every
table from that grouping, or raise; on CPU tensors they compute
:func:`sparse_adagrad_update_plain`, once a table.
What differs from the JAX package: the update is in place (the tables are
333 MB each at ``widedeep.Config()``; a functional copy would double
that), and the function returns the same ``(table, acc)`` tensors.  Ids
are taken as JAX's ``.at[ids]`` takes them: an id in ``[-vocab, 0)`` names
row ``id + vocab``, as a negative numpy index does, and an occurrence whose
id lies outside ``[-vocab, vocab)`` is dropped, as JAX's scatter drops it.
"""

from __future__ import annotations

import torch

from tensorflowonspark_torch.kernels import sparse_adagrad

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
                          grouping: sparse_adagrad.Grouping | None = None):
    """One AdaGrad step on only the rows of ``table`` named in ``ids``, in
    place; returns ``(table, acc)``.

    ``table``: ``(vocab, *row)``; ``acc``: a float32 tensor of its shape;
    ``ids``: int32 or int64 of any shape; ``grad_rows``: the loss gradient
    with respect to ``table[ids]``, shape ``ids.shape + row``.  Rows not in
    ``ids`` stay bit-identical.  ``combine`` picks the mode (module
    docstring).  ``grouping``, on the card, is :func:`group_ids` of ``ids``
    and the table's vocab, when the caller has it already."""
    device = table.device.type
    if device == "cpu":
        return sparse_adagrad_update_plain(table, acc, ids, grad_rows, lr,
                                           eps, combine)
    _require_cuda(table, "sparse_adagrad_update")
    flat, g = _flat_rows(table, acc, ids, grad_rows, "sparse_adagrad_update")
    if grouping is None:
        grouping = group_ids(flat, table.shape[0])
    sparse_adagrad.update([(table, acc, g.contiguous())], grouping, lr, eps,
                          combine)
    return table, acc


def sparse_adagrad_update_tables(tables, ids: torch.Tensor, grads, lr: float,
                                 eps: float = EPS, combine: bool = False):
    """:func:`sparse_adagrad_update` of one or two tables whose ids are the
    same ``ids`` (the wide&deep step's deep and wide tables), in place;
    returns ``tables``.

    ``tables``: ``(table, acc)`` pairs with the same vocab, on one device;
    ``grads``: each table's ``grad_rows``, in the same order.  On the CPU
    it is one :func:`sparse_adagrad_update_plain` call a table; on the card
    one grouping of the ids and one update launch for every table."""
    tables, grads = list(tables), list(grads)
    if not 1 <= len(tables) <= 2 or len(grads) != len(tables):
        raise ValueError(f"sparse_adagrad_update_tables: takes 1 or 2 "
                         f"(table, acc) pairs and a grad_rows each, got "
                         f"{len(tables)} pairs and {len(grads)} grad_rows")
    table0 = tables[0][0]
    for table, _ in tables:
        if table.dim() < 1 or table.shape[0] != table0.shape[0]:
            raise ValueError(f"sparse_adagrad_update_tables: the tables "
                             f"share their ids, so their vocab; got shapes "
                             f"{[tuple(t.shape) for t, _ in tables]}")
        if table.device != table0.device:
            raise ValueError(f"sparse_adagrad_update_tables: tables on "
                             f"{table.device} and {table0.device}")
    if table0.device.type == "cpu":
        for (table, acc), g in zip(tables, grads):
            sparse_adagrad_update_plain(table, acc, ids, g, lr, eps, combine)
        return tables
    _require_cuda(table0, "sparse_adagrad_update_tables")
    rows = [(table, acc, _flat_rows(table, acc, ids, g,
                                    "sparse_adagrad_update_tables")[1]
             .contiguous()) for (table, acc), g in zip(tables, grads)]
    grouping = group_ids(ids.reshape(-1), table0.shape[0])
    sparse_adagrad.update(rows, grouping, lr, eps, combine)
    return tables


def _require_cuda(table: torch.Tensor, name: str) -> None:
    if table.device.type != "cuda":
        raise RuntimeError(
            f"{name}: tensors on {table.device} are not supported (cpu takes "
            "the plain path, cuda the kernels)")


def group_ids(ids: torch.Tensor, vocab: int) -> sparse_adagrad.Grouping:
    """The occurrences of ``ids`` grouped by row for a table of ``vocab``
    rows (:class:`~tensorflowonspark_torch.kernels.sparse_adagrad.Grouping`):
    the grouping kernel on a CUDA tensor, :func:`group_ids_plain` on a CPU
    tensor."""
    flat = ids.reshape(-1)
    if flat.device.type == "cpu":
        return group_ids_plain(flat, vocab)
    return sparse_adagrad.group(flat, vocab)


def group_ids_plain(ids: torch.Tensor, vocab: int) -> sparse_adagrad.Grouping:
    """:func:`group_ids` from :func:`sort_ids`: its in-range occurrences,
    then the out-of-range ones in batch order under key ``vocab``, each
    row's segment start and row (``seg_row``'s undefined tail zeroed)."""
    sorted_ids, perm = sort_ids(ids, vocab)
    inside = (sorted_ids >= 0) & (sorted_ids < vocab)
    keys = sorted_ids[inside]
    m, n = keys.numel(), sorted_ids.numel()
    head = torch.ones(m, dtype=torch.bool, device=keys.device)
    head[1:] = keys[1:] != keys[:-1]
    starts = torch.nonzero(head).reshape(-1)
    count = starts.numel()
    seg_start = torch.full((n + 1,), m, dtype=torch.int32, device=keys.device)
    seg_start[:count] = starts.int()
    seg_row = torch.zeros(n, dtype=torch.int32, device=keys.device)
    seg_row[:count] = keys[starts].int()
    keys = torch.cat([keys, torch.full((n - m,), vocab, device=keys.device,
                                       dtype=keys.dtype)])
    pos = torch.cat([perm[inside], torch.sort(perm[~inside]).values])
    meta = torch.tensor([count, m], dtype=torch.int32, device=keys.device)
    return sparse_adagrad.Grouping(keys.int(), pos.int(), seg_start, seg_row,
                                   meta, n, vocab)


def sort_ids(ids: torch.Tensor, vocab: int):
    """``(sorted flat ids, int64 positions)``: the stable sort of ``ids``,
    its negative ids wrapped into ``[0, vocab)`` first (:func:`wrap_ids`),
    which groups each row's occurrences in batch order: the library's
    counterpart of the grouping kernel, and its gates' reference."""
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
