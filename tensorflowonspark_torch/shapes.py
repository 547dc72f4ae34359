"""Serving shape policy: signatures, bucket ladders, warm-shape enumeration.

Reference anchor: ``tensorflowonspark_tpu/shapes.py``.  There the shape
signature is what ``jax.jit`` keys its executable cache on; PyTorch runs
eagerly and compiles nothing per shape, but the policy carries over
unchanged.  Every batch still pads to a ladder bucket, so the device only
ever sees the ladder's shapes, and the data plane counts the signatures it
hands a forward (``serving.note_compile``) to show that it does.

- :func:`signature` — canonical (structure, shape, dtype) fingerprint of a
  batch, keyed on torch and numpy dtype names alike, so a numpy batch and
  the same batch staged as tensors sign the same.
- :func:`resolve_buckets` / :func:`choose_bucket` — the bucket ladder.
- :func:`input_specs` / :func:`model_specs` / :func:`zero_batch` /
  :func:`enumerate_signatures` — the finite set of signatures a bucketed
  runtime requests for one model.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Mapping, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: zoo example-batch keys that are training targets, not model inputs
LABEL_KEYS = frozenset({"label", "start_positions", "end_positions"})

#: a leaf's shape and dtype without its data (what enumeration signs)
TensorSpec = collections.namedtuple("TensorSpec", ["shape", "dtype"])


def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _flatten(tree: Any, path: tuple = ()):
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def signature(batch: Any) -> tuple:
    """Hashable fingerprint of a batch: ``(path, shape, dtype)`` per leaf,
    dict keys sorted.  Plain data, so it is the same in every process.
    Leaves need only ``shape``/``dtype`` (arrays, tensors,
    :class:`TensorSpec`); anything else signs by its Python type."""
    out = []
    for path, leaf in _flatten(batch):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            out.append((path, tuple(int(d) for d in leaf.shape),
                        _dtype_name(leaf.dtype)))
        else:
            out.append((path, (), type(leaf).__name__))
    return tuple(out)


def resolve_buckets(batch_size: int,
                    bucket_sizes: Sequence[int] | None = None
                    ) -> tuple[int, ...]:
    """The effective bucket set: sorted, deduplicated, positive, never
    above ``batch_size`` (a chunk never exceeds it; larger buckets are
    dropped with a warning), and always ending at ``batch_size`` (else
    every tail above the largest bucket would run at its own shape).
    Unset means the single bucket ``(batch_size,)``."""
    if bucket_sizes:
        out = sorted({int(b) for b in bucket_sizes if int(b) > 0})
        kept = [b for b in out if b <= int(batch_size)]
        if len(kept) != len(out):
            logger.warning(
                "dropping bucket size(s) %s > batch_size %d: a batch never "
                "exceeds batch_size, so an oversize bucket would only pad "
                "full batches past their own size",
                [b for b in out if b > int(batch_size)], int(batch_size))
        if kept:
            if kept[-1] < int(batch_size):
                kept.append(int(batch_size))
            return tuple(kept)
    return (int(batch_size),)


def choose_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` rows; ``n`` itself when none does."""
    for b in buckets:
        if b >= n:
            return int(b)
    return int(n)


def input_specs(example: Mapping[str, Any]) -> dict[str, tuple[tuple, Any]]:
    """Per-input row templates ``{input_name: (row_shape, dtype)}`` from
    ``example``, a dict of input name → ONE example row (no batch axis).
    (The reference also reads a self-describing export's signature; that
    export is not ported yet.)"""
    specs: dict[str, tuple[tuple, Any]] = {}
    for name, row in example.items():
        a = np.asarray(row)
        specs[str(name)] = (tuple(a.shape), a.dtype)
    return specs


def model_specs(model_name: str, *, tiny: bool = False
                ) -> dict[str, tuple[tuple, Any]]:
    """Input specs from a zoo entry's own example batch, training targets
    (:data:`LABEL_KEYS`) stripped; ``tiny`` selects ``Config.tiny()``."""
    from tensorflowonspark_torch import models as model_zoo

    lib = model_zoo.get_model(model_name)
    config = lib.Config.tiny() if tiny else lib.Config()
    example = lib.example_batch(config, batch_size=1)
    rows = {k: np.asarray(v)[0] for k, v in example.items()
            if k not in LABEL_KEYS}
    if not rows:
        raise ValueError(
            f"model {model_name!r}: example batch carries only label "
            f"columns {sorted(example)} — no serving inputs to derive")
    return input_specs(rows)


def policy_specs(model_name: str, params: Any
                 ) -> dict[str, tuple[tuple, Any]]:
    """:func:`model_specs` at the geometry the loaded export's ``params``
    imply (tiny or full)."""
    from tensorflowonspark_torch import models as model_zoo
    from tensorflowonspark_torch.pipeline import _is_tiny

    lib = model_zoo.get_model(model_name)
    return model_specs(model_name, tiny=_is_tiny(params, lib))


def zero_batch(specs: Mapping[str, tuple[tuple, Any]], rows: int) -> dict:
    """An all-zeros numpy batch of ``rows`` rows shaped by ``specs``."""
    return {name: np.zeros((int(rows), *tail), dtype)
            for name, (tail, dtype) in specs.items()}


def enumerate_signatures(specs: Mapping[str, tuple[tuple, Any]],
                         buckets: Sequence[int]) -> list[tuple]:
    """One :func:`signature` per ladder bucket: the complete set a
    bucketed runtime requests for one model, signed from specs without
    materializing batches."""
    return [signature({name: TensorSpec((int(b), *tail), np.dtype(dt))
                       for name, (tail, dt) in specs.items()})
            for b in buckets]
