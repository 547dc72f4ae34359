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
- :func:`resolve_buckets` / :func:`choose_bucket` / :func:`batch_rows` —
  the bucket ladder.
- :func:`input_specs` / :func:`model_specs` / :func:`zero_batch` /
  :func:`enumerate_signatures` — the finite set of signatures a bucketed
  runtime requests for one model.
- :func:`pow2_bucket` / :func:`prefill_buckets` / :func:`prefill_chunks` —
  the decode tier's prompt ladders (``decode.py``): on the card each rung
  is one captured CUDA graph, as each is one jit signature in the
  reference;
- :func:`spec_ladder` — the speculation ladder, one captured verify step a
  rung (reference ``shapes.py:289``).
"""

from __future__ import annotations

import collections
import logging
from collections.abc import Mapping, Sequence
from typing import Any

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


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`signature`'s order (dict keys
    sorted)."""
    return [leaf for _, leaf in _flatten(tree)]


def signature(batch: Any) -> tuple:
    """Hashable fingerprint of a batch: ``(path, shape, dtype)`` per leaf,
    dict keys sorted.  Plain data, so it is the same in every process.
    Leaves need only ``shape``/``dtype`` (arrays, tensors,
    :class:`TensorSpec`); anything else signs by its Python type."""
    return signature_and_leaves(batch)[0]


def signature_and_leaves(batch: Any) -> tuple[tuple, list]:
    """:func:`signature` and :func:`leaves` of ``batch`` from one walk."""
    sig, out = [], []
    for path, leaf in _flatten(batch):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            sig.append((path, tuple(int(d) for d in leaf.shape),
                        _dtype_name(leaf.dtype)))
        else:
            sig.append((path, (), type(leaf).__name__))
        out.append(leaf)
    return tuple(sig), out


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


def batch_rows(batch: Mapping[str, Any]) -> int:
    """The batch's paddable row count (reference ``shapes.py:317``): the
    leading dimension every ``ndim >= 1`` input shares; 0 when there is no
    leading axis or the leading dims disagree (a side input of shape
    ``(k,)`` beside ``(n, d)`` features is no batch axis)."""
    dims = {int(np.shape(v)[0]) for v in batch.values()
            if np.ndim(v) >= 1}
    if len(dims) != 1:
        return 0
    n = dims.pop()
    return n if n > 0 else 0


def input_specs(example: Mapping[str, Any] | None = None,
                signature: Mapping[str, Any] | None = None
                ) -> dict[str, tuple[tuple, Any]]:
    """Per-input row templates ``{input_name: (row_shape, dtype)}``: from
    ``example`` (a dict of input name → ONE example row, no batch axis),
    the rows' own shapes and dtypes; from a self-describing export's
    ``signature`` (``saved_model.read_signature``), each input's shape
    less the leading batch dim.  Exactly one source must be given."""
    if (example is None) == (signature is None):
        raise ValueError("input_specs needs exactly one of example= / "
                         "signature=")
    specs: dict[str, tuple[tuple, Any]] = {}
    if example is not None:
        for name, row in example.items():
            a = np.asarray(row)
            specs[str(name)] = (tuple(a.shape), a.dtype)
        return specs
    for entry in signature.get("inputs", []):
        shape = entry.get("shape") or []
        if any(d is None for d in shape[1:]):
            raise ValueError(
                f"input {entry.get('name')!r} has a polymorphic non-batch "
                f"dim {shape}: warmup needs concrete row shapes; pass "
                "example= instead")
        specs[str(entry["name"])] = (tuple(int(d) for d in shape[1:]),
                                     np.dtype(entry["dtype"]))
    if not specs:
        raise ValueError("signature carries no inputs")
    return specs


def model_specs(model_name: str, *, tiny: bool = False, config: Any = None
                ) -> dict[str, tuple[tuple, Any]]:
    """Input specs from a zoo entry's own example batch, training targets
    (:data:`LABEL_KEYS`) stripped, at ``config``, else ``Config.tiny()``
    with ``tiny``, else ``Config()``."""
    from tensorflowonspark_torch import models as model_zoo

    lib = model_zoo.get_model(model_name)
    if config is None:
        config = lib.Config.tiny() if tiny else lib.Config()
    example = lib.example_batch(config, batch_size=1)
    rows = {k: np.asarray(v)[0] for k, v in example.items()
            if k not in LABEL_KEYS}
    if not rows:
        raise ValueError(
            f"model {model_name!r}: example batch carries only label "
            f"columns {sorted(example)} — no serving inputs to derive")
    return input_specs(example=rows)


def policy_specs(model_name: str, export_specs: Any
                 ) -> dict[str, tuple[tuple, Any]]:
    """:func:`model_specs` at the config the loaded export's shapes imply
    (the zoo module's ``config_from_state`` over ``export_specs``, the
    export's tree with a :class:`TensorSpec` a leaf)."""
    from tensorflowonspark_torch import models as model_zoo

    lib = model_zoo.get_model(model_name)
    return model_specs(model_name,
                       config=lib.config_from_state(export_specs))


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


def pow2_bucket(n: int) -> int:
    """Next power-of-two ≥ n — the implicit bucket ladder used by callers
    with no configured geometry (``infer_embed``'s JVM batches)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def prefill_buckets(max_prompt_len: int, *, min_bucket: int = 8,
                    cap: int | None = None) -> tuple[int, ...]:
    """The generative-decode PREFILL ladder: power-of-two prompt-length
    buckets from ``min_bucket`` up to the one covering
    ``max_prompt_len``, optionally capped at ``cap`` (the model's
    positional capacity ``max_len`` — a bucket longer than the position
    table cannot be embedded).

    This is the decode tier's compile-triggering shape policy: every
    prompt pads to a ladder bucket, so prefill compiles once per BUCKET
    and the decode step (whose shapes are fixed by the slot/page
    geometry, not the sequence length) compiles exactly once — sequence
    growth never mints a new jit signature.  Pure arithmetic (no
    env, no device state), so every process derives the identical
    ladder from the same config — the fleet-compile-cache discipline.

    When the covering power of two exceeds ``cap``, the terminal bucket
    is ``max_prompt_len`` itself (one exact-fit compile instead of an
    un-embeddable shape).
    """
    max_prompt_len = int(max_prompt_len)
    if max_prompt_len < 1:
        raise ValueError(f"max_prompt_len must be >= 1, got {max_prompt_len}")
    terminal = pow2_bucket(max_prompt_len)
    if cap is not None and terminal > int(cap):
        if max_prompt_len > int(cap):
            raise ValueError(
                f"max_prompt_len {max_prompt_len} exceeds cap {cap}")
        terminal = max_prompt_len
    out: list[int] = []
    b = pow2_bucket(max(1, int(min_bucket)))
    while b < terminal and b < max_prompt_len:
        out.append(b)
        b <<= 1
    out.append(terminal)
    return tuple(out)


def prefill_chunks(max_prompt_len: int, page_size: int, *,
                   max_chunk: int | None = None) -> tuple[int, ...]:
    """The CHUNKED-prefill ladder: page-aligned chunk lengths the decode
    tier compiles its multi-sequence prefill step at.

    Chunked prefill splits every prompt into page-aligned chunks and
    packs chunks from several requests into one jitted call of fixed
    ``(chunks, chunk_len)`` geometry — ``chunk_len`` must come from this
    ladder, so prefill compiles once per RUNG and a long prompt advances
    at most ``max_chunk`` tokens per engine step (the TTFT bound: decode
    steps interleave between chunks, so a long prompt cannot monopolize
    the loop).  Page alignment is load-bearing twice over: a chunk
    boundary always lands on a page boundary (so a chunk never
    half-fills a page another chunk must append to mid-call), and the
    prefix-sharing registry maps whole pages, so shared prefixes compose
    with chunk boundaries without remapping.

    Rungs are power-of-two multiples of ``page_size`` (``ps, 2ps, 4ps,
    ...``) up to the terminal rung: the page-aligned cover of
    ``max_prompt_len``, capped at ``max_chunk`` rounded DOWN to a page
    multiple (never below one page).  Pure arithmetic — no env, no
    device state — so every process derives the identical ladder from
    the same config, same as :func:`prefill_buckets`.
    """
    max_prompt_len = int(max_prompt_len)
    page_size = int(page_size)
    if max_prompt_len < 1:
        raise ValueError(f"max_prompt_len must be >= 1, got {max_prompt_len}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    cover = -(-max_prompt_len // page_size) * page_size
    top = cover
    if max_chunk is not None:
        budget = max(page_size, (int(max_chunk) // page_size) * page_size)
        top = min(top, budget)
    out: list[int] = []
    rung = page_size
    while rung < top:
        out.append(rung)
        rung <<= 1
    out.append(top)
    return tuple(out)


def spec_ladder(spec_tokens: int) -> tuple[int, ...]:
    """The SPECULATION ladder: the draft lengths ``k`` the decode tier
    captures its verify step at, ascending, ending at the configured
    ``spec_tokens``.

    The verify step scores ``k+1`` positions per slot in one fixed-shape
    call, so each rung is one signature of ``(max_seqs, k+1)`` geometry.
    The adaptive controller moves BETWEEN rungs (halving on a cold
    drafter, restoring on a hot one) and every rung is captured at warmup,
    so the controller changes ``k`` mid-flight without meeting a new
    signature.  Rungs halve from the top: ``spec_tokens, spec_tokens //
    2, ..., 1``.  Pure arithmetic, as the reference's.
    """
    spec_tokens = int(spec_tokens)
    if spec_tokens < 1:
        raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
    out: list[int] = []
    rung = spec_tokens
    while rung > 1:
        out.append(rung)
        rung //= 2
    out.append(1)
    return tuple(reversed(out))
