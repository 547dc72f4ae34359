"""Criteo wide-and-deep CTR model: port of
``tensorflowonspark_tpu/models/widedeep.py``.

Criteo layout: 13 integer (dense) features and 26 categorical features
pre-hashed into ``hash_buckets`` buckets each.  The reference's choices
carry over:

- the 26 lookups are one gather over one fused table (per-feature offsets
  added to the ids, :func:`fold_ids`), for the deep (``embed_dim`` wide)
  and the wide (scalar) tables alike;
- the tables and their AdaGrad accumulators live outside the optimizer:
  buffers of the module, grouped as the reference's ``embedding``
  (``deep``, ``wide``) and ``embedding_opt`` (``deep_acc``, ``wide_acc``)
  collections (:meth:`WideDeep.collections`), trained by AdaGrad at
  ``Config.table_lr`` while the MLP trains through the ``Trainer``'s
  optimizer (AdamW);
- the logit is ``Σ wide rows + MLP([deep rows flattened, log1p(max(dense,
  0))])``, hidden layers ReLU in ``Config.dtype``, the head in f32.

:func:`make_sharded_train_step` is the step the ``Trainer`` picks up: it
gathers the rows (``index_select``), takes the gradient with respect to
the gathered rows and the MLP, applies the optimizer to the MLP and
``embedding.sparse_adagrad_update_tables`` to both tables — on the card
the hand-written kernels (``csrc/sparse_adagrad.cu``: one grouping of the
ids, one update launch for both tables), ``combine=True`` for
``table_update="dense"`` (the reference's gather-VJP + full-table pass,
restricted to the touched rows, which is the same function) and
``combine=False`` for ``"sparse"``.  Under a ``torch.distributed`` group
the step keeps the reference's global-batch semantics (replicated tables,
one global scatter): each rank's row gradients are scaled by 1/world and
all-gathered with the ids, every rank applies the same table update, and
the MLP gradients are averaged.  Vocab-sharded tables
(``make_collection_shardings``) are not ported.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import _common

NUM_DENSE = 13
NUM_CAT = 26


@dataclasses.dataclass(frozen=True)
class Config:
    hash_buckets: int = 100_000  # per categorical feature
    embed_dim: int = 32
    hidden: tuple = (1024, 512, 256)
    dtype: str = "float32"
    table_dtype: str = "float32"
    table_lr: float = 0.01  # AdaGrad rate for wide+embedding tables
    # "dense": the occurrences' gradients summed before they are squared
    # into the accumulator (the gather's VJP pre-reduces), one update a
    # row; "sparse": every occurrence's squared gradient accumulated, then
    # each occurrence's update.  The two differ on batches that repeat an
    # id (see the reference's comment); both run the table kernel.
    table_update: str = "dense"

    @classmethod
    def tiny(cls) -> "Config":
        return cls(hash_buckets=50, embed_dim=4, hidden=(16,))

    @property
    def total_buckets(self) -> int:
        return self.hash_buckets * NUM_CAT


def fold_ids(cat: torch.Tensor, config: Config) -> torch.Tensor:
    """(B, 26) per-feature ids -> (B, 26) global ids into the fused table."""
    offsets = torch.arange(NUM_CAT, dtype=cat.dtype, device=cat.device)
    return cat + offsets * config.hash_buckets


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: shape ``ids.shape + table.shape[1:]``."""
    return table.index_select(0, ids.reshape(-1)).reshape(
        *ids.shape, *table.shape[1:])


class WideDeep(nn.Module):
    """``forward(dense, cat, emb_rows=None, wide_rows=None)`` → (B,) f32
    logits.  Without rows it gathers them (the eval path); the train step
    passes pre-gathered ``emb_rows``/``wide_rows``, both or neither."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        self.dtype = getattr(torch, config.dtype)
        table_dtype = getattr(torch, config.table_dtype)
        vocab, dim = config.total_buckets, config.embed_dim
        self.register_buffer("deep", torch.zeros(vocab, dim,
                                                 dtype=table_dtype))
        self.register_buffer("wide", torch.zeros(vocab, dtype=table_dtype))
        self.register_buffer("deep_acc", torch.zeros(vocab, dim))
        self.register_buffer("wide_acc", torch.zeros(vocab))
        widths = (NUM_CAT * dim + NUM_DENSE, *config.hidden)
        self.hidden = nn.ModuleList(nn.Linear(i, o)
                                    for i, o in zip(widths, widths[1:]))
        self.head = nn.Linear(widths[-1], 1)

    def collections(self) -> dict:
        """The tables and accumulators, as the reference's collections."""
        return {"embedding": {"deep": self.deep, "wide": self.wide},
                "embedding_opt": {"deep_acc": self.deep_acc,
                                  "wide_acc": self.wide_acc}}

    def forward(self, dense, cat, emb_rows=None, wide_rows=None):
        if (emb_rows is None) != (wide_rows is None):
            raise ValueError(
                "emb_rows and wide_rows must be passed together (the "
                "train step pre-gathers BOTH) or both omitted (the model "
                "gathers); got emb_rows="
                f"{'set' if emb_rows is not None else 'None'}, "
                f"wide_rows={'set' if wide_rows is not None else 'None'}")
        if emb_rows is None:
            ids = fold_ids(cat, self.config)
            emb_rows = gather_rows(self.deep, ids)  # (B, 26, E)
            wide_rows = gather_rows(self.wide, ids)  # (B, 26)
        wide_logit = wide_rows.sum(dim=1)
        x = torch.cat(
            [emb_rows.reshape(emb_rows.shape[0], -1).to(self.dtype),
             torch.log1p(torch.clamp(dense.float(), min=0.0)).to(self.dtype)],
            dim=-1)
        for layer in self.hidden:
            x = torch.relu(F.linear(x, layer.weight.to(self.dtype),
                                    layer.bias.to(self.dtype)))
        deep_logit = F.linear(x.float(), self.head.weight, self.head.bias)
        return wide_logit + deep_logit[:, 0]


def make_model(config: Config, seed: int = 0) -> WideDeep:
    """A wide&deep model on the CPU drawn from ``seed``: the deep table
    normal(0.01), the wide table and the accumulators zero, He-normal
    hidden layers and a LeCun-normal head (both truncated at ±2σ, flax's
    draw), zero biases.  The draw is torch's, not JAX's: parity tests load
    converted weights (:func:`params_from_flax`) instead."""
    model = WideDeep(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.deep.normal_(0.0, 0.01, generator=gen)
        for layer in model.hidden:
            _common.variance_scaling_(layer.weight, 2.0, gen)
            layer.bias.zero_()
        _common.variance_scaling_(model.head.weight, 1.0, gen)
        model.head.bias.zero_()
    return model


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, f32, averaged."""
    x = logit.float()
    z = label.to(x.dtype)
    return torch.mean(-z * F.logsigmoid(x) - (1.0 - z) * F.logsigmoid(-x))


def make_loss_fn(model: WideDeep, config: Config):
    """``loss(model, batch) -> scalar`` with the model's own gather.  A step
    built on it (``parallel.train.make_train_step``) trains the MLP alone:
    the tables are buffers, and their update is
    :func:`make_sharded_train_step`'s, which the ``Trainer`` prefers."""
    del model, config

    def loss_fn(model, batch):
        return bce(model(batch["dense"], batch["cat"]), batch["label"])

    return loss_fn


def serving_forward(model: WideDeep, batch) -> torch.Tensor:
    """(B,) click probabilities: the serving forward an export traces."""
    return torch.sigmoid(model(batch["dense"], batch["cat"]))


def make_serving_model(config: Config) -> WideDeep:
    """The model an export binds its weights to, built on the ``meta``
    device: no 2.6 M-row tables are allocated or drawn."""
    with torch.device("meta"):
        return WideDeep(config).eval()


def make_forward_fn(model: WideDeep, config: Config):
    """``forward(model, batch) -> (B,) click probabilities``."""
    del model, config

    def forward(model, batch):
        with torch.inference_mode():
            return serving_forward(model, batch)

    return forward


def make_sharded_train_step(model: WideDeep, config: Config, optimizer):
    """``step(state, batch) -> (state, loss)``: one step of the MLP
    (``optimizer``) and of both tables (on the card, the id grouping and
    one AdaGrad launch for the two); see the module docstring.  ``loss``
    is the detached scalar, averaged over the ranks of a group.  This is
    the eager step; a ``Trainer`` compiles it with
    ``parallel.train.compile_step``, as the reference's goes through its
    ``compile_step``: on the card the gather, the MLP, the backward, the
    grouping, the segment walk and AdamW replay as one CUDA graph."""
    from tensorflowonspark_torch import embedding
    from tensorflowonspark_torch.parallel import train as train_lib

    if config.table_update not in ("dense", "sparse"):
        raise ValueError(f"table_update must be dense|sparse, "
                         f"got {config.table_update!r}")
    combine = config.table_update == "dense"
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state, batch):
        optimizer.zero_grad(set_to_none=True)
        ids = fold_ids(batch["cat"], config)
        deep_rows = gather_rows(model.deep, ids).requires_grad_()
        wide_rows = gather_rows(model.wide, ids).requires_grad_()
        loss = bce(model(batch["dense"], batch["cat"], emb_rows=deep_rows,
                         wide_rows=wide_rows), batch["label"])
        loss.backward()
        grads = train_lib.gradients_of(params)
        g_deep, g_wide = deep_rows.grad, wide_rows.grad
        world = train_lib.world_size()
        if world > 1:
            loss = train_lib.average_across_ranks(grads, loss, world)
            ids, g_deep, g_wide = train_lib.all_gather_cat(
                [ids, g_deep / world, g_wide / world])
        else:
            loss = loss.detach()
        embedding.sparse_adagrad_update_tables(
            ((model.deep, model.deep_acc), (model.wide, model.wide_acc)), ids,
            (g_deep, g_wide), config.table_lr, combine=combine)
        optimizer.step()
        state.step += 1
        return state, loss

    return step


def example_batch(config: Config, batch_size: int = 8, seed: int = 0):
    """The reference's synthetic batch (the same ``RandomState`` draws)."""
    rng = np.random.RandomState(seed)
    return {
        "dense": rng.rand(batch_size, NUM_DENSE).astype(np.float32),
        "cat": rng.randint(
            0, config.hash_buckets, size=(batch_size, NUM_CAT)
        ).astype(np.int32),
        "label": rng.randint(0, 2, size=(batch_size,)).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# Weights: port state <-> module, flax tree -> port state
# ---------------------------------------------------------------------------

#: the collections and their leaves, as the reference names them
COLLECTIONS = {"embedding": ("deep", "wide"),
               "embedding_opt": ("deep_acc", "wide_acc")}


def state_of(model: WideDeep) -> dict:
    """``{"params": {name: array}, "collections": {"embedding": ...,
    "embedding_opt": ...}}``: the reference's export layout, with torch
    parameter names."""
    return {
        "params": {k: v.detach().cpu().float().numpy()
                   for k, v in model.named_parameters()},
        "collections": {
            group: {k: t.detach().cpu().numpy() for k, t in leaves.items()}
            for group, leaves in model.collections().items()},
    }


def load_state(model: WideDeep, state: dict) -> WideDeep:
    """Load an export state (see :func:`state_of`) into ``model``: every
    parameter and both tables must be present; the accumulators
    (``embedding_opt``) may be absent, as in a serving export, and then
    keep their values.  Anything else raises ``KeyError``."""
    tensors = dict(state["params"])
    collections = state.get("collections") or {}
    for group, leaves in collections.items():
        if group not in COLLECTIONS or set(leaves) != set(COLLECTIONS[group]):
            raise KeyError(f"unexpected collection {group!r} with leaves "
                           f"{sorted(leaves)}; want {COLLECTIONS}")
        tensors.update(leaves)
    if "embedding_opt" not in collections:
        tensors.update({k: t for k, t in model.state_dict().items()
                        if k in COLLECTIONS["embedding_opt"]})
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in tensors.items()}, strict=True)
    return model


def config_from_state(state: dict) -> Config:
    """The ``Config`` an export state was written from, by its shapes
    (arrays, or anything with a ``.shape``)."""
    vocab, dim = state["collections"]["embedding"]["deep"].shape
    if vocab % NUM_CAT:
        raise ValueError(f"deep table of {vocab} rows is not {NUM_CAT} "
                         "features' buckets")
    params = state["params"]
    hidden = []
    while f"hidden.{len(hidden)}.weight" in params:
        hidden.append(params[f"hidden.{len(hidden)}.weight"].shape[0])
    return Config(hash_buckets=vocab // NUM_CAT, embed_dim=dim,
                  hidden=tuple(hidden))


_DENSE = re.compile(r"^Dense_(\d+)$")


def params_from_flax(params, collections=None) -> dict:
    """Convert the reference's flax ``params`` (and its ``embedding`` /
    ``embedding_opt`` collections) into the port's export state
    (:func:`state_of`).  ``Dense_i`` becomes ``hidden.i``, the last one
    ``head``; kernels go ``(in, out)`` → ``(out, in)``.  A leaf that maps to
    nothing raises ``KeyError``."""
    leaves = list(_common.flax_leaves(params))
    layers = sorted({int(m.group(1)) for path, _ in leaves
                     if (m := _DENSE.match(path[0]))})
    if layers != list(range(len(layers))):
        raise KeyError(f"flax Dense layers {layers} are not 0..n-1")
    out = {}
    for path, leaf in leaves:
        m = _DENSE.match(path[0])
        a = np.asarray(leaf, dtype=np.float32)
        if m is None or len(path) != 2:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        i = int(m.group(1))
        name = "head" if i == layers[-1] else f"hidden.{i}"
        if path[1] == "kernel" and a.ndim == 2:
            out[f"{name}.weight"] = np.ascontiguousarray(a.T)
        elif path[1] == "bias" and a.ndim == 1:
            out[f"{name}.bias"] = a
        else:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)} {a.shape}")
    state = {"params": out}
    if collections is not None:
        cols: dict = {}
        for path, leaf in _common.flax_leaves(collections):
            if (len(path) != 2 or path[0] not in COLLECTIONS
                    or path[1] not in COLLECTIONS[path[0]]):
                raise KeyError(f"unmapped flax collection leaf "
                               f"{'/'.join(path)}")
            cols.setdefault(path[0], {})[path[1]] = np.asarray(leaf)
        state["collections"] = cols
    return state


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference ``Trainer``'s ``optax.adamw`` state of the MLP (the
    tables train by AdaGrad, whose accumulators ride in the
    ``embedding_opt`` collection) as the port's AdamW state by parameter
    name, the moments converted as :func:`params_from_flax` converts
    ``params``."""
    names = set(params_from_flax(params)["params"])
    out = _common.adam_state_from_optax(
        opt_state, lambda tree: params_from_flax(tree)["params"])
    if set(out) != names:
        raise KeyError("the optax moments and the params name different "
                       "leaves")
    return out
