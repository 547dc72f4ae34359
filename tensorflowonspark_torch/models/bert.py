"""BERT encoder + SQuAD span head: port of
``tensorflowonspark_tpu/models/bert.py`` (acceptance config #5).

The layered, data-parallel model of the reference, in PyTorch:

- bf16 activations; f32 parameters, cast to the compute dtype at use;
  f32 LayerNorm (ε 1e-6) on the bf16 residual sum, cast back; f32
  softmax, span logits and loss.
- ``qkv`` is one ``Linear(H, 3H)`` whose output unflattens to
  ``(3, heads, head_dim)``: the order of the reference's
  ``DenseGeneral((3, h, d))``.
- GELU is flax's ``nn.gelu``, the tanh approximation.
- Post-LN blocks named ``layers.i`` (the reference's ``layer_i``); the
  span head gives start and end logits, masked to -1e30 off the mask.
- ``Config(remat=True)`` recomputes each block in the backward
  (``torch.utils.checkpoint``), in training only.

Attention goes through the model's ``attention`` attribute, chosen by
device as the GroupNorm models choose their ``norm_act``:
:func:`attention_plain` on the CPU (the reference's arithmetic:
bf16 × bf16 scores accumulated in f32, an f32 softmax, ``p`` rounded to
bf16, PV accumulated in f32) and :func:`attention_sdpa` on a card
(``F.scaled_dot_product_attention``; the reference computes attention
in XLA, not in a kernel of its own, so none is owed here).  Both take
the key-padding mask as an additive bias of 0 and -1e30: on f32 scores
that is the reference's ``where(mask, s, -1e30)``, bit for bit, and a
row that is all padding gets the reference's finite uniform weights,
where a boolean SDPA mask gives NaN.  An export calls
``torch.ops.tfos.bert_attention`` (:func:`attention_op`), which picks
the device's version when the program runs.

The reference's mesh paths are not ported: ``moe_experts > 0`` and
``pp_stages > 1`` raise ``NotImplementedError`` (ROADMAP Queue 1 item 6),
and ``sp_impl`` is validated but unused (no ``sp`` axis).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import _common

LN_EPS = 1e-6  # flax nn.LayerNorm default
MASKED = -1e30  # the reference's masked score and span logit
_WAITS = "is not ported yet (ROADMAP Queue 1 item 6)"


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dtype: str = "bfloat16"
    remat: bool = False  # recompute each block in the backward
    # the reference's sequence-parallel attention ("ring" or "ulysses"):
    # validated, unused without an sp axis
    sp_impl: str = "ring"
    # Mixture-of-Experts and pipeline fields of the reference; > 0 (> 1
    # for pp_stages) raises
    moe_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_group_size: int = 1024
    pp_stages: int = 0
    pp_microbatches: int = 4

    @classmethod
    def tiny(cls) -> "Config":
        return cls(vocab_size=128, hidden=32, layers=2, heads=4, mlp_dim=64,
                   max_len=64, dtype="float32")

    @classmethod
    def large(cls) -> "Config":
        return cls(hidden=1024, layers=24, heads=16, mlp_dim=4096)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


#: sequence axis of each batch leaf (the reference shards it over ``sp``)
SEQUENCE_AXES = {"input_ids": 1, "token_type_ids": 1, "attention_mask": 1}


# ---------------------------------------------------------------------------
# Attention: q, k, v (B, S, heads, head_dim); bias (B, 1, 1, S) additive
# ---------------------------------------------------------------------------


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The reference's dense attention (``bert.py:111-124``): scores of the
    compute-dtype q and k in f32 (exact products of bf16 inputs), scaled,
    the bias added in f32, an f32 softmax, ``p`` rounded to q's dtype and
    PV accumulated in f32, then rounded.  Returns (B, S, heads,
    head_dim)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s + bias.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(),
                        v.float()).to(q.dtype)


def attention_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """:func:`attention_plain`'s function through
    ``F.scaled_dot_product_attention`` (the card's path), the bias in q's
    dtype.  Returns (B, S, heads, head_dim)."""
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=bias.to(q.dtype), scale=1.0 / math.sqrt(q.shape[-1]))
    return o.transpose(1, 2)


def attention(q, k, v, bias):
    """The plain version on the CPU, SDPA on a card; nothing falls back."""
    device = q.device.type
    if device == "cpu":
        return attention_plain(q, k, v, bias)
    if device == "cuda":
        return attention_sdpa(q, k, v, bias)
    raise RuntimeError(f"bert attention: tensors on {q.device} are not "
                       "supported (cpu takes the plain path, cuda SDPA)")


@torch.library.custom_op("tfos::bert_attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``torch.ops.tfos.bert_attention``: :func:`attention` as one operator
    of an exported program, so the program picks the device's version
    when it runs (a trace on the CPU would bake the plain ops into it).
    Inference only: training calls :func:`attention`."""
    return attention_plain(q, k, v, bias).contiguous()


@attention_op.register_kernel("cuda")
def _attention_op_cuda(q, k, v, bias):
    # contiguous, as the fake below says the output is
    return attention_sdpa(q, k, v, bias).contiguous()


@attention_op.register_fake
def _attention_op_fake(q, k, v, bias):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)``: the f32 kernel and bias cast to the
    compute dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: ε 1e-6 over the last dim,
    computed in f32 and cast to ``dtype``.  flax takes the variance as
    E[x²] − E[x]², torch's ``layer_norm`` as E[(x − E[x])²]: the two
    differ at f32 rounding."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, LN_EPS).to(dtype)


class Embeddings(nn.Module):
    """``tok[ids] + pos[:S] + type[type_ids]`` in f32, in that order, then
    ``ln_embed`` and a cast to the compute dtype."""

    def __init__(self, config: Config):
        super().__init__()
        self.tok_embed = nn.Parameter(torch.zeros(config.vocab_size,
                                                  config.hidden))
        self.pos_embed = nn.Parameter(torch.zeros(config.max_len,
                                                  config.hidden))
        self.type_embed = nn.Parameter(torch.zeros(config.type_vocab,
                                                   config.hidden))
        self.ln_embed = LayerNorm(config.hidden)
        self.dtype = getattr(torch, config.dtype)

    def forward(self, input_ids, token_type_ids):
        s = input_ids.shape[1]
        x = (F.embedding(input_ids, self.tok_embed) + self.pos_embed[:s]
             + F.embedding(token_type_ids, self.type_embed))
        return self.ln_embed(x, self.dtype)


class Attention(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        self.qkv = nn.Linear(config.hidden, 3 * config.hidden)
        self.out = nn.Linear(config.hidden, config.hidden)
        self.heads = config.heads

    def forward(self, x, bias, attention_fn):
        qkv = dense(x, self.qkv).unflatten(-1, (3, self.heads, -1))
        o = attention_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], bias)
        return dense(o.flatten(2), self.out)


class Block(nn.Module):
    """Post-LN: ``x = LN(x + attn(x))``, ``x = LN(x + MLP(x))``."""

    def __init__(self, config: Config):
        super().__init__()
        self.attention = Attention(config)
        self.ln_attn = LayerNorm(config.hidden)
        self.mlp_in = nn.Linear(config.hidden, config.mlp_dim)
        self.mlp_out = nn.Linear(config.mlp_dim, config.hidden)
        self.ln_mlp = LayerNorm(config.hidden)

    def forward(self, x, bias, attention_fn):
        x = self.ln_attn(x + self.attention(x, bias, attention_fn), x.dtype)
        y = dense(F.gelu(dense(x, self.mlp_in), approximate="tanh"),
                  self.mlp_out)
        return self.ln_mlp(x + y, x.dtype)


class Bert(nn.Module):
    """``forward(input_ids, token_type_ids, attention_mask)`` → ``(start,
    end)``: f32 span logits (B, S), -1e30 where the mask is 0."""

    def __init__(self, config: Config):
        super().__init__()
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(Block(config)
                                    for _ in range(config.layers))
        self.span = nn.Linear(config.hidden, 2)
        self.remat = config.remat
        #: the attention every block calls; a test may set it to
        #: :func:`attention_plain` to run the plain version on a card
        self.attention = attention

    def forward(self, input_ids, token_type_ids, attention_mask):
        from torch.utils.checkpoint import checkpoint

        x = self.embeddings(input_ids, token_type_ids)
        mask = attention_mask != 0
        bias = torch.where(mask, 0.0, MASKED).to(x.dtype)[:, None, None, :]
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.layers:
            if remat:
                # a block draws no random numbers (no dropout), so there is
                # no RNG state to keep, and saving the card's cannot run
                # while the compiled step captures a CUDA graph
                x = checkpoint(block, x, bias, self.attention,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, bias, self.attention)
        logits = torch.where(mask[:, :, None], dense(x, self.span).float(),
                             MASKED)
        return logits[..., 0], logits[..., 1]


def _check(config: Config) -> None:
    if config.sp_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"sp_impl must be 'ring' or 'ulysses', got {config.sp_impl!r}")
    if config.moe_experts > 0:
        raise NotImplementedError(f"Mixture-of-Experts (moe_experts="
                                  f"{config.moe_experts}) {_WAITS}")
    if config.pp_stages > 1:
        raise NotImplementedError(f"the pipeline trunk (pp_stages="
                                  f"{config.pp_stages}) {_WAITS}")


def build(config: Config) -> Bert:
    """The model with placeholder weights (on the current default device:
    ``meta`` for shapes alone)."""
    _check(config)
    return Bert(config)


def make_model(config: Config, seed: int = 0) -> Bert:
    """A BERT on the CPU with flax's init drawn by torch from ``seed``:
    normal(0.02) dense kernels and embedding tables, zero biases,
    LayerNorm scales 1."""
    model = build(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight") or name.endswith("_embed"):
                p.normal_(0.0, 0.02, generator=gen)
            elif name.endswith(".bias"):
                p.zero_()
    return model


def outputs(model: Bert, batch):
    """``(start, end)`` of ``batch``: the serving forward an export
    traces."""
    return model(batch["input_ids"], batch["token_type_ids"],
                 batch["attention_mask"])


serving_forward = outputs


def make_forward_fn(model: Bert, config: Config):
    def forward(model, batch):
        with torch.inference_mode():
            return outputs(model, batch)

    return forward


def make_loss_fn(model: Bert, config: Config):
    """``(CE(start) + CE(end)) / 2`` averaged over the batch
    (``bert.py:497-503``), in f32."""
    del model

    def loss_fn(model, batch):
        start, end = outputs(model, batch)
        l_s = F.cross_entropy(start, batch["start_positions"].long(),
                              reduction="none")
        l_e = F.cross_entropy(end, batch["end_positions"].long(),
                              reduction="none")
        return (l_s + l_e).mean() / 2.0

    return loss_fn


def make_serving_model(config: Config) -> Bert:
    """The model an export binds its weights to: on the ``meta`` device,
    attention through ``torch.ops.tfos.bert_attention``."""
    with torch.device("meta"):
        model = build(config)
    model.attention = attention_op
    return model.eval()


def example_batch(config: Config, batch_size: int = 8, seed: int = 0,
                  seq_len: int | None = None):
    """The reference's draw (``bert.py:518-530``): the same arrays for the
    same seed."""
    rng = np.random.RandomState(seed)
    s = seq_len or min(config.max_len, 384)
    return {
        "input_ids": rng.randint(0, config.vocab_size, (batch_size, s)).astype(
            np.int32
        ),
        "token_type_ids": np.zeros((batch_size, s), np.int32),
        "attention_mask": np.ones((batch_size, s), np.int32),
        "start_positions": rng.randint(0, s, (batch_size,)).astype(np.int32),
        "end_positions": rng.randint(0, s, (batch_size,)).astype(np.int32),
    }


state_of = _common.state_of
load_state = _common.load_state


def config_from_state(state: dict) -> Config:
    """``Config()``, ``Config.tiny()`` or ``Config.large()``, whichever has
    the export's parameter shapes."""
    return _common.config_from_state(
        state, build, (Config(), Config.tiny(), Config.large()))


_EMBEDDINGS = ("tok_embed", "pos_embed", "type_embed")
_DENSE = {("attention", "qkv"), ("attention", "out"), ("mlp_in",),
          ("mlp_out",)}
_NORMS = ("ln_attn", "ln_mlp")


def _torch_name(path: tuple) -> str:
    """The torch parameter of a flax leaf path; ``KeyError`` for a path
    the model does not have."""
    if path in {("embeddings", t) for t in _EMBEDDINGS}:
        return ".".join(path)
    if (len(path) == 3 and path[:2] == ("embeddings", "ln_embed")
            and path[2] in ("scale", "bias")):
        return ".".join(path)
    if len(path) == 2 and path[0] == "span" and path[1] in ("kernel",
                                                              "bias"):
        return "span." + ("weight" if path[1] == "kernel" else "bias")
    layer, module, leaf = path[0], path[1:-1], path[-1]
    index = layer.removeprefix("layer_")
    if layer.startswith("layer_") and index.isdigit():
        if module in _DENSE and leaf in ("kernel", "bias"):
            return ".".join((f"layers.{int(index)}", *module,
                             "weight" if leaf == "kernel" else "bias"))
        if len(module) == 1 and module[0] in _NORMS and leaf in ("scale",
                                                                 "bias"):
            return f"layers.{int(index)}.{module[0]}.{leaf}"
    raise KeyError(f"unmapped flax leaf {'/'.join(path)}")


def params_from_flax(params) -> dict:
    """The reference's params as ``{"params": {torch name: f32 array}}``:
    ``qkv``'s ``(H, 3, heads, head_dim)`` kernel → ``reshape(H, 3H).T``
    and its ``(3, heads, head_dim)`` bias flattened (the unflatten order
    of :class:`Attention`); dense kernels ``(in, out)`` → ``(out, in)``;
    embedding tables, biases and LayerNorm ``scale``/``bias`` copied.  Any
    other leaf raises ``KeyError``."""
    out = {}
    for path, leaf in _common.flax_leaves(params):
        name = _torch_name(path)
        a = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            a = a.reshape(a.shape[0], -1).T
        elif name.endswith("qkv.bias"):
            a = a.reshape(-1)
        out[name] = np.ascontiguousarray(a)
    return {"params": out}


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference's ``optax.adamw`` state as the port's AdamW state by
    parameter name."""
    return _common.opt_state_from_optax(opt_state, params, params_from_flax)
