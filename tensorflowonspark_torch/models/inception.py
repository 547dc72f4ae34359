"""Inception-v3: port of ``tensorflowonspark_tpu/models/inception.py``.

The second architecture of acceptance config #3.  The reference's choices
carry over: NHWC float32 input, ``channels_last`` bf16 compute with f32
params, GroupNorm with the largest group count ≤ ``groups`` that divides
each width (``gn_groups``), and the tower structure stem → 3×InceptionA →
ReductionA → 4×InceptionB → ReductionB → 2×InceptionC → global mean → f32
dense head, towers concatenated on the channel dim in the reference's
order.  Two padding variants (``Config.canonical``):

- ``False`` (default): every conv ``SAME``, no auxiliary head;
- ``True``, the published net: ``VALID`` stem (299 → 149 → 147 → 147 → 73
  → 71 → 35) and ``VALID`` stride-2 reductions (35 → 17 → 8), plus the
  auxiliary classifier over the 17×17 tower, whose cross-entropy enters
  the loss weighted by ``aux_weight`` (TF-slim's 0.4).  Its params always
  exist; its forward runs only in training (``forward(image,
  train=True)``), where the reference lets XLA drop it at inference.

Every conv → GroupNorm → ReLU is a :class:`ConvNorm`, whose norm goes
through :attr:`InceptionV3.norm_act`, the fused kernel: 94 calls a forward
(96 in a canonical training step, the aux head's 2 included) and as many
backward launches a training step.  With ``norm="batch"`` each ConvNorm's
norm is the reference's ``nn.BatchNorm(momentum=0.9)`` in plain PyTorch
(``_common.BatchNorm``): batch statistics and their running update under
``forward(image, train=True)``, the running statistics otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import _common


@dataclasses.dataclass(frozen=True)
class Config:
    num_classes: int = 1000
    image_size: int = 299
    width_mult: float = 1.0
    groups: int = 32
    dtype: str = "bfloat16"
    norm: str = "group"  # "group" | "batch" (running stats in collections)
    #: True = published Inception-v3: VALID stem/reductions + aux head
    canonical: bool = False
    aux_weight: float = 0.4  # TF-slim's aux-logits loss weight

    @classmethod
    def tiny(cls) -> "Config":
        return cls(num_classes=10, image_size=32, width_mult=0.125,
                   groups=2, dtype="float32")

    @classmethod
    def tiny_canonical(cls) -> "Config":
        # the smallest tidy input keeping every VALID stage >= 1 px (the
        # aux head's 5x5 conv falls back to SAME below 5 px)
        return cls(num_classes=10, image_size=139, width_mult=0.125,
                   groups=2, dtype="float32", canonical=True)


class _Widths:
    """The reference's ``ch`` (a width under ``width_mult``, at least 8)
    and ``gn_groups`` (the largest divisor of a width not above
    ``groups``)."""

    def __init__(self, config: Config):
        self.mult, self.max_groups = config.width_mult, config.groups
        self.red_pad = "VALID" if config.canonical else "SAME"
        self.batch = config.norm == "batch"

    def ch(self, c: int) -> int:
        return max(8, int(round(c * self.mult)))

    def groups(self, c: int) -> int:
        g = min(self.max_groups, c)
        while c % g:
            g -= 1
        return g


class ConvNorm(nn.Module):
    """conv (no bias) → GroupNorm or BatchNorm → ReLU, the inception
    building block."""

    def __init__(self, w: _Widths, cin: int, cout: int, kernel,
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.conv = _common.Conv(cin, cout, kernel, stride, padding)
        self.norm = (_common.BatchNorm(cout) if w.batch
                     else _common.GroupNorm(cout, w.groups(cout)))

    def forward(self, x, norm_act, padding: str | None = None,
                train: bool = False):
        return self.norm(self.conv(x, padding), norm_act, train=train)


class _Block(nn.Module):
    """A block's ``ConvNorm``s in ``cn``, in the reference's call order (its
    ``ConvNorm_k``); :meth:`add` appends one and returns its width."""

    def __init__(self, w: _Widths):
        super().__init__()
        self.cn = nn.ModuleList()
        self._w = w

    def add(self, cin: int, cout: int, kernel, stride: int = 1,
            padding: str = "SAME") -> int:
        self.cn.append(ConvNorm(self._w, cin, cout, kernel, stride, padding))
        return cout

    def towers(self, act, train: bool):
        """``c(k, x)``: ConvNorm ``k`` of ``cn`` over ``x`` with this
        forward's ``norm_act`` and ``train``."""
        return lambda k, x, padding=None: self.cn[k](x, act, padding, train)


def _avg_pool3(x):
    return _common.avg_pool(x, 3, 1, "SAME")


class InceptionA(_Block):
    def __init__(self, w: _Widths, cin: int, pool_features: int):
        super().__init__(w)
        b1 = self.add(cin, w.ch(64), 1)
        self.add(cin, w.ch(48), 1)
        b5 = self.add(w.ch(48), w.ch(64), 5)
        self.add(cin, w.ch(64), 1)
        self.add(w.ch(64), w.ch(96), 3)
        b3 = self.add(w.ch(96), w.ch(96), 3)
        bp = self.add(cin, w.ch(pool_features), 1)
        self.out = b1 + b5 + b3 + bp

    def forward(self, x, act, train=False):
        c = self.towers(act, train)
        b1 = c(0, x)
        b5 = c(2, c(1, x))
        b3 = c(5, c(4, c(3, x)))
        bp = c(6, _avg_pool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(_Block):
    def __init__(self, w: _Widths, cin: int):
        super().__init__(w)
        b3 = self.add(cin, w.ch(384), 3, 2, w.red_pad)
        self.add(cin, w.ch(64), 1)
        self.add(w.ch(64), w.ch(96), 3)
        bd = self.add(w.ch(96), w.ch(96), 3, 2, w.red_pad)
        self.pad, self.out = w.red_pad, b3 + bd + cin

    def forward(self, x, act, train=False):
        c = self.towers(act, train)
        b3 = c(0, x)
        bd = c(3, c(2, c(1, x)))
        bp = _common.max_pool(x, 3, 2, self.pad)
        return torch.cat([b3, bd, bp], dim=1)


class InceptionB(_Block):
    def __init__(self, w: _Widths, cin: int, c7: int):
        super().__init__(w)
        c7 = w.ch(c7)
        b1 = self.add(cin, w.ch(192), 1)
        self.add(cin, c7, 1)
        self.add(c7, c7, (1, 7))
        b7 = self.add(c7, w.ch(192), (7, 1))
        self.add(cin, c7, 1)
        self.add(c7, c7, (7, 1))
        self.add(c7, c7, (1, 7))
        self.add(c7, c7, (7, 1))
        bd = self.add(c7, w.ch(192), (1, 7))
        bp = self.add(cin, w.ch(192), 1)
        self.out = b1 + b7 + bd + bp

    def forward(self, x, act, train=False):
        c = self.towers(act, train)
        b1 = c(0, x)
        b7 = c(3, c(2, c(1, x)))
        bd = x
        for k in range(4, 9):
            bd = c(k, bd)
        bp = c(9, _avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class ReductionB(_Block):
    def __init__(self, w: _Widths, cin: int):
        super().__init__(w)
        self.add(cin, w.ch(192), 1)
        b3 = self.add(w.ch(192), w.ch(320), 3, 2, w.red_pad)
        self.add(cin, w.ch(192), 1)
        self.add(w.ch(192), w.ch(192), (1, 7))
        self.add(w.ch(192), w.ch(192), (7, 1))
        b7 = self.add(w.ch(192), w.ch(192), 3, 2, w.red_pad)
        self.pad, self.out = w.red_pad, b3 + b7 + cin

    def forward(self, x, act, train=False):
        c = self.towers(act, train)
        b3 = c(1, c(0, x))
        b7 = x
        for k in range(2, 6):
            b7 = c(k, b7)
        bp = _common.max_pool(x, 3, 2, self.pad)
        return torch.cat([b3, b7, bp], dim=1)


class InceptionC(_Block):
    def __init__(self, w: _Widths, cin: int):
        super().__init__(w)
        b1 = self.add(cin, w.ch(320), 1)
        self.add(cin, w.ch(384), 1)
        b3 = self.add(w.ch(384), w.ch(384), (1, 3))
        b3 += self.add(w.ch(384), w.ch(384), (3, 1))
        self.add(cin, w.ch(448), 1)
        self.add(w.ch(448), w.ch(384), 3)
        bd = self.add(w.ch(384), w.ch(384), (1, 3))
        bd += self.add(w.ch(384), w.ch(384), (3, 1))
        bp = self.add(cin, w.ch(192), 1)
        self.out = b1 + b3 + bd + bp

    def forward(self, x, act, train=False):
        c = self.towers(act, train)
        b1 = c(0, x)
        b3 = c(1, x)
        b3 = torch.cat([c(2, b3), c(3, b3)], dim=1)
        bd = c(5, c(4, x))
        bd = torch.cat([c(6, bd), c(7, bd)], dim=1)
        bp = c(8, _avg_pool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class AuxHead(_Block):
    """The canonical auxiliary classifier over the 17×17 tower output:
    5×5/3 average pool, 1×1 and 5×5 ``ConvNorm``s, global mean, f32 dense.
    Below 5 px the pool and the 5×5 conv pad ``SAME``, as the
    reference's."""

    def __init__(self, w: _Widths, cin: int, num_classes: int):
        super().__init__(w)
        self.add(cin, w.ch(128), 1)
        width = self.add(w.ch(128), w.ch(768), 5)
        self.head = nn.Linear(width, num_classes)

    def forward(self, x, act, train=False):
        c = self.towers(act, train)
        a = _common.avg_pool(x, 5, 3, "VALID" if x.shape[2] >= 5 else "SAME")
        a = c(0, a)
        a = c(1, a, "VALID" if a.shape[2] >= 5 else "SAME")
        a = _common.global_mean(a)
        return F.linear(a.float(), self.head.weight, self.head.bias)


class InceptionV3(nn.Module):
    """``forward(image, train=False)``: NHWC float32 images → float32
    logits, and with ``train`` on a canonical net ``(logits, aux_logits)``."""

    def __init__(self, config: Config):
        super().__init__()
        if config.norm not in ("group", "batch"):
            raise ValueError(f"norm must be group or batch, got "
                             f"{config.norm!r}")
        w = _Widths(config)
        self.dtype = getattr(torch, config.dtype)
        self.canonical = config.canonical
        pad = w.red_pad  # the stem pads as the reductions do
        stem, cin = _Block(w), 3
        for cout, k, stride, p in ((32, 3, 2, pad), (32, 3, 1, pad),
                                   (64, 3, 1, "SAME"), (80, 1, 1, "SAME"),
                                   (192, 3, 1, pad)):
            cin = stem.add(cin, w.ch(cout), k, stride, p)
        self.stem = stem.cn
        self.inception_a = nn.ModuleList()
        for pool_features in (32, 64, 64):
            self.inception_a.append(InceptionA(w, cin, pool_features))
            cin = self.inception_a[-1].out
        self.reduction_a = ReductionA(w, cin)
        cin = self.reduction_a.out
        self.inception_b = nn.ModuleList()
        for c7 in (128, 160, 160, 192):
            self.inception_b.append(InceptionB(w, cin, c7))
            cin = self.inception_b[-1].out
        self.aux = (AuxHead(w, cin, config.num_classes) if config.canonical
                    else None)
        self.reduction_b = ReductionB(w, cin)
        cin = self.reduction_b.out
        self.inception_c = nn.ModuleList()
        for _ in range(2):
            self.inception_c.append(InceptionC(w, cin))
            cin = self.inception_c[-1].out
        self.head = nn.Linear(cin, config.num_classes)
        #: the GroupNorm + ReLU every ConvNorm calls; a test may set it to
        #: ``group_norm.group_norm_act_plain`` to run the plain twin
        self.norm_act = group_norm.group_norm_act

    def forward(self, image: torch.Tensor, train: bool = False):
        act = self.norm_act

        def s(k, x):
            return self.stem[k](x, act, train=train)

        pad = "VALID" if self.canonical else "SAME"
        x = _common.to_nchw(image, self.dtype)
        x = s(2, s(1, s(0, x)))
        x = _common.max_pool(x, 3, 2, pad)
        x = s(4, s(3, x))
        x = _common.max_pool(x, 3, 2, pad)
        for block in self.inception_a:
            x = block(x, act, train)
        x = self.reduction_a(x, act, train)
        for block in self.inception_b:
            x = block(x, act, train)
        aux = (self.aux(x, act, train) if train and self.aux is not None
               else None)
        x = self.reduction_b(x, act, train)
        for block in self.inception_c:
            x = block(x, act, train)
        x = _common.global_mean(x)
        logits = F.linear(x.float(), self.head.weight, self.head.bias)
        return (logits, aux) if aux is not None else logits

    def collections(self) -> dict:
        """``{"batch_stats": {name: buffer}}`` for BatchNorm (the live
        running statistics the train state carries), else ``{}``."""
        return _common.batch_stats_of(self)


def make_model(config: Config, seed: int = 0) -> InceptionV3:
    """An Inception-v3 on the CPU with f32 params drawn from ``seed``:
    He-normal convs, LeCun-normal heads (flax's truncated draws), zero
    biases, norm scale 1 and bias 0."""
    model = InceptionV3(config)
    _common.init_weights_(model, seed)
    return model


def make_loss_fn(model: InceptionV3, config: Config):
    """``loss(model, batch) -> scalar``: softmax cross-entropy in f32; on
    the canonical net ``CE(logits) + aux_weight · CE(aux_logits)``, the
    published training objective.  For BatchNorm the loss is stateful:
    the forward trains on the batch's statistics and updates the running
    ones in place (the aux head's too)."""
    batch_norm = config.norm == "batch"
    if not config.canonical:
        return (_common.make_stateful_classification_loss_fn(model)
                if batch_norm else
                _common.make_classification_loss_fn(model))

    def loss_fn(model, batch):
        logits, aux = model(batch["image"], train=True)
        labels = batch["label"].long()
        return (F.cross_entropy(logits.float(), labels)
                + config.aux_weight * F.cross_entropy(aux.float(), labels))

    if batch_norm:
        loss_fn.stateful = True
    return loss_fn


def make_forward_fn(model: InceptionV3, config: Config):
    """``forward(model, batch) -> logits`` (no aux head)."""
    return _common.classification_forward


#: the serving forward an export traces: ``logits = model(batch["image"])``
serving_forward = _common.classification_outputs


def make_serving_model(config: Config) -> InceptionV3:
    """The model an export binds its weights to: on the ``meta`` device,
    each GroupNorm through ``torch.ops.tfos.group_norm_act``; BatchNorm in
    eval mode over the export's ``batch_stats``."""
    with torch.device("meta"):
        model = InceptionV3(config)
    model.norm_act = group_norm.group_norm_act_op
    return model.eval()


def example_batch(config: Config, batch_size: int = 8, seed: int = 0):
    return _common.image_example_batch(
        (config.image_size, config.image_size, 3), config.num_classes,
        batch_size=batch_size, seed=seed)


state_of = _common.state_of
load_state = _common.load_state


def config_from_state(state: dict) -> Config:
    """The config with the export's parameter shapes: ``Config()`` or
    ``Config.tiny()``, canonical where the export holds the aux head,
    ``norm="batch"`` where it carries ``batch_stats``."""
    return _common.config_from_state(state, InceptionV3, (
        Config(), Config(canonical=True), Config.tiny(),
        Config.tiny_canonical()))


#: the reference's top-level modules (flax names them by call order)
_BLOCKS = {"InceptionA": ("inception_a", 3), "ReductionA": ("reduction_a", 1),
           "InceptionB": ("inception_b", 4), "ReductionB": ("reduction_b", 1),
           "InceptionC": ("inception_c", 2)}
_INNER = {"Conv_0": "conv", "GroupNorm_0": "norm", "BatchNorm_0": "norm"}


def _conv_norm(path: tuple, prefix: str) -> str:
    """``(ConvNorm_k, Conv_0 | GroupNorm_0 | BatchNorm_0)`` →
    ``<prefix>.k.conv|norm``."""
    if len(path) == 2 and path[1] in _INNER:
        k = _common.numbered(path[:1], "ConvNorm")
        return f"{prefix}.{k}.{_INNER[path[1]]}"
    raise KeyError(f"unmapped flax module {'/'.join(path)}")


def _module_name(path: tuple) -> str:
    top = path[0]
    try:
        if top.startswith("ConvNorm_"):
            return _conv_norm(path, "stem")
        if top == "Dense_0" and len(path) == 1:
            return "head"
        if top == "aux":
            if path[1:] == ("Dense_0",):
                return "aux.head"
            return _conv_norm(path[1:], "aux.cn")
        kind, _, index = top.rpartition("_")
        name, count = _BLOCKS[kind]
        if not index.isdigit() or int(index) >= count:
            raise KeyError(top)
        block = name if count == 1 else f"{name}.{int(index)}"
        return _conv_norm(path[1:], f"{block}.cn")
    except (KeyError, IndexError):
        raise KeyError(f"unmapped flax module {'/'.join(path)}") from None


def params_from_flax(params, batch_stats=None) -> dict:
    """The reference's params (and BatchNorm ``batch_stats``) by
    call-order name (``ConvNorm_k`` of the stem and of each block,
    ``InceptionA_0..2``, ``ReductionA_0``, ``InceptionB_0..3``, ``aux``,
    ``ReductionB_0``, ``InceptionC_0..1``, ``Dense_0``) as the port's
    export state.  Every leaf must map."""
    return _common.params_from_flax(params, _module_name, batch_stats)


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference ``Trainer``'s ``optax.adamw`` state as the port's
    AdamW state by parameter name."""
    return _common.opt_state_from_optax(opt_state, params, params_from_flax)
