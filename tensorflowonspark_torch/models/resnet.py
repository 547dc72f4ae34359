"""ResNet-50 for ImageNet: port of ``tensorflowonspark_tpu/models/resnet.py``.

The reference's choices carry over unchanged:

- the public input is NHWC float32; inside, the model runs
  ``channels_last`` in ``Config.dtype`` (bfloat16 for ``Config()``) with
  float32 params cast at use, a spatial mean taken in f32 and rounded to
  the compute dtype, and a float32 ``Dense`` head, so logits are float32;
- v1.5 bottleneck (stride in the 3×3), projection shortcut
  (``conv3``/``norm3``) where the shape changes, and the block ends with
  ``relu(residual + norm2(conv2(y)))``;
- GroupNorm by default (``num_groups=min(groups, ch)``, epsilon 1e-6, f32
  statistics), BatchNorm with ``norm="batch"`` (flax's ``momentum=0.9``,
  epsilon 1e-5: batch statistics and their running update under
  ``forward(image, train=True)``, the running statistics otherwise; plain
  PyTorch, ``_common.batch_norm``).

Each GroupNorm goes through :attr:`ResNet.norm_act` — the fused kernel of
:mod:`tensorflowonspark_torch.kernels.group_norm` — with the ReLU and, at a
block's end, the residual add folded in: 53 calls per ResNet-50 forward,
and in training 53 launches of its backward kernel per step.

XLA's ``SAME`` padding is asymmetric where the stride is 2 (the 7×7/2 stem
on 224 pads ``(2, 3)``, the 3×3/2 convs and the max-pool ``(0, 1)``), so
every conv and the pool pad explicitly (``-inf`` for the pool) instead of
torch's symmetric ``padding=k//2``.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import _common

GROUP_NORM_EPS = _common.GROUP_NORM_EPS
BATCH_NORM_EPS = _common.BATCH_NORM_EPS


@dataclasses.dataclass(frozen=True)
class Config:
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    image_size: int = 224
    groups: int = 32
    dtype: str = "bfloat16"
    norm: str = "group"  # "group" | "batch"

    @classmethod
    def tiny(cls, norm: str = "group") -> "Config":
        return cls(stage_sizes=(1, 1), width=8, num_classes=10, image_size=16,
                   groups=2, dtype="float32", norm=norm)


#: XLA's ``SAME`` padding of one spatial dim (shared with the other models)
same_pads = _common.same_pads
#: bias-free conv with ``SAME`` padding; f32 weight cast at use
_Conv = _common.Conv


class _Norm(nn.Module):
    """GroupNorm through the fused kernel, or BatchNorm
    (``_common.batch_norm``: batch statistics and the running update with
    ``train``, the running statistics without), with the optional
    residual add and ReLU of the position it sits at."""

    def __init__(self, ch: int, groups: int, batch: bool):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.groups = min(groups, ch)
        self.batch = batch
        if batch:
            self.register_buffer("mean", torch.zeros(ch))
            self.register_buffer("var", torch.ones(ch))

    def forward(self, x, norm_act, residual=None, relu=True, train=False):
        if not self.batch:
            return norm_act(x, self.scale, self.bias, self.groups,
                            GROUP_NORM_EPS, residual, relu)
        return _common.batch_norm(x, self.scale, self.bias, self.mean,
                                  self.var, train, residual, relu)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, groups: int,
                 batch: bool):
        super().__init__()
        out = filters * 4
        self.conv0 = _Conv(cin, filters, 1)
        self.norm0 = _Norm(filters, groups, batch)
        self.conv1 = _Conv(filters, filters, 3, stride)
        self.norm1 = _Norm(filters, groups, batch)
        self.conv2 = _Conv(filters, out, 1)
        self.norm2 = _Norm(out, groups, batch)
        if stride != 1 or cin != out:
            self.conv3 = _Conv(cin, out, 1, stride)
            self.norm3 = _Norm(out, groups, batch)
        else:
            self.conv3 = self.norm3 = None

    def forward(self, x, norm_act, train=False):
        y = self.norm0(self.conv0(x), norm_act, train=train)
        y = self.norm1(self.conv1(y), norm_act, train=train)
        residual = x
        if self.conv3 is not None:
            residual = self.norm3(self.conv3(x), norm_act, relu=False,
                                  train=train)
        return self.norm2(self.conv2(y), norm_act, residual=residual,
                          train=train)


class ResNet(nn.Module):
    """``forward(image, train=False)``: NHWC float32 images → float32
    logits.  ``train`` matters to BatchNorm only (batch statistics and the
    running update); it is an argument, as the reference's, never the
    module's ``.training`` flag."""

    def __init__(self, config: Config):
        super().__init__()
        batch = config.norm == "batch"
        self.dtype = getattr(torch, config.dtype)
        self.conv = _Conv(3, config.width, 7, 2)
        self.norm = _Norm(config.width, config.groups, batch)
        blocks, cin = [], config.width
        for i, n_blocks in enumerate(config.stage_sizes):
            filters = config.width * 2 ** i
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(Bottleneck(cin, filters, stride, config.groups,
                                         batch))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, config.num_classes)
        #: the GroupNorm(+add)(+ReLU) every norm calls; a test may set it to
        #: ``group_norm.group_norm_act_plain`` to run the plain twin
        self.norm_act = group_norm.group_norm_act

    def forward(self, image: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        x = image.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = self.norm(self.conv(x), self.norm_act, train=train)
        (ht, hb), (wl, wr) = same_pads(x.shape[2], 3, 2), same_pads(
            x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")), 3, 2)
        for block in self.blocks:
            x = block(x, self.norm_act, train)
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        return F.linear(x.float(), self.head.weight, self.head.bias)

    def collections(self) -> dict:
        """``{"batch_stats": {name: buffer}}`` for BatchNorm (the live
        running statistics the train state carries), else ``{}``."""
        return _common.batch_stats_of(self)


def make_model(config: Config, seed: int = 0) -> ResNet:
    """A ResNet on the CPU with float32 params drawn from ``seed``:
    He-normal convs, LeCun-normal head (both truncated at ±2σ, flax's
    ``variance_scaling`` draw), zero head bias, norm scale 1 and bias 0.
    The draw is torch's, not JAX's: parity tests load converted weights
    (:func:`params_from_flax`) instead."""
    model = ResNet(config)
    _common.init_weights_(model, seed)
    return model


def make_loss_fn(model: ResNet, config: Config):
    """``loss(model, batch) -> scalar`` (softmax cross-entropy, f32); for
    BatchNorm the stateful loss, which trains on the batch's statistics
    and updates the running ones in place."""
    if config.norm == "batch":
        return _common.make_stateful_classification_loss_fn(model)
    return _common.make_classification_loss_fn(model)


#: the serving forward an export traces: ``logits = model(batch["image"])``
serving_forward = _common.classification_outputs


def make_serving_model(config: Config) -> ResNet:
    """The model an export binds its weights to: built on the ``meta``
    device (no storage, no init), each GroupNorm through
    ``torch.ops.tfos.group_norm_act``, which ``torch.export`` records as
    one node that dispatches on the device the program runs on.  A
    BatchNorm model serves in eval mode: its running statistics, bound
    from the export's ``batch_stats``."""
    with torch.device("meta"):
        model = ResNet(config)
    model.norm_act = group_norm.group_norm_act_op
    return model.eval()


def make_forward_fn(model: ResNet, config: Config):
    """``forward(model, batch) -> logits`` (BatchNorm statistics live in the
    module, so one forward serves both norms)."""
    del model, config
    return _common.classification_forward


def example_batch(config: Config, batch_size: int = 8, seed: int = 0):
    return _common.image_example_batch(
        (config.image_size, config.image_size, 3), config.num_classes,
        batch_size=batch_size, seed=seed)


def write_synthetic_tfrecords(data_dir: str, n: int, parts: int, side: int,
                              seed: int = 0, num_classes: int = 1000) -> list:
    """Synthesise ImageNet-shaped TFRecords (uint8 image bytes + int64
    label in ``[0, num_classes)``), one ``part-NNNNN`` file per part;
    returns the file paths.

    The reference's schema and draw
    (``tensorflowonspark_tpu/models/resnet.py::write_synthetic_tfrecords``):
    at the default 1000 classes the same ``seed`` writes the same bytes.
    The reference always draws 1000 classes, which the tiny config's 10
    cannot hold (its loss is NaN there, and torch's cross-entropy
    rejects such labels): pass the config's ``num_classes``.  The parse
    side is :func:`tfrecord_parse_fn`.
    """
    import os

    from tensorflowonspark_torch import tfrecord

    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    per_part = (n + parts - 1) // parts
    paths = []
    for p in range(parts):
        count = min(per_part, n - p * per_part)
        if count <= 0:
            break

        def examples():
            for _ in range(count):
                img = rng.integers(0, 256, size=(side, side, 3), dtype=np.uint8)
                yield tfrecord.encode_example({
                    "image": (tfrecord.BYTES_LIST, [img.tobytes()]),
                    "label": (tfrecord.INT64_LIST,
                              [int(rng.integers(0, num_classes))]),
                })

        path = os.path.join(data_dir, f"part-{p:05d}")
        tfrecord.write_records(path, examples())
        paths.append(path)
    return paths


def tfrecord_parse_fn(side: int):
    """Parse fn decoding :func:`write_synthetic_tfrecords` records into
    ``{"image": f32 (side,side,3) in [0,1], "label": i32}``, on the host."""
    from tensorflowonspark_torch import tfrecord

    def parse(payload: bytes):
        ex = tfrecord.decode_example(payload)
        img = np.frombuffer(ex["image"][1][0], np.uint8)
        return {
            "image": img.reshape(side, side, 3).astype(np.float32) / 255.0,
            "label": np.int32(ex["label"][1][0]),
        }

    return parse


# ---------------------------------------------------------------------------
# Weights: port state <-> module, flax tree -> port state
# ---------------------------------------------------------------------------


#: the export state (``{"params"}`` plus BatchNorm's ``{"collections":
#: {"batch_stats"}}``) and its load, strict
state_of = _common.state_of
load_state = _common.load_state


def config_from_state(state: dict) -> Config:
    """The ``Config`` an export state (see :func:`state_of`) was written
    from: ``Config.tiny()`` where the parameter shapes are the tiny
    model's, else ``Config()``; ``norm="batch"`` where the export carries
    collections (BatchNorm statistics)."""
    with torch.device("meta"):  # shapes only
        tiny = ResNet(Config.tiny())
    tiny_shapes = sorted(tuple(p.shape) for p in tiny.parameters())
    got = sorted(tuple(getattr(v, "shape", ()))
                 for v in state["params"].values())
    config = Config.tiny() if got == tiny_shapes else Config()
    if state.get("collections"):
        config = dataclasses.replace(config, norm="batch")
    return config


_TOP = re.compile(r"^(Conv|GroupNorm|BatchNorm|Bottleneck|Dense)_(\d+)$")
_INNER = re.compile(r"^(Conv|GroupNorm|BatchNorm)_(\d+)$")


def _module_name(path: tuple[str, ...]) -> str:
    """Torch module name of a flax module path, e.g.
    ``("Bottleneck_10", "Conv_3")`` → ``"blocks.10.conv3"``.  Blocks map by
    the integer in their name (sorted keys put ``Bottleneck_10`` before
    ``Bottleneck_2``)."""
    m = _TOP.match(path[0])
    if m is None:
        raise KeyError(f"unmapped flax module {'/'.join(path)}")
    kind, idx = m.group(1), int(m.group(2))
    if kind == "Bottleneck":
        inner = _INNER.match(path[1]) if len(path) == 2 else None
        if inner is None:
            raise KeyError(f"unmapped flax module {'/'.join(path)}")
        sub = "conv" if inner.group(1) == "Conv" else "norm"
        return f"blocks.{idx}.{sub}{int(inner.group(2))}"
    if len(path) != 1 or idx != 0:
        raise KeyError(f"unmapped flax module {'/'.join(path)}")
    return {"Conv": "conv", "Dense": "head"}.get(kind, "norm")


def params_from_flax(params, batch_stats=None) -> dict:
    """Convert the reference's flax ``params`` (and BatchNorm
    ``batch_stats``) into the port's export state (:func:`state_of`).

    Conv kernels go HWIO → OIHW, the ``Dense`` kernel ``(in, out)`` →
    ``(out, in)``; norm ``scale``/``bias`` and ``mean``/``var`` keep their
    names.  A leaf that maps to nothing raises ``KeyError``."""
    return _common.params_from_flax(params, _module_name, batch_stats)


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference ``Trainer``'s ``optax.adamw`` state (``count``,
    ``mu``, ``nu``; live or restored as numpy) as the port's AdamW state
    by parameter name (``parallel.train.state_tree``'s ``opt_state``),
    the moments converted as :func:`params_from_flax` converts ``params``
    (HWIO → OIHW, the head transposed)."""
    return _common.opt_state_from_optax(opt_state, params, params_from_flax)
