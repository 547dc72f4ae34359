"""MobileNet-v1: port of ``tensorflowonspark_tpu/models/mobilenet.py``.

Howard et al. 2017, as the reference builds it: a 3×3 stride-2 stem, then
13 depthwise-separable blocks (3×3 depthwise, ``groups=C``, then 1×1
pointwise), each conv followed by GroupNorm(min(groups, C)) → ReLU, a
global mean (f32, rounded to the compute dtype) and an f32 classifier.
``width_mult`` scales every width, rounded to a multiple of 8.  The layers
keep the reference's names: ``stem``, ``dw.i``, ``pw.i``, ``classifier``.

The depthwise and pointwise convs stay on cuDNN (``F.conv2d``); each
GroupNorm + ReLU goes through :attr:`MobileNetV1.norm_act`, the fused
kernel: 27 calls a forward, 27 backward launches a training step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import _common

#: (pointwise_channels, depthwise_stride) per separable block: the
#: published 13-block schedule
_BLOCKS = (
    (64, 1),
    (128, 2), (128, 1),
    (256, 2), (256, 1),
    (512, 2), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
    (1024, 2), (1024, 1),
)


@dataclasses.dataclass(frozen=True)
class Config:
    width_mult: float = 1.0
    num_classes: int = 1000
    image_size: int = 224
    groups: int = 8
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "Config":
        return cls(width_mult=0.25, num_classes=10, image_size=16,
                   groups=2, dtype="float32")


def _scaled(ch: int, width_mult: float) -> int:
    """Channel count under the width multiplier, rounded to a multiple of 8
    (minimum 8) so GroupNorm groups and vector lanes divide evenly."""
    return max(8, int(round(ch * width_mult / 8)) * 8)


class MobileNetV1(nn.Module):
    """``forward(image)``: NHWC float32 images → float32 logits."""

    def __init__(self, config: Config):
        super().__init__()
        self.dtype = getattr(torch, config.dtype)
        ch = _scaled(32, config.width_mult)
        self.stem = _common.Conv(3, ch, 3, stride=2)
        norms = [_common.GroupNorm(ch, min(config.groups, ch))]
        dw, pw = [], []
        for pw_ch, stride in _BLOCKS:
            dw.append(_common.Conv(ch, ch, 3, stride=stride, groups=ch))
            norms.append(_common.GroupNorm(ch, min(config.groups, ch)))
            out = _scaled(pw_ch, config.width_mult)
            pw.append(_common.Conv(ch, out, 1))
            norms.append(_common.GroupNorm(out, min(config.groups, out)))
            ch = out
        self.dw, self.pw = nn.ModuleList(dw), nn.ModuleList(pw)
        #: in call order: the stem's, then each block's depthwise and
        #: pointwise (the reference's ``GroupNorm_0`` .. ``GroupNorm_26``)
        self.norms = nn.ModuleList(norms)
        self.classifier = nn.Linear(ch, config.num_classes)
        #: the GroupNorm + ReLU every norm calls; a test may set it to
        #: ``group_norm.group_norm_act_plain`` to run the plain twin
        self.norm_act = group_norm.group_norm_act

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = _common.to_nchw(image, self.dtype)
        x = self.norms[0](self.stem(x), self.norm_act)
        for i, (dw, pw) in enumerate(zip(self.dw, self.pw)):
            x = self.norms[2 * i + 1](dw(x), self.norm_act)
            x = self.norms[2 * i + 2](pw(x), self.norm_act)
        x = _common.global_mean(x)
        return F.linear(x.float(), self.classifier.weight,
                        self.classifier.bias)


def make_model(config: Config, seed: int = 0) -> MobileNetV1:
    """A MobileNet on the CPU with f32 params drawn from ``seed``:
    He-normal convs (fan-in 9 for a depthwise kernel, as flax's), a
    LeCun-normal classifier, zero biases."""
    model = MobileNetV1(config)
    _common.init_weights_(model, seed)
    return model


def make_loss_fn(model: MobileNetV1, config: Config):
    return _common.make_classification_loss_fn(model)


def make_forward_fn(model: MobileNetV1, config: Config):
    return _common.classification_forward


#: the serving forward an export traces: ``logits = model(batch["image"])``
serving_forward = _common.classification_outputs


def make_serving_model(config: Config) -> MobileNetV1:
    """The model an export binds its weights to: on the ``meta`` device,
    each GroupNorm through ``torch.ops.tfos.group_norm_act``."""
    with torch.device("meta"):
        model = MobileNetV1(config)
    model.norm_act = group_norm.group_norm_act_op
    return model.eval()


def example_batch(config: Config, batch_size: int = 8, seed: int = 0):
    return _common.image_example_batch(
        (config.image_size, config.image_size, 3), config.num_classes,
        batch_size=batch_size, seed=seed)


state_of = _common.state_of
load_state = _common.load_state


def config_from_state(state: dict) -> Config:
    """``Config.tiny()`` or ``Config()``, whichever has the export's
    parameter shapes."""
    return _common.config_from_state(state, MobileNetV1,
                                     (Config(), Config.tiny()))


def _module_name(path: tuple) -> str:
    if len(path) == 1:
        name = path[0]
        if name in ("stem", "classifier"):
            return name
        kind, _, index = name.rpartition("_")
        if kind in ("dw", "pw") and index.isdigit() \
                and int(index) < len(_BLOCKS):
            return f"{kind}.{int(index)}"
        if kind == "GroupNorm" and index.isdigit():
            return f"norms.{int(index)}"
    raise KeyError(f"unmapped flax module {'/'.join(path)}")


def params_from_flax(params) -> dict:
    """The reference's ``stem``, ``dw_i``, ``pw_i``, ``classifier`` keep
    their names (``dw.i``, ``pw.i``); ``GroupNorm_k`` → ``norms.k``.  A
    depthwise kernel ``(3, 3, 1, C)`` becomes torch's ``(C, 1, 3, 3)``."""
    return _common.params_from_flax(params, _module_name)


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference ``Trainer``'s ``optax.adamw`` state as the port's
    AdamW state by parameter name."""
    return _common.opt_state_from_optax(opt_state, params, params_from_flax)
