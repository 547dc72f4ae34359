"""CIFAR-10 CNN: port of ``tensorflowonspark_tpu/models/cifar.py``.

Acceptance config #2.  Each stage is conv(3×3, bias) → GroupNorm(min(groups,
C)) → ReLU, twice, then a 2×2 average pool; then a global mean (f32,
rounded to the compute dtype) and an f32 dense head.  bf16 compute with
f32 params for ``Config()``, as the reference.

Each GroupNorm + ReLU goes through :attr:`CNN.norm_act`, the fused kernel
of :mod:`tensorflowonspark_torch.kernels.group_norm`: 6 calls a forward
and, in training, 6 launches of its backward kernel a step.
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
    channels: tuple = (64, 128, 256)
    num_classes: int = 10
    image_size: int = 32
    groups: int = 8
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls) -> "Config":
        return cls(channels=(8, 16), image_size=8, groups=2, dtype="float32")


class CNN(nn.Module):
    """``forward(image)``: NHWC float32 images → float32 logits."""

    def __init__(self, config: Config):
        super().__init__()
        self.dtype = getattr(torch, config.dtype)
        convs, norms, cin = [], [], 3
        for ch in config.channels:
            for _ in range(2):
                convs.append(_common.Conv(cin, ch, 3, bias=True))
                norms.append(_common.GroupNorm(ch, min(config.groups, ch)))
                cin = ch
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.head = nn.Linear(cin, config.num_classes)
        #: the GroupNorm + ReLU every norm calls; a test may set it to
        #: ``group_norm.group_norm_act_plain`` to run the plain twin
        self.norm_act = group_norm.group_norm_act

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = _common.to_nchw(image, self.dtype)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            x = norm(conv(x), self.norm_act)
            if i % 2:
                x = _common.avg_pool(x, 2, 2)
        x = _common.global_mean(x)
        return F.linear(x.float(), self.head.weight, self.head.bias)


def make_model(config: Config, seed: int = 0) -> CNN:
    """A CNN on the CPU with f32 params drawn from ``seed``: He-normal
    convs, a LeCun-normal head (flax's truncated draws), zero biases."""
    model = CNN(config)
    _common.init_weights_(model, seed)
    return model


def make_loss_fn(model: CNN, config: Config):
    return _common.make_classification_loss_fn(model)


def make_forward_fn(model: CNN, config: Config):
    return _common.classification_forward


#: the serving forward an export traces: ``logits = model(batch["image"])``
serving_forward = _common.classification_outputs


def make_serving_model(config: Config) -> CNN:
    """The model an export binds its weights to: on the ``meta`` device,
    each GroupNorm through ``torch.ops.tfos.group_norm_act``."""
    with torch.device("meta"):
        model = CNN(config)
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
    return _common.config_from_state(state, CNN, (Config(), Config.tiny()))


def _module_name(path: tuple) -> str:
    kind = path[0].split("_")[0] if len(path) == 1 else ""
    index = _common.numbered(path, kind) if kind else None
    if kind == "Conv":
        return f"convs.{index}"
    if kind == "GroupNorm":
        return f"norms.{index}"
    if kind == "Dense" and index == 0:
        return "head"
    raise KeyError(f"unmapped flax module {'/'.join(path)}")


def params_from_flax(params) -> dict:
    """The reference's ``Conv_i``/``GroupNorm_i`` (call order) →
    ``convs.i``/``norms.i``, ``Dense_0`` → ``head``."""
    return _common.params_from_flax(params, _module_name)


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference ``Trainer``'s ``optax.adamw`` state as the port's
    AdamW state by parameter name."""
    return _common.opt_state_from_optax(opt_state, params, params_from_flax)
