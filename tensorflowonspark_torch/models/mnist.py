"""MNIST dense classifier: port of ``tensorflowonspark_tpu/models/mnist.py``.

Acceptance config #1: the reference's dense 784→128→64→10 MLP with ReLUs,
f32 by default (``Config.dtype`` casts the input and every layer, as flax's
``nn.Dense(dtype=...)`` does), trained with softmax cross-entropy.  Images
arrive as flat vectors.  It runs no GroupNorm, and no kernel of the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.models import _common


@dataclasses.dataclass(frozen=True)
class Config:
    hidden: tuple = (128, 64)
    num_classes: int = 10
    image_size: int = 28
    dtype: str = "float32"

    @classmethod
    def tiny(cls) -> "Config":
        return cls(hidden=(16,), image_size=8)


class MLP(nn.Module):
    """``forward(image)``: ``(N, ...)`` images, flattened → logits in
    ``Config.dtype``."""

    def __init__(self, config: Config):
        super().__init__()
        self.dtype = getattr(torch, config.dtype)
        widths = [config.image_size ** 2, *config.hidden, config.num_classes]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = image.reshape(image.shape[0], -1).to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(self.dtype),
                         layer.bias.to(self.dtype))
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def make_model(config: Config, seed: int = 0) -> MLP:
    """An MLP on the CPU, f32 params from ``seed``: LeCun-normal kernels
    (truncated, flax's draw), zero biases."""
    model = MLP(config)
    _common.init_weights_(model, seed)
    return model


def make_loss_fn(model: MLP, config: Config):
    return _common.make_classification_loss_fn(model)


def make_forward_fn(model: MLP, config: Config):
    return _common.classification_forward


#: the serving forward an export traces: ``logits = model(batch["image"])``
serving_forward = _common.classification_outputs


def make_serving_model(config: Config) -> MLP:
    """The model an export binds its weights to, on the ``meta`` device."""
    with torch.device("meta"):
        return MLP(config).eval()


def example_batch(config: Config, batch_size: int = 8, seed: int = 0):
    return _common.image_example_batch(
        (config.image_size * config.image_size,), config.num_classes,
        batch_size=batch_size, seed=seed)


state_of = _common.state_of
load_state = _common.load_state


def config_from_state(state: dict) -> Config:
    """``Config.tiny()`` or ``Config()``, whichever has the export's
    parameter shapes."""
    return _common.config_from_state(state, MLP, (Config(), Config.tiny()))


def params_from_flax(params) -> dict:
    """The reference's ``Dense_i`` → ``layers.i``."""
    return _common.params_from_flax(
        params, lambda path: f"layers.{_common.numbered(path, 'Dense')}")


def opt_state_from_optax(opt_state, params) -> dict:
    """The reference ``Trainer``'s ``optax.adamw`` state as the port's
    AdamW state by parameter name (the moments converted as
    :func:`params_from_flax` converts ``params``)."""
    return _common.opt_state_from_optax(opt_state, params, params_from_flax)
