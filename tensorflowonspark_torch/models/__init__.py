"""Model zoo of the port, mirroring ``tensorflowonspark_tpu/models``.

Every model module exposes the reference's surface, in PyTorch:

- ``Config`` dataclass (tiny test config via ``Config.tiny()``)
- ``make_model(config, ...)`` → ``torch.nn.Module``
- ``make_forward_fn(model, config)`` → ``forward(model, batch) -> outputs``
- ``example_batch(config, batch_size, seed)`` → dict of numpy arrays

Only ``resnet50`` is ported so far; the other reference names raise
``KeyError`` saying so.
"""

from __future__ import annotations

import importlib

_REGISTRY = {
    "resnet50": "tensorflowonspark_torch.models.resnet",
}

#: reference zoo entries the port does not have yet
_NOT_PORTED = ("mnist_mlp", "cifar10_cnn", "inception_v3", "mobilenet_v1",
               "wide_deep", "bert", "tiny_lm")


def get_model(name: str):
    """Return the model module registered under ``name``."""
    if name in _NOT_PORTED:
        raise KeyError(f"model {name!r} is not yet ported to "
                       f"tensorflowonspark_torch; available: {available()}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {available()}")
    return importlib.import_module(_REGISTRY[name])


def available() -> list[str]:
    return sorted(_REGISTRY)
