"""Model zoo of the port, mirroring ``tensorflowonspark_tpu/models``.

Every model module exposes the reference's surface, in PyTorch:

- ``Config`` dataclass (tiny test config via ``Config.tiny()``)
- ``make_model(config, ...)`` → ``torch.nn.Module``
- ``make_forward_fn(model, config)`` → ``forward(model, batch) -> outputs``
- ``example_batch(config, batch_size, seed)`` → dict of numpy arrays
- ``make_loss_fn(model, config)`` → ``loss(model, batch) -> scalar``
- ``state_of(model)`` / ``load_state(model, state)`` /
  ``config_from_state(state)`` → the weights-only export and back
- ``make_serving_model(config)`` / ``serving_forward`` → the forward an
  export serializes
- ``params_from_flax(params)`` / ``opt_state_from_optax(opt_state,
  params)`` → the JAX package's weights and AdamW state, as numpy

``tiny_lm`` (``models/tinylm.py``) carries the decode surface that
``decode.DecodeEngine`` serves and trains through ``Trainer``; the
reference defines no export or ``TFModel`` serving for it.
"""

from __future__ import annotations

import importlib

_REGISTRY = {
    "mnist_mlp": "tensorflowonspark_torch.models.mnist",
    "cifar10_cnn": "tensorflowonspark_torch.models.cifar",
    "resnet50": "tensorflowonspark_torch.models.resnet",
    "inception_v3": "tensorflowonspark_torch.models.inception",
    "mobilenet_v1": "tensorflowonspark_torch.models.mobilenet",
    "wide_deep": "tensorflowonspark_torch.models.widedeep",
    "bert": "tensorflowonspark_torch.models.bert",
    "tiny_lm": "tensorflowonspark_torch.models.tinylm",
}


def get_model(name: str):
    """Return the model module registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {available()}")
    return importlib.import_module(_REGISTRY[name])


def available() -> list[str]:
    return sorted(_REGISTRY)
