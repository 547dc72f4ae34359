"""Shared helpers for image-classification models.

Reference anchor: ``tensorflowonspark_tpu/models/_common.py``
(``image_example_batch``, ``make_classification_forward_fn``).
"""

from __future__ import annotations

import numpy as np
import torch


def classification_forward(model: torch.nn.Module, batch) -> torch.Tensor:
    """Logits of ``model`` over ``batch['image']``, without autograd.
    ``model`` rides as the first argument, where the reference's forward
    takes its params pytree."""
    with torch.inference_mode():
        return model(batch["image"])


def image_example_batch(image_shape, num_classes: int, batch_size: int = 8,
                        seed: int = 0):
    """Synthetic ``{image, label}`` batch; ``image_shape`` excludes batch.
    The same ``RandomState`` draw as the reference, so both packages see
    the same images for the same seed."""
    rng = np.random.RandomState(seed)
    return {
        "image": rng.rand(batch_size, *image_shape).astype(np.float32),
        "label": rng.randint(0, num_classes, size=(batch_size,)).astype(
            np.int32
        ),
    }
