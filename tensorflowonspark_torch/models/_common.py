"""Shared helpers for image-classification models.

Reference anchor: ``tensorflowonspark_tpu/models/_common.py``
(``image_example_batch``, ``make_classification_forward_fn``,
``make_classification_loss_fn``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def classification_forward(model: torch.nn.Module, batch) -> torch.Tensor:
    """Logits of ``model`` over ``batch['image']``, without autograd.
    ``model`` rides as the first argument, where the reference's forward
    takes its params pytree."""
    with torch.inference_mode():
        return model(batch["image"])


def make_classification_loss_fn(model: torch.nn.Module):
    """``loss(model, batch) -> scalar``: softmax cross-entropy in float32
    over ``batch['image']`` / integer ``batch['label']``, averaged over the
    batch (the reference's ``optax.softmax_cross_entropy_with_integer_labels``
    mean).  ``model`` rides as the loss's first argument, where the
    reference's loss takes its params pytree."""
    del model

    def loss_fn(model, batch):
        logits = model(batch["image"])
        return F.cross_entropy(logits.float(), batch["label"].long())

    return loss_fn


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
