"""Shared helpers of the port's models.

Reference anchor: ``tensorflowonspark_tpu/models/_common.py``
(``image_example_batch``, ``make_classification_forward_fn``,
``make_classification_loss_fn``), plus the seeded init and the flax-tree
walk that the models' weight converters share.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

#: std of a standard normal truncated to ±2 (flax's variance_scaling
#: divides by it so the truncated draw keeps the requested variance)
_TRUNC_STD = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, gain: float,
                      generator: torch.Generator) -> None:
    """flax's ``variance_scaling(gain, "fan_in", "truncated_normal")`` in
    place: He normal for ``gain`` 2, LeCun normal for 1.  ``fan_in`` is
    ``weight[0].numel()`` (torch's ``(out, in, ...)`` layout)."""
    std = math.sqrt(gain / weight[0].numel()) / _TRUNC_STD
    torch.nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                generator=generator)


def flax_leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested mapping; flax's partitioning boxes
    (``nn.Partitioned``, from ``nn.with_partitioning``) are unboxed."""
    for k, v in tree.items():
        if hasattr(v, "unbox"):
            v = v.unbox()
        if hasattr(v, "items"):
            yield from flax_leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def classification_outputs(model: torch.nn.Module, batch) -> torch.Tensor:
    """Logits of ``model`` over ``batch['image']``: the serving forward an
    export traces (``saved_model.wrap_state_forward``)."""
    return model(batch["image"])


def classification_forward(model: torch.nn.Module, batch) -> torch.Tensor:
    """:func:`classification_outputs` without autograd.  ``model`` rides
    as the first argument, where the reference's forward takes its params
    pytree."""
    with torch.inference_mode():
        return classification_outputs(model, batch)


def adam_state_from_optax(opt_state, params_from_flax) -> dict:
    """The port's optimizer-state tree (``parallel.train.state_tree``'s
    ``opt_state``: AdamW's ``step``, ``exp_avg`` and ``exp_avg_sq`` by
    parameter name) from an ``optax.adamw`` state: the live chain of
    namedtuples, or the list of dicts a checkpoint restores as numpy.
    ``count`` becomes every parameter's ``step`` (torch counts completed
    steps, as optax does); ``mu`` and ``nu`` go through
    ``params_from_flax`` (flax tree → ``{name: array}``), so the moments
    take the weights' layout changes."""
    adam = None
    for part in opt_state:
        fields = part if isinstance(part, dict) else getattr(
            part, "_asdict", lambda: {})()
        if "mu" in fields and "nu" in fields:
            adam = fields
            break
    if adam is None:
        raise KeyError("no ScaleByAdamState (count, mu, nu) in the optax "
                       "state")
    step = np.float32(np.asarray(adam["count"]))
    mu, nu = params_from_flax(adam["mu"]), params_from_flax(adam["nu"])
    return {name: {"step": step, "exp_avg": mu[name],
                   "exp_avg_sq": nu[name]} for name in mu}


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
