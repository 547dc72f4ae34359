"""Training-step factory, data parallel.

Reference anchor: ``tensorflowonspark_tpu/parallel/train.py``
(``TrainState``, ``create_train_state``, ``make_train_step``,
``make_eval_step``).  The JAX package compiles one ``jax.jit`` step over a
mesh, with ``jax.value_and_grad``, an optional
``optax.clip_by_global_norm`` and ``optax`` updates, and the gradient
``psum`` across the data-parallel axis.  Here the step runs eagerly:

- ``loss_fn(model, batch)`` (the model rides where the reference's params
  ride), ``loss.backward()``;
- with a ``torch.distributed`` group of more than one process, the
  gradients and the loss are averaged across ranks by one ``all_reduce``
  of one flat buffer: each rank trains on its share of the global batch,
  as each dp shard does under the ``psum``;
- the optional global-norm clip, with optax's semantics: gradients are
  scaled by ``max_norm / norm`` only when ``norm ≥ max_norm``;
- the optimizer step, which updates the parameters in place (where the
  reference returns new arrays).

Data parallel only; the bucketed and sharded exchanges of
``parallel/collectives.py`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


class TrainState:
    """``params`` (the model's parameters by name: the tensors the
    optimizer updates in place), ``opt_state`` (the optimizer, which owns
    the moments) and ``step`` (completed steps).  The reference's non-param
    ``collections`` (BatchNorm statistics) wait for BatchNorm training."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step


def create_train_state(model: torch.nn.Module, optimizer) -> TrainState:
    return TrainState(dict(model.named_parameters()), optimizer)


def _world():
    """The initialised ``torch.distributed`` group's size (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _average_across_ranks(grads: list[torch.Tensor], loss: torch.Tensor,
                          world: int) -> torch.Tensor:
    """Average ``grads`` (in place) and ``loss`` over the ranks with one
    ``all_reduce`` of one flat f32 buffer; returns the averaged loss."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [loss.detach().reshape(1).float()])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1]


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm(max_norm)`` in place: scale every
    gradient by ``max_norm / norm`` when the global norm is not below
    ``max_norm``.  No host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def make_train_step(loss_fn: Callable[[Any, Any], torch.Tensor], optimizer,
                    model: torch.nn.Module,
                    clip_global_norm: float | None = None):
    """``step(state, batch) -> (state, loss)``: one optimizer step of
    ``loss_fn(model, batch)`` (see the module docstring).  ``loss`` is the
    detached scalar on the device, averaged over the ranks when a group
    of more than one process is initialised."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        if len(grads) != len(params):
            raise RuntimeError(
                f"{len(params) - len(grads)} of {len(params)} parameters got "
                "no gradient: the loss does not reach them")
        world = _world()
        loss = (_average_across_ranks(grads, loss, world) if world > 1
                else loss.detach())
        if clip_global_norm is not None:
            clip_by_global_norm_(grads, float(clip_global_norm))
        optimizer.step()
        state.step += 1
        return state, loss

    return step


def make_eval_step(forward_fn, model: torch.nn.Module):
    """``eval_step(batch) -> outputs``: ``forward_fn(model, batch)`` (the
    model zoo's forwards run without autograd)."""

    def eval_step(batch):
        return forward_fn(model, batch)

    return eval_step
