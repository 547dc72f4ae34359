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

A model may supply its own step built from the same pieces
(``models/widedeep.py::make_sharded_train_step``: :func:`gradients_of`,
:func:`average_across_ranks`, :func:`all_gather_cat`).  Data parallel
only; the bucketed and sharded exchanges of ``parallel/collectives.py``
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


class TrainState:
    """``params`` (the model's parameters by name: the tensors the
    optimizer updates in place), ``opt_state`` (the optimizer, which owns
    the moments), ``step`` (completed steps) and ``collections``: the
    model's non-param state by collection (``{"embedding": {"deep": t,
    ...}}`` for wide&deep, from the module's ``collections()``; empty for a
    model without one), live tensors that a model's own step updates in
    place."""

    def __init__(self, params, opt_state, step: int = 0, collections=None):
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.collections = collections or {}


def create_train_state(model: torch.nn.Module, optimizer) -> TrainState:
    collections = getattr(model, "collections", None)
    return TrainState(dict(model.named_parameters()), optimizer,
                      collections=collections() if collections else None)


def state_tree(state: TrainState) -> dict:
    """The checkpoint tree of ``state``, the reference's ``_state_tree``:
    ``{"params", "opt_state", "step", "collections"}``, leaves the LIVE
    tensors (a save snapshots them).  ``opt_state`` is the optimizer's
    ``state_dict()["state"]`` keyed by parameter name instead of index,
    each parameter's ``step`` included (AdamW: ``step``, ``exp_avg``,
    ``exp_avg_sq``); a parameter the optimizer holds nothing for yet is
    left out, and so is ``opt_state`` before the first step.  The
    hyperparameters stay the optimizer's own, as optax keeps them in the
    transformation.  ``collections`` carries the model's buffers by
    collection (wide&deep's tables and their AdaGrad accumulators,
    ``embedding_opt``)."""
    optimizer = state.opt_state
    opt = {name: dict(optimizer.state[p]) for name, p in state.params.items()
           if optimizer.state.get(p)}
    tree: dict[str, Any] = {"params": dict(state.params),
                            "step": int(state.step)}
    if opt:
        tree["opt_state"] = opt
    if state.collections:
        tree["collections"] = state.collections
    return tree


def load_state_tree(state: TrainState, tree: dict) -> None:
    """Load a :func:`state_tree` (numpy leaves, as ``ckpt.load_pytree``
    returns them) into ``state`` IN PLACE: the parameters and the
    collections' tensors are copied into, never rebound, because the
    optimizer and a model's own step (wide&deep's table update) hold
    them; the optimizer's state tensors are copied into where they exist
    and then handed to ``optimizer.load_state_dict``, which keeps them;
    a parameter the tree holds no optimizer state for starts fresh."""
    from tensorflowonspark_torch import ckpt

    target = {"params": state.params, "step": int(state.step)}
    if state.collections:
        target["collections"] = state.collections
    loaded = ckpt.copy_into(
        target, {k: v for k, v in tree.items() if k != "opt_state"})
    optimizer = state.opt_state
    saved = tree.get("opt_state") or {}
    unknown = sorted(set(saved) - set(state.params))
    if unknown:
        raise KeyError(f"checkpoint optimizer state for unknown parameters "
                       f"{unknown[:5]}")
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group["params"])}
    by_index = {}
    for name, p in state.params.items():
        if name not in saved:
            continue
        live = optimizer.state.get(p) or {}
        entry = {}
        for key, value in saved[name].items():
            src = torch.as_tensor(np.asarray(value))
            cur = live.get(key)
            if (isinstance(cur, torch.Tensor) and cur.shape == src.shape
                    and cur.dtype == src.dtype):
                with torch.no_grad():
                    cur.copy_(src)
                entry[key] = cur
            else:
                entry[key] = src
        by_index[index[id(p)]] = entry
    state_dict = optimizer.state_dict()
    state_dict["state"] = by_index
    optimizer.load_state_dict(state_dict)
    state.step = loaded["step"]


def world_size():
    """The initialised ``torch.distributed`` group's size (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gradients_of(params: list[torch.Tensor]) -> list[torch.Tensor]:
    """The ``.grad`` of every parameter; raises when the loss reached only
    some of them."""
    grads = [p.grad for p in params if p.grad is not None]
    if len(grads) != len(params):
        raise RuntimeError(
            f"{len(params) - len(grads)} of {len(params)} parameters got "
            "no gradient: the loss does not reach them")
    return grads


def all_gather_cat(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor all-gathered over the group and concatenated along dim
    0 in rank order: the global batch's rows, as one process would hold
    them.  Every rank must pass the same shapes."""
    import torch.distributed as dist

    out = []
    for t in tensors:
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        out.append(torch.cat(parts))
    return out


def average_across_ranks(grads: list[torch.Tensor], loss: torch.Tensor,
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
        grads = gradients_of(params)
        world = world_size()
        loss = (average_across_ranks(grads, loss, world) if world > 1
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
