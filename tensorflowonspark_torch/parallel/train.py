"""Training-step factory, data parallel, and the compiled step.

Reference anchor: ``tensorflowonspark_tpu/parallel/train.py``
(``TrainState``, ``create_train_state``, ``compile_step``,
``make_train_step``, ``make_eval_step``).  The JAX package compiles one
``jax.jit`` step over a mesh, with ``jax.value_and_grad``, an optional
``optax.clip_by_global_norm`` and ``optax`` updates, and the gradient
``psum`` across the data-parallel axis.  Here :func:`make_train_step`
builds the eager step:

- ``loss_fn(model, batch)`` (the model rides where the reference's params
  ride), ``loss.backward()``;
- with a ``torch.distributed`` group of more than one process, the
  gradients and the loss are averaged across ranks by one ``all_reduce``
  of one flat buffer: each rank trains on its share of the global batch,
  as each dp shard does under the ``psum``.  A stateful loss (BatchNorm:
  ``loss_fn.stateful``) normalises each rank's share by that share's
  statistics and updates the running statistics in place; their floating
  leaves ride the same buffer and leave it averaged.  That is the
  reference's default, bucketed step (``parallel/collectives.py``:
  per-replica statistics, then a ``pmean`` of every floating collection
  leaf); its global-batch statistics (one data shard, or
  ``TFOS_BUCKETED_ALLREDUCE=0``) are what one process computes;
- the optional global-norm clip, with optax's semantics: gradients are
  scaled by ``max_norm / norm`` only when ``norm ≥ max_norm``;
- the optimizer step, which updates the parameters in place (where the
  reference returns new arrays).

A model may supply its own step built from the same pieces
(``models/widedeep.py::make_sharded_train_step``: :func:`gradients_of`,
:func:`average_across_ranks`, :func:`all_gather_cat`).

:func:`compile_step` is the counterpart of the reference's ``jax.jit``
of such a step: on the card it captures the whole step into one CUDA
graph per batch signature and replays it (:class:`CompiledStep`); on the
CPU it runs the step as it is.  Data parallel only; the bucketed and
sharded exchanges of ``parallel/collectives.py`` are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from tensorflowonspark_torch import shapes
from tensorflowonspark_torch.kernels import group_norm


class TrainState:
    """``params`` (the model's parameters by name: the tensors the
    optimizer updates in place), ``opt_state`` (the optimizer, which owns
    the moments), ``step`` (completed steps) and ``collections``: the
    model's non-param state by collection (``{"embedding": {"deep": t,
    ...}}`` for wide&deep, ``{"batch_stats": {"norm.mean": t, ...}}`` for
    BatchNorm, from the module's ``collections()``; empty for a model
    without one), live tensors that the step updates in place."""

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


def floating_leaves(collections: dict) -> list[torch.Tensor]:
    """The floating-point tensors of a state's ``collections`` (BatchNorm's
    running statistics), in the collections' order, which every rank
    shares."""
    out = []
    for leaf in collections.values():
        if isinstance(leaf, dict):
            out += floating_leaves(leaf)
        elif isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            out.append(leaf)
    return out


def average_across_ranks(grads: list[torch.Tensor], loss: torch.Tensor,
                         world: int,
                         stats: list[torch.Tensor] = ()) -> torch.Tensor:
    """Average ``grads`` and ``stats`` (both in place) and ``loss`` over
    the ranks with one ``all_reduce`` of one flat f32 buffer; returns the
    averaged loss."""
    import torch.distributed as dist

    tensors = [*grads, *stats]
    flat = torch.cat([t.reshape(-1).float() for t in tensors]
                     + [loss.detach().reshape(1).float()])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
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
    of more than one process is initialised.  A stateful loss updates
    ``state.collections`` in place, and across ranks they are averaged
    with the gradients."""
    params = [p for p in model.parameters() if p.requires_grad]
    stateful = bool(getattr(loss_fn, "stateful", False))

    def step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        grads = gradients_of(params)
        world = world_size()
        if world > 1:
            stats = floating_leaves(state.collections) if stateful else []
            loss = average_across_ranks(grads, loss, world, stats)
        else:
            loss = loss.detach()
        if clip_global_norm is not None:
            clip_by_global_norm_(grads, float(clip_global_norm))
        optimizer.step()
        state.step += 1
        return state, loss

    return step


def make_eval_step(forward_fn, model: torch.nn.Module):
    """``eval_step(batch) -> outputs``: ``forward_fn(model, batch)``
    without autograd (``inference_mode``), whatever the forward does, so
    no output requires grad."""

    def eval_step(batch):
        with torch.inference_mode():
            return forward_fn(model, batch)

    return eval_step


# ---------------------------------------------------------------------------
# The compiled step: one CUDA graph per batch signature
# ---------------------------------------------------------------------------

#: Steps run by a graph replay alone in this process, by every
#: :class:`CompiledStep`.  Such a step launches the kernels its capture
#: recorded without calling their wrappers, so the wrappers' launch
#: counters count the eager and the capturing steps only; a count planned
#: per step holds for the steps less these.
replayed_steps = 0


def check_capturable(optimizer) -> None:
    """Raise, with the reason, unless ``optimizer.step()`` can be captured
    into a CUDA graph.  An optimizer with a ``capturable`` option must have
    it on in every parameter group (it keeps its step count on the device;
    without it AdamW computes the bias corrections on the host, which a
    replay would never redo).  Of those without the option only SGD keeps
    no state on the host."""
    defaults = getattr(optimizer, "defaults", None) or {}
    name = type(optimizer).__name__
    if "capturable" in defaults:
        off = [i for i, g in enumerate(optimizer.param_groups)
               if not g.get("capturable")]
        if off:
            raise ValueError(
                f"{name} cannot be captured into the compiled step: "
                f"capturable=False in parameter group(s) {off} (its step "
                f"count and bias corrections live on the host); build it "
                f"with capturable=True")
    elif not isinstance(optimizer, torch.optim.SGD):
        raise ValueError(
            f"{name} cannot be captured into the compiled step: it has no "
            f"capturable option, so its step may keep state on the host "
            f"that a graph replay would never update; use AdamW or Adam "
            f"with capturable=True, or SGD")


class CudaGraphs:
    """How :class:`CompiledStep` captures and replays on the card:
    ``torch.cuda.CUDAGraph`` s sharing one memory pool (the step's graphs
    never run at once), captured on a side stream in ``thread_local``
    error mode so that the feed's and the checkpoint writer's threads,
    which stage and copy on their own streams, do not invalidate a
    capture.  It does what ``torch.cuda.graph`` does less its emptying of
    the host's pinned-memory cache, which would free the buffers a feed
    thread is staging through: the device's cache is emptied, so the
    graph's pool can take the memory the eager steps held."""

    def __init__(self):
        self._pool = None
        self._stream = None

    def reset(self) -> None:
        """Let the next capture start a new pool: a pool whose graphs are
        all gone cannot take another capture."""
        self._pool = None

    @staticmethod
    def device_leaf(leaf) -> bool:
        """Whether ``leaf`` is a tensor on the card."""
        return isinstance(leaf, torch.Tensor) and leaf.is_cuda

    def applies(self, batch) -> bool:
        """Whether ``batch`` is the card's: any leaf a CUDA tensor."""
        return any(self.device_leaf(t) for t in shapes.leaves(batch))

    def capture(self, fn: Callable[[], Any]):
        """``(graph, fn())`` with ``fn``'s work captured into the graph
        (and not run)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class _Captured(NamedTuple):
    """One signature's graph and what it needs alive while it lives: its
    static inputs and loss, the ``state.step`` increments its capture
    recorded (a replay adds them), the GroupNorm backward's scratch it
    writes, and the capture's wall seconds."""
    signature: tuple
    graph: Any
    static: Any
    static_leaves: list
    loss: torch.Tensor
    steps: int
    scratch: dict
    seconds: float


class CompiledStep:
    """``step(state, batch) -> (state, loss)``, compiled per batch
    signature (``shapes.signature``, the key of jit's executable cache in
    the reference).  It takes the batch as the caller hands it (host
    arrays or tensors) and ``shard`` s it onto the step's device, except
    on a replay.

    On the card, a signature's first sighting runs ``step`` eagerly (a
    real step with the same kernels, and the capture's warm-up: cuDNN
    plans, the kernels' attribute and occupancy calls, lazy loads, the
    optimizer's state); its second is captured whole into one CUDA graph
    (zero-grad, forward, backward, the rank average, clip, the table
    update, ``optimizer.step()``), which is then replayed at once; later
    sightings copy the batch straight into the graph's static inputs and
    replay.  A signature seen once is never captured.  A failed capture
    raises: nothing falls back to an eager step.  On a CPU batch ``step``
    runs as it is: the CPU has no graphs.

    A replay never re-enters Python: the kernel wrappers count the
    launches they make (the eager and the capturing steps), not a
    replay's (:data:`replayed_steps` counts those steps), and ``state.step``
    gains the capture's increments here.  The loss returned is a copy: a
    replay overwrites the graph's own.  :meth:`reset` drops every graph (a
    restore may have replaced tensors they read).  CUDA graphs cannot be
    serialised: each process captures its own.
    """

    def __init__(self, step: Callable, graphs=None,
                 shard: Callable | None = None):
        self.step = step
        self.shard = shard if shard is not None else _unchanged
        self._graphs = graphs if graphs is not None else CudaGraphs()
        #: graphs captured and replays run since construction
        self.captures = 0
        self.replays = 0
        #: what the last call did: ``"cpu"``, ``"eager"``, ``"capture"`` or
        #: ``"replay"``
        self.last = None
        #: seconds the last call spent moving its batch in: sharding it, or
        #: copying it into a graph's static inputs
        self.input_s = 0.0
        self.reset()

    def reset(self) -> None:
        """Drop every graph and sighting: each signature starts over with
        an eager step."""
        self._sightings: dict = {}
        self._captured: dict = {}
        reset = getattr(self._graphs, "reset", None)
        if reset is not None:
            reset()

    @property
    def signatures(self) -> dict:
        """Each signature sighted since the last :meth:`reset`, with its
        sightings."""
        return dict(self._sightings)

    def graph_of(self, batch) -> _Captured | None:
        """The capture of ``batch``'s signature, or None."""
        return self._captured.get(shapes.signature(batch))

    def __call__(self, state, batch):
        t0 = time.perf_counter()
        sig, leaves = shapes.signature_and_leaves(batch)
        cap = self._captured.get(sig)
        if cap is not None:
            self._sightings[sig] += 1
            self._refresh(cap.static_leaves, leaves)
            self.input_s = time.perf_counter() - t0
            return self._replay(cap, state)
        staged = self.shard(batch)
        self.input_s = time.perf_counter() - t0
        if not self._graphs.applies(staged):
            self.last = "cpu"
            return self.step(state, staged)
        seen = self._sightings.get(sig, 0) + 1
        self._sightings[sig] = seen
        if seen == 1:
            self.last = "eager"
            return self.step(state, staged)
        return self._capture(sig, state, staged)

    def _refresh(self, static_leaves: list, leaves: list) -> None:
        """Copy a batch's ``leaves`` into the static inputs' (both in
        ``shapes.leaves`` order): host arrays through pinned memory with a
        non-blocking copy; a tensor already on the card on the current
        stream, after the default stream's work (where a feed's stager
        copies)."""
        waited = False
        for dst, src in zip(static_leaves, leaves):
            if not isinstance(src, torch.Tensor):
                src = torch.as_tensor(np.ascontiguousarray(src))
            if src.device.type == "cpu" and dst.device.type == "cuda":
                src = src.pin_memory()
            elif src.is_cuda and not waited:
                current = torch.cuda.current_stream(src.device)
                default = torch.cuda.default_stream(src.device)
                if current != default:
                    current.wait_stream(default)
                waited = True
            dst.copy_(src, non_blocking=True)

    def _capture(self, sig, state, batch):
        for path, leaf in shapes._flatten(batch):
            if not self._graphs.device_leaf(leaf):
                raise TypeError(
                    f"compile_step: batch leaf {path} is "
                    f"{getattr(leaf, 'device', type(leaf).__name__)}: a "
                    f"captured step takes every leaf on the card")
        static = _tree_map(torch.empty_like, batch)
        static_leaves = shapes.leaves(static)
        self._refresh(static_leaves, shapes.leaves(batch))
        step0 = state.step
        held: dict = {}
        t0 = time.perf_counter()
        try:
            with group_norm.capture_scratch(held):
                graph, (out_state, loss) = self._graphs.capture(
                    lambda: self.step(state, static))
        finally:
            steps, state.step = state.step - step0, step0
        if out_state is not state:
            raise TypeError("compile_step: the step must update its state "
                            "in place and return it")
        cap = _Captured(sig, graph, static, static_leaves, loss, steps, held,
                        time.perf_counter() - t0)
        self._captured[sig] = cap
        self.captures += 1
        return self._replay(cap, state, action="capture")

    def _replay(self, cap: _Captured, state, action: str = "replay"):
        global replayed_steps
        self._graphs.replay(cap.graph)
        state.step += cap.steps
        self.replays += 1
        if action == "replay":
            replayed_steps += 1
        self.last = action
        return state, cap.loss.clone()


def _unchanged(batch):
    return batch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def compile_step(step: Callable, model: torch.nn.Module | None = None,
                 optimizer=None, graphs=None,
                 shard: Callable | None = None) -> CompiledStep:
    """``step(state, batch) -> (state, loss)`` as a :class:`CompiledStep`:
    the counterpart of the reference's ``compile_step`` (``jax.jit`` with
    donation), the lower half of :func:`make_train_step`'s and of a zoo
    module's own step when a ``Trainer`` runs them.  With ``model``'s
    parameters on the card, ``optimizer`` must be capturable
    (:func:`check_capturable` raises otherwise).  ``shard(batch)`` puts a
    caller's batch on the step's device (``Trainer.shard``; unchanged when
    not given).  ``graphs`` replaces the CUDA graph backend
    (:class:`CudaGraphs`; the CPU tests pass a stand-in)."""
    params = list(model.parameters()) if model is not None else []
    if optimizer is not None and params and params[0].is_cuda:
        check_capturable(optimizer)
    return CompiledStep(step, graphs=graphs, shard=shard)
