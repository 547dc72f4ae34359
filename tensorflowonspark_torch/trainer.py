"""High-level trainer: model zoo × device × train step, one object.

Reference anchor: ``tensorflowonspark_tpu/trainer.py`` (``Trainer``: ``shard``,
``add_step_callback``, ``step``, ``predict``, ``params``, ``state``).  The
reference has no trainer of its own — every example hand-writes its loop
inside ``map_fun`` — so the repeated wiring (build the model, the
optimizer, the step, stage batches) is one class that examples and the
pipeline share.

What differs from the JAX package: one device, data parallel across
processes (``torch.distributed``, formed by the cluster bootstrap) instead
of a mesh; the default optimizer is ``torch.optim.AdamW`` with
``optax.adamw``'s defaults (``weight_decay=1e-4`` — torch's own default is
1e-2 — and decay on every parameter, norm scale and bias included, as
optax without a mask), ``capturable`` and ``fused`` on a card.  As in the
reference, a zoo module may prescribe its optimizer (``make_optimizer``)
and its own step (``make_sharded_train_step``, wide&deep's table update).

The step compiles as the reference's does, through
``parallel.train.compile_step``: on a card each batch signature's step is
captured into one CUDA graph at its second sighting and replayed after
(the first is an eager step); on the CPU it runs eagerly.  On a card the
optimizer must be capturable, or construction raises.  The step that
captures books its wall as ``compile`` in the goodput ledger, and a
restore drops the graphs.  ``compile_cache.ensure()`` runs first, so the
kernel libraries load from a fleet's shared store when one is set.

Persistence, as the reference's: :meth:`Trainer.save`/:meth:`Trainer.
restore` (one-shot), :meth:`Trainer.checkpoint` (a step-numbered cadence,
``TFOS_CKPT_EVERY_STEPS``, asynchronous by default) with
:meth:`Trainer.restore_latest` for a restart, and :meth:`Trainer.export`
(weights plus the serialized forward ``TFModel`` serves with no model
code).  A restore copies into the live tensors: the optimizer and
wide&deep's step hold them.  The step watchdog, profiler annotations and
the elastic path are not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import torch

from tensorflowonspark_torch import models as model_zoo
from tensorflowonspark_torch import util
from tensorflowonspark_torch.parallel import (create_train_state,
                                              make_eval_step, make_train_step)
from tensorflowonspark_torch.parallel import train as train_lib

logger = logging.getLogger(__name__)

#: ``optax.adamw``'s defaults, which the JAX Trainer's optimizer uses
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


class Trainer:
    """Owns the model on its device, the optimizer and the train/eval
    steps."""

    def __init__(
        self,
        model: str | Any,
        config: Any = None,
        optimizer: Any = None,
        learning_rate: float = 1e-3,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        """``optimizer``, when given, builds the optimizer from the model's
        parameters (``optimizer(params) -> torch.optim.Optimizer``): the
        parameters exist only once the trainer has built the model, where
        the reference takes a stateless optax transformation.  A zoo
        module's ``make_optimizer(config, learning_rate)`` returns such a
        factory."""
        from tensorflowonspark_torch import compile_cache, obs

        _t0_wall, _t0 = time.time(), time.perf_counter()
        # the kernel libraries' shared store (TFOS_COMPILE_CACHE_DIR), set
        # up before the first step builds or loads them
        compile_cache.ensure()
        self.device = util.select_device(device)
        if isinstance(model, str):
            self.module_lib = model_zoo.get_model(model)
            self.model_name = model
        else:
            self.module_lib = model
            self.model_name = getattr(model, "__name__", None)
        self.config = config or self.module_lib.Config.tiny()
        self.model = self.module_lib.make_model(self.config, seed=seed).to(
            self.device)
        self.model.train()
        if optimizer is None:
            # a zoo module may prescribe its own optimizer recipe
            make_opt = getattr(self.module_lib, "make_optimizer", None)
            optimizer = (make_opt(self.config, learning_rate) if make_opt
                         else _adamw(learning_rate))
        self.optimizer = optimizer(self.model.parameters())
        self.loss_fn = self.module_lib.make_loss_fn(self.model, self.config)
        self.forward_fn = self.module_lib.make_forward_fn(self.model,
                                                          self.config)
        self.state = create_train_state(self.model, self.optimizer)
        # a zoo module may supply its own step (wide&deep's table update)
        make_custom = getattr(self.module_lib, "make_sharded_train_step",
                              None)
        if make_custom is not None:
            step = make_custom(self.model, self.config, self.optimizer)
        else:
            step = make_train_step(self.loss_fn, self.optimizer, self.model)
        # one CUDA graph per batch signature on a card (raises here when
        # the optimizer cannot be captured); the step itself on the CPU.
        # It takes a batch as a caller hands it, and shards it through
        # this trainer's `shard` except on a replay
        self.train_step = train_lib.compile_step(
            step, self.model, self.optimizer,
            shard=lambda batch: self.shard(batch))
        self.eval_step = make_eval_step(self.forward_fn, self.model)
        self._step_callbacks: list = []
        self._last_step_t: float | None = None
        self._steps_done = 0
        self._ckpt_mgr = None
        self._ckpt_every = 0
        #: the step of the most recent cadence save (its write may still
        #: be in flight: ``finish_checkpoints`` waits for it)
        self.last_checkpoint_step: int | None = None
        # flight recorder: step() attributes its shard + dispatch (compute)
        # per step and commits the feed-plane record the DataFeed's
        # wait/ingest halves accumulated into — one verdict per step
        self._flight = obs.flight.recorder("feed")
        #: trace id of the most recently completed step
        self.last_step_trace_id: str | None = None
        obs.get_tracer().record(
            "trainer.init", "X", _t0_wall * 1e6,
            (time.perf_counter() - _t0) * 1e6,
            {"model": self.model_name or "custom",
             "device": str(self.device)})

    # -- stepping ------------------------------------------------------------

    def shard(self, batch):
        """Stage a host batch (a dict or list of numpy arrays or tensors)
        onto the trainer's device: pinned memory and a non-blocking copy on
        a card.  Tensors already there pass through."""
        if isinstance(batch, dict):
            return {k: util.to_device(v, self.device)
                    for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(util.to_device(v, self.device) for v in batch)
        return util.to_device(batch, self.device)

    def add_step_callback(self, fn) -> None:
        """Register ``fn(loss, examples, dt)`` to run after every step.

        ``loss`` is the device scalar — callbacks should only force it at
        publish time (see :class:`metrics.MetricsReporter`); ``dt`` is the
        wall time since the previous ``step`` call.
        """
        self._step_callbacks.append(fn)

    def step(self, batch) -> torch.Tensor:
        """One optimizer step; returns the loss (a device scalar, averaged
        over the ranks of a data-parallel group)."""
        t0 = time.perf_counter()
        # the compiled step shards the batch, or on a replay copies it
        # straight into its graph's static inputs
        self.state, loss = self.train_step(self.state, batch)
        # `compute` is the dispatch wall: the step returns before the
        # device finishes, so it understates device time until the queue
        # of launched work backs up
        shard_s = getattr(self.train_step, "input_s", 0.0)
        compute_s = time.perf_counter() - t0 - shard_s
        self._flight.add(shard=shard_s, compute=compute_s)
        from tensorflowonspark_torch.obs import ledger as ledger_mod

        # on a card the capture is the compile; the CPU's first step
        # books as the reference's does
        action = getattr(self.train_step, "last", None)
        ledger_mod.goodput().note_step(
            shard_s, compute_s,
            compile=None if action in (None, "cpu") else action == "capture")
        return self._after_step(loss, batch)

    def _after_step(self, loss, batch):
        """Wall time + examples → callbacks and the obs registry (steps and
        examples counters, step-time histogram: the per-node series
        ``TFCluster.metrics()`` rolls up)."""
        from tensorflowonspark_torch import obs

        now = time.perf_counter()
        dt = now - self._last_step_t if self._last_step_t else 0.0
        self._last_step_t = now
        n = _batch_examples(batch)
        self._steps_done += 1
        obs.counter("trainer_steps_total").inc()
        if n:
            obs.counter("trainer_examples_total").inc(n)
        if dt > 0:
            obs.histogram("trainer_step_seconds").observe(dt)
            ctx = obs.TraceContext.new()
            self.last_step_trace_id = ctx.trace_id
            obs.get_tracer().record(
                "trainer.step", "X", (time.time() - dt) * 1e6, dt * 1e6,
                {"step": self._steps_done},
                trace_id=ctx.trace_id, span_id=ctx.span_id)
        obs.gauge("trainer_last_step_unix_ts").set(time.time())
        self._flight.commit()
        self._maybe_checkpoint()
        for cb in self._step_callbacks:
            cb(loss, n, dt)
        return loss

    def predict(self, batch):
        """The model's forward on ``batch`` without autograd (no output
        requires grad), reading its collections as they stand: the
        wide&deep tables, BatchNorm's running statistics (the eval
        forward never updates them)."""
        return self.eval_step(self.shard(batch))

    @property
    def params(self) -> dict:
        return self.state.params

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the full train state (``parallel.train.state_tree``) to
        ``path`` now."""
        from tensorflowonspark_torch import ckpt

        ckpt.save_pytree(train_lib.state_tree(self.state), path)

    def restore(self, path: str) -> None:
        """Load a state written by :meth:`save` (or a checkpoint step) into
        this trainer's live tensors and optimizer."""
        from tensorflowonspark_torch import ckpt

        train_lib.load_state_tree(self.state, ckpt.load_pytree(path))
        self._drop_graphs()

    def _drop_graphs(self) -> None:
        """Drop the compiled step's graphs: a restore may have replaced
        tensors they read (``optimizer.load_state_dict``)."""
        reset = getattr(self.train_step, "reset", None)
        if reset is not None:
            reset()

    def checkpoint(self, directory: str, every_steps: int | None = None,
                   max_to_keep: int = 3, async_save: bool = True):
        """Enable periodic step-numbered checkpoints (restart tolerance).

        Every ``every_steps`` completed steps (default: the
        ``TFOS_CKPT_EVERY_STEPS`` env, 0 = manual only) the full train
        state is saved through a :class:`ckpt.CheckpointManager`:
        asynchronous by default, so the step pays the snapshot (a clone
        on the device's stream, into buffers reserved here) and the write
        runs behind; ``latest_step`` only ever names committed
        checkpoints, so a crash mid-write costs nothing.  Returns the
        manager."""
        from tensorflowonspark_torch import ckpt

        if every_steps is None:
            env = os.environ.get("TFOS_CKPT_EVERY_STEPS", "")
            every_steps = int(env) if env else 0
        self._ckpt_every = max(0, int(every_steps))
        self._ckpt_mgr = ckpt.CheckpointManager(
            directory, max_to_keep=max_to_keep, async_save=async_save)
        if self._ckpt_every > 0:
            self._ckpt_mgr.reserve(train_lib.state_tree(self.state))
        return self._ckpt_mgr

    def _maybe_checkpoint(self) -> None:
        if self._ckpt_mgr is None or self._ckpt_every <= 0:
            return
        if self._steps_done % self._ckpt_every:
            return
        from tensorflowonspark_torch.obs import ledger as ledger_mod

        step = int(self.state.step)
        t0 = time.perf_counter()
        self._ckpt_mgr.save(step, train_lib.state_tree(self.state))
        # the snapshot is the step path's checkpoint cost; the write is not
        ledger_mod.goodput().note_checkpoint(time.perf_counter() - t0)
        self.last_checkpoint_step = step

    def restore_latest(self) -> int | None:
        """Restore the newest committed checkpoint of :meth:`checkpoint`'s
        directory into this trainer; returns its step, or None when there
        is none yet."""
        if self._ckpt_mgr is None:
            raise RuntimeError("checkpoint() was never enabled")
        step = self._ckpt_mgr.latest_step()
        if step is None:
            return None
        train_lib.load_state_tree(self.state, self._ckpt_mgr.restore(step))
        self._drop_graphs()
        return step

    def finish_checkpoints(self) -> None:
        """Wait for in-flight checkpoint writes (the last snapshot must
        commit before the process lets go)."""
        if self._ckpt_mgr is not None:
            self._ckpt_mgr.wait_until_finished()

    def export(self, export_dir: str, *, self_describing: bool = True) -> str:
        """Write a serving export: ``params`` plus the serving collections
        and, by default, the serialized forward and its signature
        (``saved_model``), which ``TFModel`` serves with no model code.
        Optimizer-only collections (suffix ``_opt``: the AdaGrad
        accumulators) are stripped, as the reference's ``Trainer.export``
        does.  The forward is the zoo module's ``serving_forward`` over
        its ``make_serving_model`` (built on the ``meta`` device), traced
        at an example batch of 2.  ``self_describing=False`` writes the
        weights only.  Returns the weights' path."""
        from tensorflowonspark_torch import compat, saved_model, shapes

        state = self.module_lib.state_of(self.model)
        serving = {k: v for k, v in state.pop("collections", {}).items()
                   if not k.endswith("_opt")}
        if serving:
            state["collections"] = serving
        if not self_describing:
            return compat.export_saved_model(state, export_dir)
        example = {k: v for k, v in self.module_lib.example_batch(
            self.config, batch_size=2).items() if k not in shapes.LABEL_KEYS}
        serve = saved_model.wrap_state_forward(
            self.module_lib.serving_forward,
            self.module_lib.make_serving_model(self.config))
        return compat.export_saved_model(
            state, export_dir, forward_fn=serve, example_batch=example,
            model_name=self.model_name)


def _adamw(learning_rate: float):
    def optimizer(params):
        params = list(params)
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=ADAMW_BETAS, eps=ADAMW_EPS,
            weight_decay=ADAMW_WEIGHT_DECAY, **card_adamw(params))

    return optimizer


def on_card(params) -> bool:
    """Whether ``params`` (a list of tensors) lie on a card."""
    return bool(params) and params[0].is_cuda


def card_adamw(params) -> dict:
    """AdamW's options for ``params``: on a card ``capturable`` (its step
    count on the device, which the compiled step's graphs need) and
    ``fused`` (one kernel a tensor list: the faster of the two capturable
    implementations on an H100, ``chip_smoke.py`` phase 16(e)); on the CPU
    the default ``foreach`` implementation."""
    card = on_card(params)
    return {"capturable": card, "fused": True if card else None}


def _batch_examples(batch) -> int:
    """Leading-dim size of the first array leaf (examples in the batch)."""
    leaves = (batch.values() if isinstance(batch, dict)
              else batch if isinstance(batch, (list, tuple)) else [batch])
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape:
            return int(shape[0])
    return 0
