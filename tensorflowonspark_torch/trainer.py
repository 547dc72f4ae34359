"""High-level trainer: model zoo × device × train step, one object.

Reference anchor: ``tensorflowonspark_tpu/trainer.py`` (``Trainer``: ``shard``,
``add_step_callback``, ``step``, ``predict``, ``params``, ``state``).  The
reference has no trainer of its own — every example hand-writes its loop
inside ``map_fun`` — so the repeated wiring (build the model, the
optimizer, the step, stage batches) is one class that examples and the
pipeline share.

What differs from the JAX package: one device, data parallel across
processes (``torch.distributed``, formed by the cluster bootstrap) instead
of a mesh; the step runs eagerly (no compile); the default optimizer is
``torch.optim.AdamW`` with ``optax.adamw``'s defaults (``weight_decay=1e-4``
— torch's own default is 1e-2 — and decay on every parameter, norm scale
and bias included, as optax without a mask).  Checkpoints, export, the
step watchdog, profiler annotations and the elastic path are not ported
yet.
"""

from __future__ import annotations

import logging
import time
from typing import Any

import torch

from tensorflowonspark_torch import models as model_zoo
from tensorflowonspark_torch import util
from tensorflowonspark_torch.parallel import (create_train_state,
                                              make_eval_step, make_train_step)

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
        the reference takes a stateless optax transformation."""
        from tensorflowonspark_torch import obs

        _t0_wall, _t0 = time.time(), time.perf_counter()
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
            def optimizer(params):
                return torch.optim.AdamW(
                    params, lr=learning_rate, betas=ADAMW_BETAS,
                    eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
        self.optimizer = optimizer(self.model.parameters())
        self.loss_fn = self.module_lib.make_loss_fn(self.model, self.config)
        self.forward_fn = self.module_lib.make_forward_fn(self.model,
                                                          self.config)
        self.state = create_train_state(self.model, self.optimizer)
        self.train_step = make_train_step(self.loss_fn, self.optimizer,
                                          self.model)
        self.eval_step = make_eval_step(self.forward_fn, self.model)
        self._step_callbacks: list = []
        self._last_step_t: float | None = None
        self._steps_done = 0
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
        staged = self.shard(batch)
        t1 = time.perf_counter()
        self.state, loss = self.train_step(self.state, staged)
        # `compute` is the dispatch wall: the step returns before the
        # device finishes, so it understates device time until the queue
        # of launched work backs up
        compute_s = time.perf_counter() - t1
        self._flight.add(shard=t1 - t0, compute=compute_s)
        from tensorflowonspark_torch.obs import ledger as ledger_mod

        ledger_mod.goodput().note_step(t1 - t0, compute_s)
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
        for cb in self._step_callbacks:
            cb(loss, n, dt)
        return loss

    def predict(self, batch):
        return self.eval_step(self.shard(batch))

    @property
    def params(self) -> dict:
        return self.state.params


def _batch_examples(batch) -> int:
    """Leading-dim size of the first array leaf (examples in the batch)."""
    leaves = (batch.values() if isinstance(batch, dict)
              else batch if isinstance(batch, (list, tuple)) else [batch])
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape:
            return int(shape[0])
    return 0
