"""Training step and the multi-process runtime of the port.

- :mod:`.train` — ``TrainState``, ``create_train_state``,
  ``make_train_step``, ``make_eval_step`` (reference:
  ``tensorflowonspark_tpu/parallel/train.py``), data parallel only.
- :mod:`.distributed` — ``torch.distributed`` initialised from the
  rendezvous (reference: ``tensorflowonspark_tpu/parallel/distributed.py``).
"""

from tensorflowonspark_torch.parallel.train import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
