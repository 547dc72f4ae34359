"""Training step and the multi-process runtime of the port.

- :mod:`.train` — ``TrainState``, ``create_train_state``,
  ``make_train_step``, ``compile_step`` (one CUDA graph per batch
  signature on a card), ``make_eval_step`` (reference:
  ``tensorflowonspark_tpu/parallel/train.py``), data parallel only.
- :mod:`.distributed` — ``torch.distributed`` initialised from the
  rendezvous (reference: ``tensorflowonspark_tpu/parallel/distributed.py``).
"""

from tensorflowonspark_torch.parallel.train import (  # noqa: F401
    TrainState,
    compile_step,
    create_train_state,
    make_eval_step,
    make_train_step,
)
