"""Export for serving.

Reference anchor: ``tensorflowonspark_tpu/compat.py::export_saved_model``.
The port writes the weights-only form: ``export_dir/model`` through
:mod:`tensorflowonspark_torch.ckpt`, served by ``TFModel`` with a
``model_name`` that rebuilds the forward.  The reference's self-describing
serialized forward is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Mapping


def export_saved_model(model_state: Mapping[str, Any], export_dir: str) -> str:
    """Write ``model_state`` (e.g. ``resnet.state_of(model)``) under
    ``export_dir/model``; returns that path."""
    from tensorflowonspark_torch import ckpt

    return ckpt.save_pytree(model_state, os.path.join(export_dir, "model"))
