"""Export for serving.

Reference anchor: ``tensorflowonspark_tpu/compat.py::export_saved_model``
(TF SavedModel there).  The port writes the weights under
``export_dir/model`` through :mod:`tensorflowonspark_torch.ckpt` and, given
a ``forward_fn`` and an ``example_batch``, the self-describing serialized
forward beside them (:mod:`tensorflowonspark_torch.saved_model`), which
``TFModel`` serves with no model code.  A weights-only export stays valid:
its consumers rebuild the forward by ``model_name`` or ``predict_fn``.
"""

from __future__ import annotations

from typing import Any, Mapping


def export_saved_model(model_state: Mapping[str, Any], export_dir: str, *,
                       forward_fn=None, example_batch=None,
                       model_name: str | None = None) -> str:
    """Write ``model_state`` (e.g. ``resnet.state_of(model)``) under
    ``export_dir/model`` and, with ``forward_fn``, its serialized forward;
    returns the weights' path.

    ``forward_fn`` has the canonical serving signature ``f(model_state,
    batch_dict) -> outputs`` (adapt a zoo forward with
    ``saved_model.wrap_state_forward``); ``example_batch`` is a dict of
    input name → array with a leading batch dimension."""
    from tensorflowonspark_torch import ckpt, fs

    if forward_fn is not None and example_batch is None:
        raise ValueError(
            "export_saved_model(forward_fn=...) needs example_batch to "
            "record the serving signature")
    path = ckpt.save_pytree(model_state, fs.join(export_dir, "model"))
    if forward_fn is not None:
        from tensorflowonspark_torch import saved_model

        saved_model.export_forward(
            forward_fn, model_state, example_batch, export_dir,
            model_name=model_name)
    return path
