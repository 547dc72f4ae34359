"""In-process inference endpoint for the C-ABI / JNI shim.

Reference anchor: ``tensorflowonspark_tpu/infer_embed.py``.  The
reference's ``libtfos_infer.so`` (``native/tfos_infer.cc``) embeds a
CPython interpreter and calls the functions below, and a JVM loads it
through the JNI wrapper; that shim is not ported yet, so here this module
is the Python half alone.

The call protocol mirrors TF-Java's ``Session.Runner``: ``load`` →
``set_input``×N → ``run`` → ``get_output``.  All state lives in an integer
handle registry so the C side never holds Python object pointers.

A handle loads through ``pipeline._RunModel._load``: the export's
serialized forward when it has one, the zoo's ``model_name`` forward
otherwise, on ``util.select_device()``'s device (the card unless
``TFOS_TORCH_DEVICE`` asks for the CPU).  Each batch is staged onto that
device and runs through the model's captured forward
(``serving.captured``): on the card each signature is one CUDA graph,
captured at its second sighting.

Multi-output models serve every named output: after ``run``,
``output_count``/``output_name`` enumerate the flattened output names (the
signature's declared order first) and ``output_shape``/``get_output`` accept
a name (``""`` = the first declared output).

Dtype contract: every output is served as **float32** (the C ABI's buffer
type, matching TF-Java's float fetch convention; bf16 outputs widen
exactly).  Integer outputs above 2^24 would lose exactness — serve those
through the Python ``TFModel`` path, which preserves dtypes.
"""

from __future__ import annotations

import itertools
import logging
import threading
from typing import Any

import numpy as np

logger = logging.getLogger(__name__)

_HANDLES: dict[int, dict[str, Any]] = {}
_NEXT = itertools.count(1)
_LOCK = threading.Lock()

#: dtype codes of the C ABI (tfos_infer.h)
_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64}


def load(export_dir: str, model_name: str = "") -> int:
    """Load an export and its forward; returns a handle.

    A self-describing export serves from the artifact alone and
    ``model_name`` is ignored; a weights-only export rebuilds the forward
    from the ``model_name`` zoo entry at the config its shapes imply.
    """
    from tensorflowonspark_torch import pipeline, saved_model, serving, shapes

    serialized = saved_model.has_forward(export_dir)
    if not serialized and not model_name:
        raise ValueError(
            f"export at {export_dir} is weights-only (no saved_forward/) "
            "— a model_name is required to rebuild the forward")
    runner = pipeline._RunModel(
        export_dir=export_dir, model_name=model_name or None,
        predict_fn=None, batch_size=1, input_mapping=None,
        output_mapping=None, columns=[])
    forward = runner.captured()
    output_order: list[str] | None = None
    if runner._signature is not None:
        sig = runner._signature
        input_names = [i["name"] for i in sig["inputs"]]
        output_order = [o["name"] for o in sig["outputs"]]
    else:
        from tensorflowonspark_torch import models as model_zoo

        lib = model_zoo.get_model(model_name)
        config = lib.config_from_state(runner._export_specs)
        # input names from the zoo's example batch, labels stripped
        example = lib.example_batch(config, batch_size=1)
        input_names = [k for k in example if k not in shapes.LABEL_KEYS]

    with _LOCK:
        h = next(_NEXT)
        _HANDLES[h] = {
            "forward": forward,
            "stage": serving.stager(runner._device),
            "input_names": input_names,
            "output_order": output_order,
            "inputs": {},
            "outputs": None,  # ordered {name: float32 array} after run()
        }
    logger.info("infer_embed: loaded %s as handle %d on %s (inputs %s)",
                export_dir, h, runner._device, input_names)
    return h


def input_names(handle: int) -> str:
    """Comma-joined input tensor names (C side exposes for discovery)."""
    return ",".join(_HANDLES[handle]["input_names"])


def set_input(handle: int, name: str, data: bytes, shape: tuple,
              dtype_code: int) -> None:
    # a writable copy: the caller's buffer may be read-only (bytes), and
    # torch.from_numpy warns on those
    arr = np.frombuffer(data, _DTYPES[dtype_code]).reshape(shape).copy()
    st = _HANDLES[handle]
    if name == "" and len(st["input_names"]) == 1:
        name = st["input_names"][0]  # single-input convenience
    if name not in st["input_names"]:
        raise KeyError(
            f"unknown input {name!r}; model inputs are {st['input_names']}")
    st["inputs"][name] = arr


def _flatten_named(out) -> dict[str, np.ndarray]:
    """Model output (tensor | tuple | nested dict) → ordered {name:
    float32 host array}.

    Names follow the export signature's convention
    (``saved_model._leaf_name``): '/'-joined dict-key paths for nested
    dicts, positional ``output_i`` for a bare tensor, stringified indices
    for tuple members; mapping insertion order is kept (the "first
    declared output" the C ABI's single-output convention depends on)."""
    from collections.abc import Mapping as _Mapping

    from tensorflowonspark_torch import serving

    named: dict[str, np.ndarray] = {}

    def rec(prefix: tuple, val) -> None:
        if isinstance(val, _Mapping):
            for k, v in val.items():
                rec(prefix + (str(k),), v)
        elif isinstance(val, (list, tuple)):
            for i, v in enumerate(val):
                rec(prefix + (str(i),), v)
        else:
            name = "/".join(prefix) if prefix else f"output_{len(named)}"
            named[name] = np.asarray(serving.to_host(val), dtype=np.float32)

    rec((), out)
    return named


def run(handle: int) -> None:
    """Score the inputs set since the last ``run``.

    Bucketed batch shapes (the serving data plane's): repeated calls with
    drifting batch sizes pad to the next power of two, so the forward sees
    O(log n) signatures (O(log n) graphs on the card).  Padding is
    evidence-gated per handle: slicing padded rows off is valid only for
    a per-example forward, so calls run at their true shape until
    per-example outputs have been seen at TWO distinct batch sizes (a
    batch-aggregating output has a fixed size, which can coincide with at
    most one batch size); an aggregating forward keeps exact shapes and
    exact results.  ``TFOS_INFER_BUCKETS=0`` opts out."""
    import os
    import time as _time

    from tensorflowonspark_torch import serving, shapes

    st = _HANDLES[handle]
    missing = [n for n in st["input_names"] if n not in st["inputs"]]
    if missing:
        raise ValueError(f"inputs not set before run: {missing}")
    batch = dict(st["inputs"])
    bucketed = os.environ.get("TFOS_INFER_BUCKETS", "1").strip().lower() \
        not in ("0", "false")
    n_real = bucket = 0
    fresh = False
    key = ("infer_embed", handle)
    if bucketed:
        n_real = shapes.batch_rows(batch)
        bucket = shapes.pow2_bucket(n_real) if n_real > 0 else 0
        if bucket > n_real and (st.get("per_example") is not False
                                and len(st.get("per_example_sizes",
                                               ())) >= 2):
            batch = serving.pad_columns(batch, bucket)
        else:
            # not enough evidence yet (or evidence against): run at the
            # true shape, whose output shapes feed the evidence
            bucket = n_real
    staged = st["stage"](batch)
    if bucketed:
        fresh = serving.note_compile(key, staged)
    t0 = _time.perf_counter()
    named = st["forward"](staged, take=_flatten_named)
    if fresh:
        # _flatten_named copied every output to the host: this wall
        # carries the signature's first call
        serving.observe_compile_seconds(_time.perf_counter() - t0)
    if bucketed and n_real > 0:
        padded = bucket > n_real
        per_example = all(v.ndim >= 1 and v.shape[0] == bucket
                          for v in named.values())
        if padded and not per_example:
            # the evidence that enabled padding was wrong: rerun at the
            # true shape and disable bucketing for this handle
            logger.warning(
                "handle %d: padded run produced non-per-example outputs; "
                "rerunning at the true batch size and disabling bucketing "
                "for this handle", handle)
            st["per_example"] = False
            true_batch = st["stage"](dict(st["inputs"]))
            refresh = serving.note_compile(key, true_batch)
            t1 = _time.perf_counter()
            named = st["forward"](true_batch, take=_flatten_named)
            if refresh:
                serving.observe_compile_seconds(_time.perf_counter() - t1)
        elif padded:
            # the mask half of pad-and-mask
            named = {k: v[:n_real] for k, v in named.items()}
        elif per_example:
            st.setdefault("per_example_sizes", set()).add(n_real)
        else:
            st["per_example"] = False
    order = st.get("output_order")
    if order:
        # the signature's declared order wins; anything it doesn't name
        # trails in flatten order
        ordered = {n: named[n] for n in order if n in named}
        ordered.update((n, v) for n, v in named.items() if n not in ordered)
        named = ordered
    st["outputs"] = named
    st["inputs"] = {}


def _resolve_output(handle: int, name: str = "") -> np.ndarray:
    st = _HANDLES[handle]
    outputs = st.get("outputs")
    if not outputs:
        raise ValueError("run() has not produced an output")
    if name == "":
        return next(iter(outputs.values()))  # first *declared* output
    if name not in outputs:
        raise KeyError(
            f"unknown output {name!r}; model outputs are {list(outputs)}")
    return outputs[name]


def output_count(handle: int) -> int:
    return len(_HANDLES[handle].get("outputs") or ())


def output_name(handle: int, index: int) -> str:
    outputs = _HANDLES[handle].get("outputs")
    if not outputs:
        raise ValueError("run() has not produced an output")
    names = list(outputs)
    if not 0 <= index < len(names):
        raise IndexError(f"output index {index} out of range "
                         f"({len(names)} outputs)")
    return names[index]


def output_shape(handle: int, name: str = "") -> tuple:
    return tuple(_resolve_output(handle, name).shape)


def get_output(handle: int, name: str = "") -> bytes:
    out = _resolve_output(handle, name)
    return np.ascontiguousarray(out, dtype=np.float32).tobytes()


def close(handle: int) -> None:
    from tensorflowonspark_torch import serving

    serving.forget(("infer_embed", handle))
    with _LOCK:
        _HANDLES.pop(handle, None)
