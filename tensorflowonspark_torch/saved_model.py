"""Self-describing model exports: serialized forward + signature + weights.

Reference anchor: ``tensorflowonspark_tpu/saved_model.py``.  A TF
SavedModel carries graph, weights and a signature, and serving resolves
its inputs and outputs from the artifact alone; the JAX package writes the
forward as StableHLO through ``jax.export``.  The port writes it as a
``torch.export`` program:

    model/                        weights (``ckpt.save_pytree``)
    saved_forward/forward.pt2     ``torch.export.save`` of the forward
    saved_forward/signature.json  inputs, outputs, batch mode, export id

The program has the reference's serving signature ``serve(state, batch)
-> outputs``: ``state`` is the tree stored in ``model/`` and ``batch`` a
dict of input name → array.  The state is an input, so the program holds
no weights: a zoo forward is bound to a model built on the ``meta``
device with ``torch.func.functional_call`` (:func:`wrap_state_forward`),
and the example inputs ``torch.export`` keeps are dropped before the
write.  Dict keys are sorted on both sides (an exported program pins the
order of its inputs' keys).

The batch dimension is exported as ``torch.export.Dim("b")`` when the
forward traces under a symbolic batch; otherwise a fixed-batch program is
written and :func:`load_forward` chunk-pads to its size (the reference's
semantics).  Export with a batch of 2 or more: torch specializes sizes 0
and 1.

Devices: a program records the devices it was traced on (``arange``'s
``device=``, the metadata asserts of ``.to``).  :func:`load_forward` moves
the program to the serving device (``torch.export.passes.
move_to_device_pass``), so an export written in a CPU process serves on
the card and the other way round (``platforms: ["cpu", "cuda"]``).  The
GroupNorm of the ResNet runs as ``torch.ops.tfos.group_norm_act``
(``kernels.group_norm.group_norm_act_op``), which dispatches at run time:
the plain version on the CPU, the kernel on the card; BERT's attention
runs as ``torch.ops.tfos.bert_attention`` (``models.bert.attention_op``):
the plain version on the CPU, SDPA on the card.
"""

from __future__ import annotations

import io
import json
import logging
from typing import Any, Callable, Mapping

import numpy as np
import torch

from tensorflowonspark_torch import fs

logger = logging.getLogger(__name__)

FORMAT = "tfos-torch-export-v1"
#: where any export serves (``load_forward`` moves it to the device)
PLATFORMS = ("cpu", "cuda")
_SUBDIR = "saved_forward"
_FORWARD_FILE = "forward.pt2"
_SIGNATURE_FILE = "signature.json"


def _sorted_tree(tree):
    """Mappings → plain dicts with sorted keys, recursively."""
    if isinstance(tree, Mapping):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _as_tensor(leaf, device=None, dtype=None) -> torch.Tensor:
    t = (leaf if isinstance(leaf, torch.Tensor)
         else torch.as_tensor(np.asarray(leaf)))
    if device is not None or dtype is not None:
        t = t.to(device=device, dtype=dtype)
    return t


def _tensor_tree(tree, device=None):
    if isinstance(tree, Mapping):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    return _as_tensor(tree, device)


def state_on_device(state, device) -> dict:
    """The export state (numpy, as ``ckpt.load_pytree`` returns it) as
    tensors on ``device``, keys sorted: what the loaded forward takes."""
    return _tensor_tree(_sorted_tree(state), torch.device(device))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_name(keypath, index: int) -> str:
    """Canonical output-leaf name: '/'-joined dict-key path, or positional
    ``output_i`` for bare/tuple outputs."""
    if keypath:
        return "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
    return f"output_{index}"


def _flatten_outputs(out) -> list[tuple[str, Any]]:
    from torch.utils import _pytree

    return [(_leaf_name(kp, i), leaf) for i, (kp, leaf) in
            enumerate(_pytree.tree_flatten_with_path(out)[0])]


class _Apply(torch.nn.Module):
    """``forward(model, batch)`` as a module, so ``functional_call`` can
    bind the model's tensors under the name ``model.<name>``."""

    def __init__(self, model: torch.nn.Module, forward: Callable):
        super().__init__()
        self.model = model
        self._forward = forward

    def forward(self, batch):
        return self._forward(self.model, batch)


def wrap_state_forward(forward: Callable,
                       model: torch.nn.Module | None = None) -> Callable:
    """Adapt a forward to the canonical ``serve(state, batch)``.

    ``state`` is ``{"params": ..., "collections": ...}``, ``{"params":
    ...}`` or a bare params tree.  With ``model`` (a zoo module, typically
    built on the ``meta`` device), ``forward(model, batch)`` runs with the
    model's parameters and buffers taken from ``params`` and the leaves of
    every collection, by name (``torch.func.functional_call``): the
    program then reads its weights from the state, not from the model.
    Without one, ``forward(params, batch)`` — or, tagged
    ``forward.stateful``, ``forward(params, collections, batch)`` — as in
    the reference."""
    stateful = bool(getattr(forward, "stateful", False))
    apply = _Apply(model, forward) if model is not None else None

    def serve(state, batch):
        if isinstance(state, Mapping) and "params" in state:
            params = state["params"]
            collections = state.get("collections") or {}
        else:
            params, collections = state, {}
        if apply is not None:
            tensors = {f"model.{k}": v for k, v in params.items()}
            for leaves in collections.values():
                tensors.update((f"model.{k}", v) for k, v in leaves.items())
            return torch.func.functional_call(apply, tensors, (batch,),
                                              strict=False)
        if stateful:
            return forward(params, collections, batch)
        return forward(params, batch)

    return serve


class _Serve(torch.nn.Module):
    def __init__(self, forward_fn: Callable):
        super().__init__()
        self._forward_fn = forward_fn

    def forward(self, state, batch):
        return self._forward_fn(state, batch)


def _dynamic_shapes(state, batch, dim) -> tuple:
    from torch.utils import _pytree

    return (_pytree.tree_map(lambda _: None, state),
            {k: ({0: dim} if v.dim() >= 1 else None)
             for k, v in batch.items()})


def export_forward(
    forward_fn: Callable[[Any, dict], Any],
    state: Any,
    example_batch: Mapping[str, Any],
    export_dir: str,
    *,
    model_name: str | None = None,
    poly_batch: bool = True,
) -> str:
    """Serialize ``forward_fn(state, batch)`` + signature under
    ``export_dir``; returns the ``saved_forward`` path.

    ``state`` is the tree the weights checkpoint holds (numpy or tensors:
    only shapes and dtypes are read); ``example_batch`` a dict of input
    name → array with a leading batch dimension.  A symbolic batch is
    tried first; a forward that does not trace under one gets a
    fixed-batch program (recorded in the signature; the loader
    chunk-pads).  The trace and the write are timed apart in the log."""
    import time
    import uuid

    from tensorflowonspark_torch import obs

    state_t = _tensor_tree(_sorted_tree(state))
    batch_t = _tensor_tree(_sorted_tree(example_batch))
    fixed_batch = next(int(v.shape[0]) for v in batch_t.values() if v.dim())
    module = _Serve(forward_fn)
    # torch.export specializes a dimension of size 1, so a one-row example
    # would never trace a symbolic batch: that attempt takes two rows
    poly_t = {k: (v.expand(2, *v.shape[1:]).contiguous()
                  if v.dim() and v.shape[0] == 1 else v)
              for k, v in batch_t.items()}
    attempts = ([("polymorphic", torch.export.Dim("b"), poly_t)]
                if poly_batch else []) + [(fixed_batch, None, batch_t)]

    t0 = time.perf_counter()
    program, batch_mode, last_err = None, None, None
    with obs.span("saved_model.trace", export_dir=export_dir):
        for mode, dim, inputs in attempts:
            try:
                program = torch.export.export(
                    module, (state_t, inputs),
                    dynamic_shapes=(_dynamic_shapes(state_t, inputs, dim)
                                    if dim is not None else None))
                batch_mode = mode
                break
            except Exception as e:  # a symbolic batch is best-effort
                last_err = e
                if mode == "polymorphic":
                    logger.info("polymorphic-batch export failed (%s); "
                                "retrying with fixed batch %d", e,
                                fixed_batch)
    if program is None:
        raise RuntimeError(
            f"could not serialize forward for {export_dir}") from last_err
    trace_s = time.perf_counter() - t0
    # the example inputs hold the state: the program must not carry them
    program.example_inputs = None

    outputs = _output_entries(program)
    _annotate_batched(outputs, batch_mode, forward_fn, state_t, batch_t,
                      fixed_batch)

    def _input_entry(name, arr):
        t = _as_tensor(arr)
        shape = [int(d) for d in t.shape]
        if batch_mode == "polymorphic" and t.dim() >= 1:
            shape[0] = None
        return {"name": name, "shape": shape, "dtype": _dtype_name(t.dtype)}

    signature = {
        "format": FORMAT,
        "model_name": model_name,
        "batch": batch_mode,
        "inputs": [_input_entry(name, arr)
                   for name, arr in example_batch.items()],
        "outputs": outputs,
        "platforms": list(PLATFORMS),
        # fresh per export: a remote path has no trustworthy mtime, so the
        # executors' model cache fingerprints the signature bytes, and
        # this id makes a re-export to the same path read differently
        "export_id": uuid.uuid4().hex,
    }

    t1 = time.perf_counter()
    sub = fs.join(export_dir, _SUBDIR)
    with obs.span("saved_model.write", export_dir=export_dir):
        blob = io.BytesIO()
        torch.export.save(program, blob)
        fs.makedirs(sub)
        with fs.open(fs.join(sub, _FORWARD_FILE), "wb") as f:
            f.write(blob.getvalue())
        with fs.open(fs.join(sub, _SIGNATURE_FILE), "wb") as f:
            f.write(json.dumps(signature, indent=1).encode())
    logger.info(
        "saved self-describing forward (%s batch, %d bytes) under %s: "
        "trace %.3f s, write %.3f s", signature["batch"],
        len(blob.getvalue()), sub, trace_s, time.perf_counter() - t1)
    return sub


def _output_entries(program) -> list[dict]:
    """Name the program's outputs (dict keys, else ``output_i``), in the
    order the forward returned them, with their shapes (``None`` for the
    symbolic batch) and dtypes."""
    from torch.utils import _pytree

    [out_node] = [n for n in program.graph.nodes if n.op == "output"]
    vals = [a.meta["val"] for a in out_node.args[0]]
    tree = _pytree.tree_unflatten(vals, program.call_spec.out_spec)
    return [{"name": name,
             "shape": [d if isinstance(d, int) else None for d in val.shape],
             "dtype": _dtype_name(val.dtype)}
            for name, val in _flatten_outputs(tree)]


def _annotate_batched(outputs: list[dict], batch_mode, forward_fn, state,
                      batch, fixed_batch: int) -> None:
    """Record per-output ``batched`` flags in the signature: what the
    fixed-batch caller concatenates across chunks and what it takes once.
    A polymorphic program shows it (the leading dim is the batch symbol);
    a fixed one is probed by running the forward on ``meta`` tensors at
    two batch sizes and marking the leaves whose leading dim followed."""
    if batch_mode == "polymorphic":
        for entry in outputs:
            entry["batched"] = bool(entry["shape"]) and entry["shape"][0] is None
        return

    def probe(n):
        meta_batch = {k: torch.empty((n, *v.shape[1:]) if v.dim() else (),
                                     dtype=v.dtype, device="meta")
                      for k, v in batch.items()}
        meta_state = _tensor_tree(state, "meta")
        with torch.no_grad():
            return dict(_flatten_outputs(forward_fn(meta_state, meta_batch)))

    try:
        s1, s2 = probe(fixed_batch), probe(fixed_batch + 1)
    except Exception as e:
        logger.info("could not probe output batch dims (%s); fixed-batch "
                    "serving will fall back to the shape heuristic", e)
        return
    for entry in outputs:
        a, b = s1.get(entry["name"]), s2.get(entry["name"])
        if a is not None and b is not None:
            entry["batched"] = bool(
                a.dim() and b.dim() and a.shape[0] == fixed_batch
                and b.shape[0] == fixed_batch + 1)


def read_signature(export_dir: str) -> dict:
    """Load ``signature.json``; raises FileNotFoundError when the export is
    weights-only."""
    path = fs.join(export_dir, _SUBDIR, _SIGNATURE_FILE)
    if not fs.exists(path):
        raise FileNotFoundError(f"no {_SIGNATURE_FILE} under {export_dir}")
    with fs.open(path, "rb") as f:
        return json.loads(f.read().decode())


def has_forward(export_dir: str) -> bool:
    return fs.exists(fs.join(export_dir, _SUBDIR, _FORWARD_FILE))


def signature_fingerprint(export_dir: str) -> str | None:
    """Cache-invalidation token of an export: SHA-1 of the signature JSON
    bytes (which embed a per-export ``export_id``); ``None`` for a
    weights-only export."""
    import hashlib

    path = fs.join(export_dir, _SUBDIR, _SIGNATURE_FILE)
    try:
        with fs.open(path, "rb") as f:
            return hashlib.sha1(f.read()).hexdigest()
    except (FileNotFoundError, OSError):
        return None


def pad_batch(batch: Mapping[str, Any], target: int) -> dict:
    """Zero-pad every array's leading (batch) axis out to ``target`` rows.

    The one padding convention of the serving stack, shared by the
    fixed-batch caller below (chunk tails) and the bucketed serving data
    plane (``serving.pad_columns``).  Arrays (numpy, or tensors, padded on
    their device) already ≥ ``target`` rows, and 0-d inputs, which carry
    no batch axis, pass through unchanged."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            if v.dim() >= 1 and v.shape[0] < target:
                v = torch.cat([v, v.new_zeros((target - v.shape[0],
                                               *v.shape[1:]))])
        else:
            v = np.asarray(v)
            if v.ndim >= 1 and v.shape[0] < target:
                v = np.pad(v, [(0, target - v.shape[0])]
                           + [(0, 0)] * (v.ndim - 1))
        out[k] = v
    return out


def load_forward(export_dir: str, device: str | torch.device | None = None):
    """Deserialize the saved forward onto ``device`` (``util.
    select_device``'s rule: the card unless the caller asks for the CPU).
    Returns ``(fn, signature)`` with ``fn(state, batch) -> outputs``,
    run under ``torch.inference_mode``: ``state`` as ``ckpt.load_pytree``
    returns it (or :func:`state_on_device`'s tensors, which it then does
    not copy), ``batch`` numpy or tensors, each input cast to the
    signature's dtype.  Raises FileNotFoundError when the export carries
    no serialized forward (the caller serves by ``model_name`` or
    ``predict_fn``)."""
    from torch.export.passes import move_to_device_pass

    from tensorflowonspark_torch import util
    # registers torch.ops.tfos.*, which the program calls
    from tensorflowonspark_torch.kernels import group_norm  # noqa: F401
    from tensorflowonspark_torch.models import bert  # noqa: F401

    signature = read_signature(export_dir)
    blob_path = fs.join(export_dir, _SUBDIR, _FORWARD_FILE)
    if not fs.exists(blob_path):
        raise FileNotFoundError(f"no {_FORWARD_FILE} under {export_dir}")
    with fs.open(blob_path, "rb") as f:
        program = torch.export.load(io.BytesIO(f.read()))
    dev = util.select_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    module = move_to_device_pass(program, str(dev)).module()
    dtypes = {e["name"]: getattr(torch, e["dtype"])
              for e in signature["inputs"]}

    def call(state, batch):
        inputs = {k: _as_tensor(batch[k], dev, dtypes[k])
                  for k in sorted(dtypes)}
        with torch.inference_mode():
            return module(_tensor_tree(_sorted_tree(state), dev), inputs)

    mode = signature.get("batch")
    fn = (call if mode == "polymorphic"
          else _fixed_batch_caller(call, int(mode), signature))
    return fn, signature


def _fixed_batch_caller(call: Callable, fixed: int,
                        signature: Mapping | None = None) -> Callable:
    """Serve any batch size against a fixed-batch program: chunks of
    ``fixed`` rows (the tail zero-padded, :func:`pad_batch`), the outputs
    concatenated and cut back to the true length.  Which outputs are
    per-example comes from the signature's ``batched`` flags; a program
    without them falls back to the leading-dim heuristic."""
    from torch.utils import _pytree

    batched_by_name = {e["name"]: bool(e["batched"])
                       for e in (signature or {}).get("outputs", [])
                       if "batched" in e}

    def fn(state, batch):
        n = int(next(iter(batch.values())).shape[0])
        outs = []
        for start in range(0, max(n, 1), fixed):
            outs.append(call(state, pad_batch(
                {k: v[start:start + fixed] for k, v in batch.items()},
                fixed)))
        flat = [_pytree.tree_flatten(o)[0] for o in outs]
        names = [name for name, _ in _flatten_outputs(outs[0])]
        merged = []
        for i, leaf0 in enumerate(flat[0]):
            is_batched = batched_by_name.get(
                names[i], leaf0.dim() > 0 and leaf0.shape[0] == fixed)
            merged.append(torch.cat([f[i] for f in flat])[:n] if is_batched
                          else leaf0)
        return _pytree.tree_unflatten(merged,
                                      _pytree.tree_structure(outs[0]))

    return fn


# ---------------------------------------------------------------------------
# CLI: the `saved_model_cli show|run` parity surface
# ---------------------------------------------------------------------------


def _cli(argv=None) -> int:
    """``python -m tensorflowonspark_torch.saved_model show|run ...``: TF
    users inspect and smoke-test a SavedModel with ``saved_model_cli
    show --dir D`` / ``saved_model_cli run``; this is the same surface for
    the port's exports."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="tensorflowonspark_torch.saved_model")
    sub = p.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser("show", help="print the export's signature and "
                                         "weight leaves")
    p_show.add_argument("--dir", required=True)
    p_run = sub.add_parser("run", help="feed .npz inputs through the "
                                       "serialized forward")
    p_run.add_argument("--dir", required=True)
    p_run.add_argument("--inputs", required=True,
                       help=".npz whose arrays are keyed by input name")
    p_run.add_argument("--outputs", default=None,
                       help="optional .npz path to write outputs to")
    p_run.add_argument("--device", default=None,
                       help="cuda (default, or TFOS_TORCH_DEVICE) or cpu")
    args = p.parse_args(argv)

    if args.cmd == "show":
        from tensorflowonspark_torch.pipeline import get_meta_graph_def

        meta = get_meta_graph_def(args.dir)
        sig = meta.pop("__signature__", None)
        if sig is None:
            print("weights-only export (no serialized forward); leaves:")
        else:
            print(json.dumps(sig, indent=1))
            print("weight leaves:")
        for name, rec in meta.items():
            print(f"  {name}: {rec['dtype']}{list(rec['shape'])}")
        return 0

    from tensorflowonspark_torch import ckpt

    try:
        fn, sig = load_forward(args.dir, device=args.device)
    except FileNotFoundError:
        print(f"{args.dir} is a weights-only export (no serialized "
              "forward): `run` needs a self-describing export; serve it "
              "through TFModel with model_name/predict_fn instead",
              file=sys.stderr)
        return 2
    state = ckpt.load_pytree(fs.join(args.dir, "model"))
    with np.load(args.inputs) as z:
        batch = {k: z[k] for k in z.files}
    out = fn(state, batch)
    if isinstance(out, Mapping):
        arrays = {name: leaf for name, leaf in _flatten_outputs(out)}
    else:
        # tuple/tensor outputs: name leaves from the signature's order
        arrays = {o["name"]: leaf for o, (_, leaf) in
                  zip(sig["outputs"], _flatten_outputs(out))}
    arrays = {k: v.detach().cpu().numpy() for k, v in arrays.items()}
    for k, v in arrays.items():
        print(f"{k}: {v.dtype}{list(v.shape)} "
              f"first={np.ravel(v)[:4].tolist()}")
    if args.outputs:
        np.savez(args.outputs, **arrays)
        print(f"wrote {args.outputs}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys

    sys.exit(_cli())
