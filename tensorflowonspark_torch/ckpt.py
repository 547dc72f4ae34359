"""One-shot save/load of a nested dict of arrays.

Reference anchor: ``tensorflowonspark_tpu/ckpt.py::save_pytree`` /
``load_pytree`` (an Orbax checkpoint there).  The port's format is a
directory holding one ``pytree.npz``: every leaf stored under its key path
joined by ``/``, read back with ``allow_pickle=False`` so loading an export
runs no code.  The file is written under a temporary name and moved into
place, so a reader never sees half of it.

Step-numbered training checkpoints (``CheckpointManager``) wait for the
training slice.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np

logger = logging.getLogger(__name__)

_FILE = "pytree.npz"
_SEP = "/"


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        k = str(k)
        if not k or _SEP in k:
            raise ValueError(f"pytree key {k!r} is empty or holds {_SEP!r}")
        if isinstance(v, Mapping):
            if not v:
                raise ValueError(f"pytree node {prefix + k!r} is empty")
            out.update(_flatten(v, prefix + k + _SEP))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def save_pytree(state: Mapping[str, Any], path: str) -> str:
    """Save a nested dict of arrays (numpy, or anything ``np.asarray``
    takes) into the directory ``path``.  Returns the absolute path."""
    path = os.path.abspath(path)
    flat = _flatten(state)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_FILE}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, os.path.join(path, _FILE))
    logger.info("saved %d arrays to %s", len(flat), path)
    return path


def load_pytree(path: str) -> dict[str, Any]:
    """The nested dict of **numpy** arrays saved by :func:`save_pytree`."""
    out: dict[str, Any] = {}
    with np.load(os.path.join(os.path.abspath(path), _FILE),
                 allow_pickle=False) as z:
        for key in z.files:
            *parents, leaf = key.split(_SEP)
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return out
