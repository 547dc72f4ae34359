"""Small shared utilities.

Reference anchor: ``tensorflowonspark_tpu/util.py``.  The JAX package's
``ensure_jax_platform`` pins a JAX backend; its counterpart here is
:func:`select_device`, the one place that turns a device request into a
``torch.device``.
"""

from __future__ import annotations

import os
import tempfile

import torch

#: Environment knob read when no device is passed: ``cpu`` selects the CPU
#: (tests set it; spawned executors inherit it).  Unset means ``cuda``.
DEVICE_ENV = "TFOS_TORCH_DEVICE"


def select_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``device`` wins; else ``TFOS_TORCH_DEVICE``; else ``cuda``.  A CUDA
    request on a host where ``torch.cuda.is_available()`` is false raises
    ``RuntimeError`` — there is no silent CPU fallback.
    """
    if device is None:
        device = os.environ.get(DEVICE_ENV, "").strip() or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' or set {DEVICE_ENV}=cpu to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev


def single_node_scratch_dir(app_id: str) -> str:
    """Per-application scratch directory on this host (created on demand),
    under ``TFOS_SCRATCH_ROOT`` or the process temp dir."""
    d = os.path.join(
        os.environ.get("TFOS_SCRATCH_ROOT") or tempfile.gettempdir(),
        f"tfos_torch_{app_id}")
    os.makedirs(d, exist_ok=True)
    return d
