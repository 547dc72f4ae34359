"""Small shared utilities.

Reference anchor: ``tensorflowonspark_tpu/util.py``.  The JAX package's
``ensure_jax_platform`` pins a JAX backend; its counterpart here is
:func:`select_device`, the one place that turns a device request into a
``torch.device``.  The executor-id guard and the port helpers
(:func:`get_ip_address` among them) are copies.
"""

from __future__ import annotations

import errno
import os
import socket
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


def to_device(value, device: torch.device) -> torch.Tensor:
    """``value`` (a numpy array or a tensor) as a tensor on ``device``: a
    host array goes through pinned memory with a non-blocking copy to a
    card; a tensor already there passes through."""
    import numpy as np

    t = (value if isinstance(value, torch.Tensor)
         else torch.as_tensor(np.ascontiguousarray(value)))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def single_node_scratch_dir(app_id: str) -> str:
    """Per-application scratch directory on this host (created on demand),
    under ``TFOS_SCRATCH_ROOT`` or the process temp dir."""
    d = os.path.join(
        os.environ.get("TFOS_SCRATCH_ROOT") or tempfile.gettempdir(),
        f"tfos_torch_{app_id}")
    os.makedirs(d, exist_ok=True)
    return d


def get_ip_address() -> str:
    """Best-effort routable IP of this host.

    Reference anchor: ``tensorflowonspark/util.py::get_ip_address`` (the UDP
    connect trick — no packet is actually sent).
    """
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def find_in_path(path: str, file_name: str) -> str | None:
    """Find ``file_name`` in the ``os.pathsep``-separated ``path``."""
    for p in path.split(os.pathsep):
        candidate = os.path.join(p, file_name)
        if os.path.exists(candidate) and os.path.isfile(candidate):
            return candidate
    return None


def _executor_id_file(dir_path: str | None = None,
                      name: str = "executor_id") -> str:
    return os.path.join(dir_path or os.getcwd(), name)


def write_executor_id(num: int, dir_path: str | None = None,
                      name: str = "executor_id") -> None:
    """Record this executor's cluster node id in its working directory: the
    collision guard against two bootstrap tasks on one executor."""
    with open(_executor_id_file(dir_path, name), "w", encoding="utf-8") as f:
        f.write(str(num))


def read_executor_id(dir_path: str | None = None,
                     name: str = "executor_id") -> int | None:
    """Read the executor id written by :func:`write_executor_id`, if any."""
    try:
        with open(_executor_id_file(dir_path, name), encoding="utf-8") as f:
            return int(f.read())
    except OSError as e:
        if e.errno in (errno.ENOENT,):
            return None
        raise


def find_free_port(host: str = "") -> tuple[str, int]:
    """Bind an ephemeral TCP port and return ``(hostname, port)``; the
    socket is closed before returning."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return (host or get_ip_address(), port)
