"""CUDA card discovery and per-executor card claiming.

Reference anchor: ``tensorflowonspark/gpu_info.py::get_gpus`` — the reference
parses ``nvidia-smi`` for free GPUs, retries with random backoff when
several executors on one host race for the same device, then exports
``CUDA_VISIBLE_DEVICES``.

A copy of ``tensorflowonspark_tpu/chip_info.py``: executors *partition* the
host's cards ahead of time with atomic lock files in a per-host claim
directory (``O_CREAT|O_EXCL``, race-free rather than retry-until-quiet),
then :func:`set_visibility_env` exports ``CUDA_VISIBLE_DEVICES`` before the
trainer process first touches CUDA.  :func:`get_num_host_chips` counts CUDA
cards.

The retry/backoff loop (``MAX_RETRIES``) is kept for the case where a
just-killed executor's stale claim file still exists and is being reaped.
"""

from __future__ import annotations

import glob
import logging
import os
import random
import time

logger = logging.getLogger(__name__)

MAX_RETRIES = 3  # parity: tensorflowonspark/gpu_info.py::MAX_RETRIES
_CLAIM_STALE_SECS = 600.0


def get_num_host_chips() -> int:
    """Number of CUDA cards this process may use.

    ``TFOS_NUM_CHIPS`` overrides (tests, CPU hosts); else
    ``torch.cuda.device_count()``, which honours an inherited
    ``CUDA_VISIBLE_DEVICES``.
    """
    override = os.environ.get("TFOS_NUM_CHIPS")
    if override:
        return int(override)
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _claim_dir(app_id: str) -> str:
    from tensorflowonspark_torch import util

    d = os.path.join(util.single_node_scratch_dir(app_id), "chip_claims")
    os.makedirs(d, exist_ok=True)
    return d


def claim_chips(num_chips: int, app_id: str, worker_tag: str) -> list[int]:
    """Atomically claim ``num_chips`` of this host's chips for one executor.

    Returns the claimed chip indices.  Raises ``RuntimeError`` when the host
    does not have enough unclaimed chips after ``MAX_RETRIES`` passes (stale
    claims older than ``_CLAIM_STALE_SECS`` are reaped between passes).
    """
    total = get_num_host_chips()
    if total == 0:
        logger.info("no CUDA cards visible on this host; nothing to claim")
        return []
    if num_chips > total:
        raise RuntimeError(
            f"requested {num_chips} chips but host has only {total}"
        )
    d = _claim_dir(app_id)
    for attempt in range(MAX_RETRIES + 1):
        claimed: list[int] = []
        for chip in range(total):
            if len(claimed) == num_chips:
                break
            path = os.path.join(d, f"chip_{chip}.lock")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(f"{worker_tag}\n{os.getpid()}")
            claimed.append(chip)
        if len(claimed) == num_chips:
            logger.info("claimed chips %s for %s", claimed, worker_tag)
            _release_at_exit(claimed, app_id)
            return claimed
        release_chips(claimed, app_id)  # partial claim — roll back and retry
        _reap_stale_claims(d)
        if attempt < MAX_RETRIES:
            time.sleep(random.uniform(0.1, 1.0) * (attempt + 1))
    raise RuntimeError(
        f"could not claim {num_chips} free chips on this host for {worker_tag}"
    )


def _release_at_exit(chips: list[int], app_id: str) -> None:
    """Release claims when this process exits normally.

    A SIGKILLed process can't run this — its claims are reaped later by
    :func:`_reap_stale_claims` once the recorded pid is dead.
    """
    import atexit

    atexit.register(release_chips, list(chips), app_id)


def release_chips(chips: list[int], app_id: str) -> None:
    """Release claims owned by *this process*.

    Ownership is verified against the pid recorded in the lock file so a
    lingering process's (atexit) release cannot destroy a successor's live
    claim on the same chip index.
    """
    d = _claim_dir(app_id)
    for chip in chips:
        path = os.path.join(d, f"chip_{chip}.lock")
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            owner_pid = int(lines[1]) if len(lines) > 1 else None
            if owner_pid is not None and owner_pid != os.getpid():
                continue
            os.unlink(path)
        except (OSError, ValueError):
            pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def _reap_stale_claims(d: str) -> None:
    """Remove claims whose owning process is dead.

    A claim is only reaped when the pid recorded in the lock file no longer
    exists — mtime alone would reap a *live* executor that has simply been
    training for a long time.  Claims without a readable pid fall back to a
    (long) mtime threshold.
    """
    now = time.time()
    for path in glob.glob(os.path.join(d, "chip_*.lock")):
        try:
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            pid = int(lines[1]) if len(lines) > 1 else None
            if pid is not None:
                stale = not _pid_alive(pid)
            else:
                stale = now - os.path.getmtime(path) > _CLAIM_STALE_SECS
            if stale:
                os.unlink(path)
                logger.warning("reaped stale chip claim %s", path)
        except (OSError, ValueError):
            pass


def set_visibility_env(chips: list[int]) -> None:
    """Pin CUDA to the claimed cards before the trainer first touches it:
    export ``CUDA_VISIBLE_DEVICES``, as the reference's caller of
    ``gpu_info.py::get_gpus`` does.  The claimed indices count the cards
    this process may see, so an inherited ``CUDA_VISIBLE_DEVICES`` maps
    them to its own entries."""
    if not chips:
        return
    inherited = [d.strip() for d in
                 os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
                 if d.strip()]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
        inherited[c] if c < len(inherited) else str(c) for c in chips)
