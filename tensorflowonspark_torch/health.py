"""Card health probe at rendezvous.

Reference anchor: ``tensorflowonspark_tpu/health.py`` (``probe_chip_health``,
``should_probe``).  A node whose accelerator is wedged accepts work and
never completes it, so it would register and then hang the cluster at its
first collective.  The probe turns that into a fast, attributed bootstrap
failure: a small matmul on the node's device in a watchdogged *spawned*
subprocess, whose result must come back to the host
(``torch.cuda.synchronize`` then ``.item()``).  The subprocess provides the
watchdog (a wedged device op cannot be interrupted in-process) and keeps
the bootstrap process free of CUDA state: the trainer process is the first
to own the card.

Env knobs, as the reference's:

- ``TFOS_HEALTH_PROBE`` — force-enable ("1") or disable ("0") regardless of
  the cards claimed.  Default: probe only when cards were claimed.
- ``TFOS_HEALTH_PROBE_HANG`` — test hook: the probe child sleeps forever,
  simulating the wedged card.

The mid-run ``StepWatchdog`` is not ported yet.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 60.0


def _probe_child() -> None:
    """Child body: a matmul on this node's device, its result on the host."""
    if os.environ.get("TFOS_HEALTH_PROBE_HANG"):
        time.sleep(3600)  # simulated wedge (never returns inside the watchdog)
    import torch

    from tensorflowonspark_torch import util

    device = util.select_device()
    x = torch.ones((128, 128), dtype=torch.bfloat16, device=device)
    y = (x @ x).float().sum()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if y.item() != 128.0 ** 3:
        raise RuntimeError(f"probe matmul gave {y.item()}, want {128 ** 3}")


def probe_chip_health(timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Run the watchdogged probe; return ``None`` if healthy, else a reason.

    Uses the *spawn* context (fork would clone the executor's threads) and
    SIGKILLs the child on timeout — a wedged device op ignores gentler
    signals.  The probe runs under an ``obs`` span (``health.probe``)
    carrying the verdict and the timeout.
    """
    import multiprocessing

    from tensorflowonspark_torch import obs

    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_probe_child, name="tfos-health-probe", daemon=True)
    t0 = time.monotonic()
    with obs.span("health.probe", timeout_s=timeout_s) as sp:
        p.start()
        p.join(timeout_s)
        if p.is_alive():
            p.kill()
            p.join(5.0)
            reason = (f"device health probe hung for {timeout_s}s "
                      "(card wedged?)")
            sp.set(ok=False, reason=reason)
            return reason
        if p.exitcode != 0:
            reason = f"device health probe crashed (exit code {p.exitcode})"
            sp.set(ok=False, reason=reason)
            return reason
        sp.set(ok=True)
    logger.info("card health probe passed in %.1fs", time.monotonic() - t0)
    return None


def _probe_env_override() -> bool | None:
    """TFOS_HEALTH_PROBE parse: None when unset, else the forced verdict."""
    env = os.environ.get("TFOS_HEALTH_PROBE")
    if env is None:
        return None
    return env not in ("0", "", "false", "no")


def should_probe(cluster_meta: dict, chips: list) -> bool:
    """Decide whether this bootstrap should probe (see module docstring)."""
    override = _probe_env_override()
    if override is not None:
        return override
    configured = cluster_meta.get("health_probe")
    if configured is not None:
        return bool(configured)
    return bool(chips)
