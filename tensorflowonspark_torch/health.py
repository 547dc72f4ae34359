"""Card health probe at rendezvous.

Reference anchor: ``tensorflowonspark_tpu/health.py`` (``probe_chip_health``,
``should_probe``, ``should_probe_serving``).  A node whose accelerator is
wedged accepts work and never completes it, so it would register and then
hang the cluster at its first collective.  The probe turns that into a
fast, attributed bootstrap failure: a small kernel on the node's card in a
watchdogged subprocess, whose result must come back to the host.  The
subprocess provides the watchdog (a wedged device op cannot be interrupted
in-process) and keeps the bootstrap process free of CUDA state: the
trainer process is the first to own the card.

The child is a fresh interpreter that imports neither ``torch`` nor the
caller's main module (a spawned ``multiprocessing`` child imports both,
and ``torch`` with the card's context and cuBLAS are most of its
seconds): it drives the card through the CUDA driver API (``libcuda``,
over ``ctypes``), JIT-compiles :data:`_PROBE_PTX`, launches it over
:data:`_PROBE_N` elements, synchronises and checks every element on the
host.  On the CPU (``TFOS_TORCH_DEVICE=cpu``, where only a forced probe
runs) it checks a 128² numpy matmul instead.

Env knobs, as the reference's:

- ``TFOS_HEALTH_PROBE`` — force-enable ("1") or disable ("0") regardless of
  the cards claimed.  Default: probe only when cards were claimed (a
  cluster bootstrap) or when the serving device is a card
  (:func:`should_probe_serving`, ``pipeline.single_node_env``).
- ``TFOS_HEALTH_PROBE_TIMEOUT_S`` — the serving probe's watchdog (default
  60 s).
- ``TFOS_HEALTH_PROBE_HANG`` — test hook: the probe child sleeps forever,
  simulating the wedged card.

The mid-run ``StepWatchdog`` is not ported yet.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 60.0

#: elements the probe kernel writes
_PROBE_N = 16384

#: ``out[i] = 3 i + 1`` for ``i < n``, one thread an element: the probe's
#: kernel, in PTX the driver JIT-compiles for whatever card it finds
_PROBE_PTX = """
.version 6.0
.target sm_52
.address_size 64

.visible .entry tfos_probe(.param .u64 p_out, .param .u32 p_n)
{
    .reg .pred %p;
    .reg .b32 %r<6>;
    .reg .f32 %f<3>;
    .reg .b64 %rd<4>;

    ld.param.u64 %rd1, [p_out];
    ld.param.u32 %r1, [p_n];
    mov.u32 %r2, %ctaid.x;
    mov.u32 %r3, %ntid.x;
    mov.u32 %r4, %tid.x;
    mad.lo.s32 %r5, %r2, %r3, %r4;
    setp.ge.u32 %p, %r5, %r1;
    @%p bra DONE;
    cvt.rn.f32.u32 %f1, %r5;
    fma.rn.f32 %f2, %f1, 0f40400000, 0f3F800000;
    cvta.to.global.u64 %rd2, %rd1;
    mul.wide.u32 %rd3, %r5, 4;
    add.s64 %rd2, %rd2, %rd3;
    st.global.f32 [%rd2], %f2;
DONE:
    ret;
}
"""


def _card_probe(ordinal: int) -> None:
    """The child's work on card ``ordinal`` (of the visible ones): the
    primary context, :data:`_PROBE_PTX` loaded and launched, the result
    copied back and checked.  Raises ``RuntimeError`` naming the driver
    call that failed."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    c_ptr, c_uint, c_size = ctypes.c_void_p, ctypes.c_uint, ctypes.c_size_t
    cu.cuMemAlloc_v2.argtypes = [ctypes.POINTER(ctypes.c_uint64), c_size]
    cu.cuMemcpyDtoH_v2.argtypes = [c_ptr, ctypes.c_uint64, c_size]
    cu.cuMemFree_v2.argtypes = [ctypes.c_uint64]
    cu.cuModuleLoadData.argtypes = [ctypes.POINTER(c_ptr), ctypes.c_char_p]
    cu.cuModuleGetFunction.argtypes = [ctypes.POINTER(c_ptr), c_ptr,
                                       ctypes.c_char_p]
    cu.cuLaunchKernel.argtypes = [c_ptr] + [c_uint] * 7 + [c_ptr] * 3
    cu.cuCtxSetCurrent.argtypes = [c_ptr]
    cu.cuModuleUnload.argtypes = [c_ptr]

    def check(result: int, call: str) -> None:
        if result != 0:
            raise RuntimeError(f"{call} returned CUresult {result}")

    check(cu.cuInit(0), "cuInit")
    dev, ctx = ctypes.c_int(), c_ptr()
    check(cu.cuDeviceGet(ctypes.byref(dev), ordinal), "cuDeviceGet")
    check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
          "cuDevicePrimaryCtxRetain")
    check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    module, fn = c_ptr(), c_ptr()
    check(cu.cuModuleLoadData(ctypes.byref(module), _PROBE_PTX.encode()),
          "cuModuleLoadData")
    check(cu.cuModuleGetFunction(ctypes.byref(fn), module, b"tfos_probe"),
          "cuModuleGetFunction")
    ptr = ctypes.c_uint64()
    check(cu.cuMemAlloc_v2(ctypes.byref(ptr), 4 * _PROBE_N), "cuMemAlloc")
    n = ctypes.c_uint32(_PROBE_N)
    args = (c_ptr * 2)(ctypes.cast(ctypes.byref(ptr), c_ptr),
                       ctypes.cast(ctypes.byref(n), c_ptr))
    check(cu.cuLaunchKernel(fn, (_PROBE_N + 255) // 256, 1, 1, 256, 1, 1,
                            0, None, args, None), "cuLaunchKernel")
    check(cu.cuCtxSynchronize(), "cuCtxSynchronize")
    host = (ctypes.c_float * _PROBE_N)()
    check(cu.cuMemcpyDtoH_v2(host, ptr, 4 * _PROBE_N), "cuMemcpyDtoH")
    bad = [i for i in range(_PROBE_N) if host[i] != 3.0 * i + 1.0]
    check(cu.cuMemFree_v2(ptr), "cuMemFree")
    check(cu.cuModuleUnload(module), "cuModuleUnload")
    check(cu.cuDevicePrimaryCtxRelease_v2(dev), "cuDevicePrimaryCtxRelease")
    if bad:
        raise RuntimeError(f"probe kernel wrote {len(bad)} wrong elements "
                           f"(first at {bad[0]}: {host[bad[0]]})")


def _probe_child(device: str) -> None:
    """Child body: :func:`_card_probe` on a card, a numpy matmul on the
    CPU."""
    if os.environ.get("TFOS_HEALTH_PROBE_HANG"):
        time.sleep(3600)  # simulated wedge (never returns inside the watchdog)
    kind, _, index = device.partition(":")
    if kind == "cuda":
        _card_probe(int(index or 0))
        return
    import numpy as np

    x = np.ones((128, 128), dtype=np.float32)
    y = float((x @ x).sum())
    if y != 128.0 ** 3:
        raise RuntimeError(f"probe matmul gave {y}, want {128 ** 3}")


def _probe_device() -> str:
    """The device a probe checks, as ``util.select_device`` names it but
    without touching the card here: the bootstrap process stays free of
    CUDA state."""
    from tensorflowonspark_torch import util

    return os.environ.get(util.DEVICE_ENV, "").strip() or "cuda"


def probe_chip_health(timeout_s: float = DEFAULT_TIMEOUT_S) -> str | None:
    """Run the watchdogged probe; return ``None`` if healthy, else a reason.

    The child is a fresh interpreter (:func:`_probe_child` through
    ``python -c``), SIGKILLed on timeout — a wedged device op ignores
    gentler signals.  The probe runs under an ``obs`` span
    (``health.probe``) carrying the verdict and the timeout.
    """
    from tensorflowonspark_torch import obs

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    code = ("import sys; from tensorflowonspark_torch import health; "
            "health._probe_child(sys.argv[1])")
    t0 = time.monotonic()
    with obs.span("health.probe", timeout_s=timeout_s) as sp:
        p = subprocess.Popen([sys.executable, "-c", code, _probe_device()],
                             env=env, stdin=subprocess.DEVNULL,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
        try:
            _, err = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            try:
                p.communicate(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass  # stuck in the driver: left to the kernel
            reason = (f"device health probe hung for {timeout_s}s "
                      "(card wedged?)")
            sp.set(ok=False, reason=reason)
            return reason
        if p.returncode != 0:
            last = err.decode(errors="replace").strip().splitlines()[-1:]
            reason = (f"device health probe crashed (exit code "
                      f"{p.returncode})" + (f": {last[0]}" if last else ""))
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


def should_probe_serving(device) -> bool:
    """Probe policy of the cluster-less serving path
    (``pipeline.single_node_env``; reference ``health.py:206``): no
    cluster meta and no card claims exist there, so probe when the device
    chosen is a card; a CPU executor pays nothing.  ``TFOS_HEALTH_PROBE``
    overrides both ways."""
    import torch

    override = _probe_env_override()
    if override is not None:
        return override
    return torch.device(device).type == "cuda"
