"""Fused GroupNorm (+ residual add) (+ ReLU), forward and backward.

``group_norm_act(x, gamma, beta, groups, eps, residual, relu)`` computes
``act(GN(x) * gamma + beta + residual)``: statistics in f32 per (sample,
group) over H·W·C/G with ``var = max(E[x²] − E[x]², 0)`` (flax
``nn.GroupNorm``'s ``use_fast_variance``), then the affine step, the
optional residual and the optional ReLU, rounded once to ``x``'s dtype.

It carries the XLA fusion the JAX package gets for free after every conv
of ``tensorflowonspark_tpu/models/resnet.py`` (``norm`` at lines 59-63,
``nn.relu``, and the block-end add at line 89).  There is no Pallas kernel
behind it.

- On a CUDA tensor the wrapper launches the hand-written kernel of
  ``csrc/group_norm.cu`` (bf16, ``channels_last``) and counts the launch in
  :data:`launches` and :data:`launches_by_path`, or raises.  It never falls
  back.
- :func:`_plan` picks the kernel's path by shape alone: ``one_pass`` (one
  launch; a thread-block cluster of up to 8 blocks holds each sample in
  shared memory, so x is read once) wherever a sample fits, which is every
  norm of the ResNet-50 forward at 224²; ``two_pass`` (stats, finalize,
  apply: x read twice) for larger samples.  A failure on either path
  raises; neither stands in for the other.
- On a CPU tensor it computes :func:`group_norm_act_plain`, the same
  arithmetic as explicit tensor ops.  The CPU tests reach the function
  through that path; ``chip_smoke.py`` compares the two on the card.

When an input requires a gradient, the call goes through an
``autograd.Function``: the forward also keeps the per-(sample, group)
``(mean, rstd)`` in f32 (the one-pass kernel writes them through its stats
output, which is null at inference), and the backward launches the
hand-written kernel of ``csrc/group_norm_bwd.cu`` (counted under
``launches_by_path["backward"]``) on the card, or computes
:func:`group_norm_act_backward_plain` on the CPU.  With no gradient wanted
the forward is the inference launch, unchanged and saving nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import torch

#: Kernel launches in this process: one per :func:`group_norm_act` call
#: that reached a forward kernel and one per backward that reached the
#: backward kernel.  Plain int; :func:`reset_launches` zeroes it and
#: :data:`launches_by_path`.
launches = 0
#: The same launches: forwards by the path :func:`_plan` chose, and
#: backwards.
launches_by_path = {"one_pass": 0, "two_pass": 0, "backward": 0}

_VEC = 8  # bf16 channels per 16-byte vector in the kernel
_MAX_THREADS = 256  # a block's threads; C/8 must not exceed it
_TARGET_BLOCKS = 1024  # stats-pass blocks to aim for: ~8 per SM on 132 SMs
_SMEM_MAX = 232448  # dynamic shared memory an H100 block may use
_CLUSTER_MAX = 8  # the portable thread-block cluster size
_CHUNKS = 4  # bulk copies (one mbarrier each) per one-pass block
_LIB = None
_BWD_LIB = None
_PREPARED: set = set()  # (device index, cluster, smem) the card accepted


class Plan(NamedTuple):
    """How one call runs: ``path`` ``one_pass`` uses ``cluster`` blocks
    per sample with ``smem`` bytes of shared memory each; ``two_pass``
    sums each sample in ``chunks`` stats blocks of ``rows_per_chunk``
    pixels."""
    path: str
    threads: int
    cluster: int = 0
    smem: int = 0
    chunks: int = 0
    rows_per_chunk: int = 0


def reset_launches() -> None:
    """Zero :data:`launches` and :data:`launches_by_path`."""
    global launches
    launches = 0
    for k in launches_by_path:
        launches_by_path[k] = 0


def _plain_forward(x, gamma, beta, groups, eps, residual, relu):
    """:func:`group_norm_act_plain`'s result and its ``(N, G, 2)`` f32
    ``(mean, rstd)``."""
    n, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd * gamma.float().reshape(1, 1, groups, -1)
    y = (xf - mean) * scale + beta.float().reshape(1, 1, groups, -1)
    y = y.reshape(n, h, w, c)
    if residual is not None:
        y = y + residual.permute(0, 2, 3, 1).float()
    if relu:
        y = torch.relu(y)
    stats = torch.stack((mean.reshape(n, groups), rstd.reshape(n, groups)),
                        dim=-1)
    return y.to(x.dtype).permute(0, 3, 1, 2), stats


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int, eps: float,
                         residual: torch.Tensor | None = None,
                         relu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic as plain tensor ops, in f32.

    ``x`` is ``(N, C, H, W)`` in any memory format; the result has ``x``'s
    shape and dtype and is ``channels_last``."""
    return _plain_forward(x, gamma, beta, groups, eps, residual, relu)[0]


def group_norm_act_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                                  y: torch.Tensor | None,
                                  gamma: torch.Tensor, stats: torch.Tensor,
                                  groups: int, residual: bool = False,
                                  relu: bool = True):
    """The backward kernel's arithmetic as plain tensor ops, in f32.

    ``y`` is the forward's output (only ``y > 0`` is read, and only with
    ``relu``), ``stats`` its ``(N, G, 2)`` ``(mean, rstd)``.  With
    ``M = H·W·C/G``, ``x̂ = (x − mean)·rstd`` and ``dz = dy·[y > 0]`` (or
    ``dy``), per (sample, group)::

        dx = rstd·(dz·γ − mean_M(dz·γ) − x̂·mean_M(dz·γ·x̂))

    Returns ``(dx, d_residual, dγ, dβ)``: ``dx`` and ``d_residual`` (``dz``;
    ``None`` unless ``residual``) in ``x``'s dtype and ``channels_last``,
    ``dγ = Σ dz·x̂`` and ``dβ = Σ dz`` per channel in f32."""
    n, c, h, w = x.shape
    cpg = c // groups
    dz = dy.permute(0, 2, 3, 1).float()
    if relu:
        dz = dz * (y.permute(0, 2, 3, 1) > 0)
    dz = dz.reshape(n, h * w, groups, cpg)
    xf = x.permute(0, 2, 3, 1).float().reshape(n, h * w, groups, cpg)
    mean = stats[..., 0].reshape(n, 1, groups, 1)
    rstd = stats[..., 1].reshape(n, 1, groups, 1)
    xh = (xf - mean) * rstd
    dxh = dz * gamma.float().reshape(1, 1, groups, cpg)
    dx = rstd * (dxh - dxh.mean(dim=(1, 3), keepdim=True)
                 - xh * (dxh * xh).mean(dim=(1, 3), keepdim=True))
    dgamma = (dz * xh).sum(dim=(0, 1)).reshape(c)
    dbeta = dz.sum(dim=(0, 1)).reshape(c)
    dres = (dz.reshape(n, h, w, c).to(x.dtype).permute(0, 3, 1, 2)
            if residual else None)
    return (dx.reshape(n, h, w, c).to(x.dtype).permute(0, 3, 1, 2), dres,
            dgamma, dbeta)


class _GroupNormAct(torch.autograd.Function):
    """:func:`group_norm_act` with a gradient: the forward keeps ``x``, the
    output (as the ReLU mask), γ and the ``(mean, rstd)`` it computed; the
    backward reads them and does not recompute the statistics."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, groups, eps, relu):
        if x.device.type == "cpu":
            y, stats = _plain_forward(x, gamma, beta, groups, eps, residual,
                                      relu)
        else:
            y, stats = _launch(x, gamma, beta, groups, eps, residual, relu,
                               keep_stats=True)
        ctx.groups, ctx.relu = groups, relu
        ctx.residual = residual is not None
        ctx.save_for_backward(x, y if relu else None, gamma, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, gamma, stats = ctx.saved_tensors
        want_res = ctx.residual and ctx.needs_input_grad[3]
        if x.device.type == "cpu":
            dx, dres, dgamma, dbeta = group_norm_act_backward_plain(
                dy, x, y, gamma, stats, ctx.groups, want_res, ctx.relu)
        else:
            dx, dres, dgamma, dbeta = _launch_backward(
                dy, x, y, gamma, stats, ctx.groups, want_res, ctx.relu)
        return dx, dgamma, dbeta, dres, None, None, None


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float,
                   residual: torch.Tensor | None = None,
                   relu: bool = True) -> torch.Tensor:
    """``act(GN(x) * gamma + beta + residual)``; see the module docstring.

    ``x`` (and ``residual``) are ``(N, C, H, W)``; on the card they must be
    bf16 and ``channels_last``-contiguous, ``gamma``/``beta`` f32 ``(C,)``.
    """
    device = x.device.type
    if device not in ("cpu", "cuda"):
        raise RuntimeError(
            f"group_norm_act: tensors on {x.device} are not supported "
            "(cpu takes the plain path, cuda the kernel)")
    if torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad
            or (residual is not None and residual.requires_grad)):
        return _GroupNormAct.apply(x, gamma, beta, residual, groups, eps,
                                   relu)
    if device == "cpu":
        return group_norm_act_plain(x, gamma, beta, groups, eps, residual,
                                    relu)
    return _launch(x, gamma, beta, groups, eps, residual, relu)


def _check(x: torch.Tensor, gamma, beta, groups: int, residual) -> None:
    if x.dim() != 4:
        raise ValueError(f"group_norm_act: x must be 4-D (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_act kernel takes bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_act kernel needs x contiguous in "
                         "torch.channels_last (NHWC)")
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm_act: C={c} is not a multiple of "
                         f"groups={groups}")
    if c % _VEC or c // _VEC > _MAX_THREADS:
        raise ValueError(f"group_norm_act kernel needs C % {_VEC} == 0 and "
                         f"C <= {_VEC * _MAX_THREADS}, got C={c}")
    if n > 65535:
        raise ValueError(f"group_norm_act kernel takes N <= 65535, got {n}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if (p.dtype != torch.float32 or p.shape != (c,)
                or p.device != x.device or not p.is_contiguous()):
            raise ValueError(f"group_norm_act: {name} must be a contiguous "
                             f"float32 ({c},) tensor on {x.device}")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous(
                    memory_format=torch.channels_last)):
            raise ValueError("group_norm_act: residual must match x in "
                             "shape, dtype, device and channels_last layout")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"group_norm_act kernel needs {name} 16-byte "
                             "aligned")


def _one_pass_smem(hw: int, c: int, groups: int, cluster: int,
                   threads: int) -> int:
    """Shared memory of one one-pass block, as ``one_pass_smem`` in
    ``csrc/group_norm.cu`` lays it out: the block's rows of x, the chunks'
    mbarriers, per-thread (sums, then squares), per-channel and per-group
    f32 sums, and the sample's (mean, rstd) per group."""
    rows = -(-hw // cluster)
    return (rows * c * 2 + 8 * _CHUNKS + threads * _VEC * 4 + c * 2 * 4
            + groups * 4 * 4)


def _chunking(n: int, hw: int, cvecs: int, threads: int) -> tuple[int, int]:
    """``(chunks, rows_per_chunk)``: how a pass that sums over a sample
    (the two-pass forward's stats, the backward's reduction) splits each
    sample's ``hw`` pixels into blocks, about ``_TARGET_BLOCKS`` in all."""
    rows_per_iter = threads // cvecs
    chunks = max(1, min(math.ceil(hw / rows_per_iter),
                        math.ceil(_TARGET_BLOCKS / max(n, 1))))
    rows_per_chunk = math.ceil(hw / chunks)
    return math.ceil(hw / rows_per_chunk), rows_per_chunk


@functools.lru_cache(maxsize=1024)
def _plan(n: int, h: int, w: int, c: int, groups: int) -> Plan:
    """The path for an (N, C, H, W) bf16 input, by shape alone: one pass
    with the least power-of-two cluster (≤ 8 blocks) whose blocks each hold
    their share of a sample in shared memory, else two passes."""
    cvecs = c // _VEC
    threads = (_MAX_THREADS // cvecs) * cvecs
    hw = h * w
    cluster = 1
    while cluster <= _CLUSTER_MAX:
        smem = _one_pass_smem(hw, c, groups, cluster, threads)
        if smem <= _SMEM_MAX:
            return Plan("one_pass", threads, cluster=cluster, smem=smem)
        cluster *= 2
    chunks, rows_per_chunk = _chunking(n, hw, cvecs, threads)
    return Plan("two_pass", threads, chunks=chunks,
                rows_per_chunk=rows_per_chunk)


def _check_capacity(plan: Plan, err: int, max_clusters: int) -> None:
    """Raise unless the card can run a cluster of ``plan``'s size at once."""
    if err != 0 or max_clusters < 1:
        raise RuntimeError(
            f"group_norm_act: the card cannot run a cluster of "
            f"{plan.cluster} blocks of {plan.threads} threads with "
            f"{plan.smem} bytes of shared memory each (CUDA error {err}, "
            f"{max_clusters} clusters fit)")


def _lib():
    global _LIB
    if _LIB is None:
        from tensorflowonspark_torch.kernels import _build

        lib = _build.load("group_norm")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        two = lib.tfos_group_norm_act_bf16
        two.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, i32, i64,
                        ctypes.c_float, i32, p]
        one = lib.tfos_group_norm_one_pass_bf16
        one.argtypes = [p, p, p, p, p, p, i64, i64, i32, i32, i32, i32,
                        ctypes.c_float, i32, p]
        prepare = lib.tfos_group_norm_one_pass_prepare
        prepare.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        for fn in (two, one, prepare):
            fn.restype = i32
        _LIB = (one, two, prepare)
    return _LIB


def _prepare(plan: Plan, device: int, prepare) -> None:
    """Once per device and cluster shape: raise the one-pass kernels'
    shared-memory limit and check that such a cluster fits the card."""
    key = (device, plan.cluster, plan.smem)
    if key in _PREPARED:
        return
    fit = ctypes.c_int(0)
    err = prepare(plan.cluster, plan.threads, plan.smem, ctypes.byref(fit))
    _check_capacity(plan, err, fit.value)
    _PREPARED.add(key)


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        from tensorflowonspark_torch.kernels import _build

        fn = _build.load("group_norm_bwd").tfos_group_norm_bwd_bf16
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p] * 12 + [i64, i64, i32, i32, i32, i64, i32, p]
        fn.restype = i32
        _BWD_LIB = fn
    return _BWD_LIB


def _launch(x, gamma, beta, groups, eps, residual, relu, keep_stats=False):
    """The forward on the card: ``y``, or ``(y, stats)`` with
    ``keep_stats``, ``stats`` the ``(N, G, 2)`` f32 ``(mean, rstd)``."""
    global launches
    _check(x, gamma, beta, groups, residual)
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = (torch.empty((n, groups, 2), dtype=torch.float32,
                         device=x.device) if keep_stats else None)
    if x.numel() == 0:
        return (y, stats) if keep_stats else y
    plan = _plan(n, h, w, c, groups)
    one, two, prepare = _lib()
    device = x.device.index
    r = residual.data_ptr() if residual is not None else None
    with (contextlib.nullcontext() if device == torch.cuda.current_device()
          else torch.cuda.device(device)):
        stream = torch._C._cuda_getCurrentRawStream(device)
        if plan.path == "one_pass":
            _prepare(plan, device, prepare)
            err = one(x.data_ptr(), r, gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr(), stats.data_ptr() if keep_stats else None,
                      n, h * w, c, groups, plan.cluster, plan.smem,
                      float(eps), int(bool(relu)), stream)
        else:
            partials = torch.empty((n, plan.chunks, groups, 2),
                                   dtype=torch.float32, device=x.device)
            if stats is None:
                stats = torch.empty((n, groups, 2), dtype=torch.float32,
                                    device=x.device)
            err = two(x.data_ptr(), r, gamma.data_ptr(), beta.data_ptr(),
                      y.data_ptr(), partials.data_ptr(), stats.data_ptr(), n,
                      h * w, c, groups, plan.chunks, plan.rows_per_chunk,
                      float(eps), int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel ({plan.path}) launch "
                           f"failed: CUDA error {err}")
    launches += 1
    launches_by_path[plan.path] += 1
    return (y, stats) if keep_stats else y


def _launch_backward(dy, x, y, gamma, stats, groups, residual, relu):
    """The backward on the card: ``(dx, d_residual or None, dγ, dβ)``."""
    global launches
    n, c, h, w = x.shape
    if not dy.is_contiguous(memory_format=torch.channels_last):
        dy = dy.contiguous(memory_format=torch.channels_last)  # e.g. the pool's
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"group_norm_act backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    if dy.data_ptr() % 16:
        raise ValueError("group_norm_act backward kernel needs dy 16-byte "
                         "aligned")
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dres = (torch.empty_like(x, memory_format=torch.channels_last)
            if residual else None)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dres, dgamma.zero_(), dbeta.zero_()
    cvecs = c // _VEC
    threads = (_MAX_THREADS // cvecs) * cvecs
    chunks, rows_per_chunk = _chunking(n, h * w, cvecs, threads)
    # f32 scratch in one allocation: partials (n, chunks, c, 2), chan
    # (n, c, 2), coef (n, groups, 2)
    sizes = (n * chunks * c * 2, n * c * 2, n * groups * 2)
    partials, chan, coef = torch.empty(
        sum(sizes), dtype=torch.float32, device=x.device).split(sizes)
    fn = _bwd_lib()
    device = x.device.index
    with (contextlib.nullcontext() if device == torch.cuda.current_device()
          else torch.cuda.device(device)):
        err = fn(dy.data_ptr(), x.data_ptr(),
                 y.data_ptr() if relu else None, gamma.data_ptr(),
                 stats.data_ptr(), dx.data_ptr(),
                 dres.data_ptr() if residual else None, dgamma.data_ptr(),
                 dbeta.data_ptr(), partials.data_ptr(), chan.data_ptr(),
                 coef.data_ptr(), n, h * w, c, groups, chunks,
                 rows_per_chunk, int(bool(relu)),
                 torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"group_norm_act backward kernel launch failed: "
                           f"CUDA error {err}")
    launches += 1
    launches_by_path["backward"] += 1
    return dx, dres, dgamma, dbeta
