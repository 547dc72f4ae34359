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
- :func:`_plan` picks the kernel's path by shape and the card's cluster
  capacity alone: ``one_pass`` (one launch; a thread-block cluster of up to
  8 blocks holds each sample in shared memory, so x is read once) wherever
  a sample fits, which is every norm of the ResNet-50 forward at 224²; the
  same kernel over a non-portable cluster of 9–16 blocks where 8 cannot
  hold a sample (Inception-v3's stem: 147²×64, 71²×192), the size chosen
  by :func:`_wide_cluster` from :func:`_capacity`'s table; ``two_pass``
  (stats, finalize, apply: x read twice) for samples beyond 16 blocks.  A
  failure on any path raises; none stands in for another.
- On a CPU tensor it computes :func:`group_norm_act_plain`, the same
  arithmetic as explicit tensor ops.  The CPU tests reach the function
  through that path; ``chip_smoke.py`` compares the two on the card.

When an input requires a gradient, the call goes through an
``autograd.Function``: the forward also keeps the per-(sample, group)
``(mean, rstd)`` in f32 (the one-pass kernel writes them through its stats
output, which is null at inference), and the backward launches the
hand-written kernel of ``csrc/group_norm_bwd.cu`` on the card, or computes
:func:`group_norm_act_backward_plain` on the CPU.  With no gradient wanted
the forward is the inference launch, unchanged and saving nothing.

:func:`_plan_backward` picks the backward's path the same way:
``one_pass`` (one launch; a cluster of up to 8 blocks per sample holds dz,
and x where both fit, so x, y and dy are read once, x twice where it does
not fit, the second time from L2) wherever dz of a sample fits 8 blocks,
which is every norm backward of ResNet-50 at 224², or 9–16 blocks (dz
alone); ``four_launch`` (reduce, finalize, apply, params: x, y and dy read
twice) for samples beyond 16 blocks.  Launches count under
``launches_by_path["backward_one_pass"]`` and
``["backward_four_launch"]``.
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
#: backward kernel (inside a CUDA graph's capture too, where the launch is
#: recorded; a replay of the graph calls no wrapper and counts nothing:
#: ``parallel.train.replayed_steps``).  Plain int; :func:`reset_launches`
#: zeroes it and :data:`launches_by_path`.
launches = 0
#: The same launches, by the path :func:`_plan` (forwards) or
#: :func:`_plan_backward` (backwards) chose: one count per wrapper call.
launches_by_path = {"one_pass": 0, "two_pass": 0, "backward_one_pass": 0,
                    "backward_four_launch": 0}

_VEC = 8  # bf16 channels per 16-byte vector in the kernel
_MAX_THREADS = 256  # a block's threads; C/8 must not exceed it
_TARGET_BLOCKS = 1024  # stats-pass blocks to aim for: ~8 per SM on 132 SMs
_SMEM_MAX = 232448  # dynamic shared memory an H100 block may use
_CLUSTER_MAX = 8  # the portable thread-block cluster size
_CLUSTER_WIDE = 16  # an H100's largest (non-portable) cluster
_CHUNKS = 4  # bulk copies (one mbarrier each) per one-pass block
_TICKETS = _CLUSTER_WIDE  # the one-pass backward's int tickets: a rank each
_SCRATCH_KEYS = 64  # backward scratch tensors kept at once
_LIB = None
_BWD_LIB = None
# (kernel, device index, cluster, smem) the card accepted
_PREPARED: set = set()
# (kernel, device index): the card's capacity table, see _capacity
_CAPACITY: dict = {}
# (device index, stream, n, c, groups, path): the backward's scratch
_BWD_SCRATCH: dict = {}
# while a CUDA graph is captured: the dict its owner keeps the captured
# backwards' scratch in (see capture_scratch)
_CAPTURE_SCRATCH: dict | None = None


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


class BwdPlan(NamedTuple):
    """How one backward runs: ``path`` ``one_pass`` (``launches`` 1) uses
    ``cluster`` blocks per sample with ``smem`` bytes of shared memory
    each, holding x there too when ``x_resident``; ``four_launch``
    (``launches`` 4) sums each sample in ``chunks`` blocks of
    ``rows_per_chunk`` pixels."""
    path: str
    threads: int
    launches: int
    cluster: int = 0
    smem: int = 0
    x_resident: bool = False
    chunks: int = 0
    rows_per_chunk: int = 0


def reset_launches() -> None:
    """Zero :data:`launches` and :data:`launches_by_path`."""
    global launches
    launches = 0
    for k in launches_by_path:
        launches_by_path[k] = 0


def _plain_forward(x, gamma, beta, groups, eps, residual, relu):
    """:func:`group_norm_act_plain`'s result and its ``(N, G, 2)``
    ``(mean, rstd)``, in f32 (f64 for a float64 ``x``)."""
    n, c, h, w = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.permute(0, 2, 3, 1).to(acc).reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = rstd * gamma.to(acc).reshape(1, 1, groups, -1)
    y = (xf - mean) * scale + beta.to(acc).reshape(1, 1, groups, -1)
    y = y.reshape(n, h, w, c)
    if residual is not None:
        y = y + residual.permute(0, 2, 3, 1).to(acc)
    if relu:
        y = torch.relu(y)
    stats = torch.stack((mean.reshape(n, groups), rstd.reshape(n, groups)),
                        dim=-1)
    return y.to(x.dtype).permute(0, 3, 1, 2), stats


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int, eps: float,
                         residual: torch.Tensor | None = None,
                         relu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic as plain tensor ops, in f32 (f64 for a
    float64 ``x``, which the kernel does not take).

    ``x`` is ``(N, C, H, W)`` in any memory format; the result has ``x``'s
    shape and dtype and is ``channels_last``."""
    return _plain_forward(x, gamma, beta, groups, eps, residual, relu)[0]


def group_norm_act_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                                  y: torch.Tensor | None,
                                  gamma: torch.Tensor, stats: torch.Tensor,
                                  groups: int, residual: bool = False,
                                  relu: bool = True):
    """The backward kernel's arithmetic as plain tensor ops, in f32 (f64
    for a float64 ``x``).

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
    acc = torch.promote_types(x.dtype, torch.float32)
    dz = dy.permute(0, 2, 3, 1).to(acc)
    if relu:
        dz = dz * (y.permute(0, 2, 3, 1) > 0)
    dz = dz.reshape(n, h * w, groups, cpg)
    xf = x.permute(0, 2, 3, 1).to(acc).reshape(n, h * w, groups, cpg)
    mean = stats[..., 0].reshape(n, 1, groups, 1)
    rstd = stats[..., 1].reshape(n, 1, groups, 1)
    xh = (xf - mean) * rstd
    dxh = dz * gamma.to(acc).reshape(1, 1, groups, cpg)
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


@torch.library.custom_op(
    "tfos::group_norm_act", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor gamma, Tensor beta, int groups, float eps, "
           "Tensor? residual, bool relu) -> Tensor")
def group_norm_act_op(x, gamma, beta, groups, eps, residual, relu):
    """``torch.ops.tfos.group_norm_act``: the inference forward of
    :func:`group_norm_act` as an operator that ``torch.export`` records
    as one node, so an exported program picks the device's
    implementation when it runs: :func:`group_norm_act_plain` on the CPU,
    the kernel (:func:`_launch`, counted) on a card.  The branch on
    ``x.device`` and the ``ctypes`` call of :func:`group_norm_act` cannot
    be traced, and a trace on the CPU would bake the plain ops into the
    program.  Every argument is positional (``_Norm.forward`` passes all
    seven); there is no gradient: training calls :func:`group_norm_act`."""
    return group_norm_act_plain(x, gamma, beta, groups, eps, residual, relu)


@group_norm_act_op.register_kernel("cuda")
def _group_norm_act_op_cuda(x, gamma, beta, groups, eps, residual, relu):
    return _launch(x, gamma, beta, groups, eps, residual, relu)


@group_norm_act_op.register_fake
def _group_norm_act_op_fake(x, gamma, beta, groups, eps, residual, relu):
    # both implementations return x's shape and dtype in channels_last
    return torch.empty_like(x, memory_format=torch.channels_last)


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


def _wide_cluster(fits, capacity: tuple) -> int:
    """Among the cluster sizes ``fits`` (9–16 blocks) whose blocks hold a
    sample, the one that keeps the most SMs busy: the largest k × (the
    clusters of k the card runs at once, by ``capacity``), the smaller k on
    a tie.  A size that ``capacity`` does not list counts 0 clusters, so
    with no table (a caller that wants the path alone) or a card that runs
    none (whose prepare then raises) it is the least size that fits."""
    clusters = dict(capacity)
    return max(fits, key=lambda k: (k * clusters.get(k, 0), -k))


@functools.lru_cache(maxsize=1024)
def _plan(n: int, h: int, w: int, c: int, groups: int,
          capacity: tuple = ()) -> Plan:
    """The path for an (N, C, H, W) bf16 input, by shape and ``capacity``
    (:func:`_capacity`'s table) alone: one pass with the least power-of-two
    cluster (≤ 8 blocks) whose blocks each hold their share of a sample in
    shared memory, else with the 9–16-block cluster that
    :func:`_wide_cluster` picks among those that do, else two passes."""
    cvecs = c // _VEC
    threads = (_MAX_THREADS // cvecs) * cvecs
    hw = h * w
    cluster = 1
    while cluster <= _CLUSTER_MAX:
        smem = _one_pass_smem(hw, c, groups, cluster, threads)
        if smem <= _SMEM_MAX:
            return Plan("one_pass", threads, cluster=cluster, smem=smem)
        cluster *= 2
    fits = [k for k in range(_CLUSTER_MAX + 1, _CLUSTER_WIDE + 1)
            if _one_pass_smem(hw, c, groups, k, threads) <= _SMEM_MAX]
    if fits:
        k = _wide_cluster(fits, capacity)
        return Plan("one_pass", threads, cluster=k,
                    smem=_one_pass_smem(hw, c, groups, k, threads))
    return _two_pass_plan(n, h, w, c)


def _two_pass_plan(n: int, h: int, w: int, c: int) -> Plan:
    """The two-pass forward of an (N, C, H, W) input: its plan beyond 16
    blocks and, passed to :func:`_launch`, the twin that the card tests
    and ``chip_smoke.py`` hold a 9–16-block one pass against."""
    cvecs = c // _VEC
    threads = (_MAX_THREADS // cvecs) * cvecs
    chunks, rows_per_chunk = _chunking(n, h * w, cvecs, threads)
    return Plan("two_pass", threads, chunks=chunks,
                rows_per_chunk=rows_per_chunk)


def _one_pass_bwd_smem(hw: int, c: int, groups: int, cluster: int,
                       threads: int, x_resident: bool) -> int:
    """Shared memory of one one-pass backward block, as
    ``bwd_one_pass_smem`` in ``csrc/group_norm_bwd.cu`` lays it out: the
    block's rows of dz (and of x when ``x_resident``), 2 × ``_CHUNKS``
    mbarriers, per-thread sums, this block's and the sample's per-channel
    (Σdz, Σdz·x̂), the group coefficients and the ticket's verdict."""
    rows = -(-hw // cluster)
    return (rows * c * 2 * (2 if x_resident else 1) + 2 * 8 * _CHUNKS
            + threads * _VEC * 4 + c * 4 * 4 + groups * 2 * 4 + 16)


@functools.lru_cache(maxsize=1024)
def _plan_backward(n: int, h: int, w: int, c: int, groups: int,
                   capacity: tuple = ()) -> BwdPlan:
    """The backward's path for an (N, C, H, W) bf16 input, by shape and
    ``capacity`` (:func:`_capacity`'s table) alone: one pass with the least
    power-of-two cluster (≤ 8 blocks) whose blocks hold their share of x
    and dz, else of dz alone (x then read twice), else with the 9–16-block
    cluster that :func:`_wide_cluster` picks among those whose blocks hold
    dz, else four launches."""
    cvecs = c // _VEC
    threads = (_MAX_THREADS // cvecs) * cvecs
    hw = h * w
    for x_resident in (True, False):
        cluster = 1
        while cluster <= _CLUSTER_MAX:
            smem = _one_pass_bwd_smem(hw, c, groups, cluster, threads,
                                      x_resident)
            if smem <= _SMEM_MAX:
                return BwdPlan("one_pass", threads, 1, cluster=cluster,
                               smem=smem, x_resident=x_resident)
            cluster *= 2
    fits = [k for k in range(_CLUSTER_MAX + 1, _CLUSTER_WIDE + 1)
            if _one_pass_bwd_smem(hw, c, groups, k, threads, False)
            <= _SMEM_MAX]
    if fits:
        k = _wide_cluster(fits, capacity)
        return BwdPlan("one_pass", threads, 1, cluster=k,
                       smem=_one_pass_bwd_smem(hw, c, groups, k, threads,
                                               False))
    return _four_launch_plan(n, h, w, c)


def _four_launch_plan(n: int, h: int, w: int, c: int) -> BwdPlan:
    """The four-launch backward of an (N, C, H, W) input: its plan beyond
    16 blocks and, passed to :func:`_launch_backward`, the twin that the
    card tests and ``chip_smoke.py`` hold the one pass against at the same
    shape."""
    cvecs = c // _VEC
    threads = (_MAX_THREADS // cvecs) * cvecs
    chunks, rows_per_chunk = _chunking(n, h * w, cvecs, threads)
    return BwdPlan("four_launch", threads, 4, chunks=chunks,
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


def _prepare(plan, device: int, prepare) -> None:
    """Once per kernel, device and cluster shape: raise the one-pass
    kernels' shared-memory limit and check that such a cluster fits the
    card."""
    key = (type(plan).__name__, device, plan.cluster, plan.smem)
    if key in _PREPARED:
        return
    fit = ctypes.c_int(0)
    err = prepare(plan.cluster, plan.threads, plan.smem, ctypes.byref(fit))
    _check_capacity(plan, err, fit.value)
    _PREPARED.add(key)


def _capacity(kernel: str, device: int) -> tuple:
    """``((k, clusters), ...)`` for k = 9–16: how many clusters of k blocks
    of ``_MAX_THREADS`` threads and ``_SMEM_MAX`` bytes of shared memory
    ``kernel``'s one pass (``"forward"`` or ``"backward"``) runs at once on
    ``device`` (``cudaOccupancyMaxActiveClusters``), 0 where the card
    refuses the size; read once per kernel and device, at first use.  Any
    plan beyond 8 blocks gives each block over half an SM's shared memory,
    so one block an SM, as these are: the table is every such plan's."""
    key = (kernel, device)
    table = _CAPACITY.get(key)
    if table is None:
        prepare = (_lib() if kernel == "forward" else _bwd_lib())[2]
        rows = []
        with (contextlib.nullcontext()
              if device == torch.cuda.current_device()
              else torch.cuda.device(device)):
            for k in range(_CLUSTER_MAX + 1, _CLUSTER_WIDE + 1):
                fit = ctypes.c_int(0)
                err = prepare(k, _MAX_THREADS, _SMEM_MAX, ctypes.byref(fit))
                rows.append((k, fit.value if err == 0 else 0))
        table = _CAPACITY[key] = tuple(rows)
    return table


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        from tensorflowonspark_torch.kernels import _build

        lib = _build.load("group_norm_bwd")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        one = lib.tfos_group_norm_bwd_one_pass_bf16
        one.argtypes = [p] * 10 + [i64, i64, i32, i32, i32, i32, i32, i32, p]
        four = lib.tfos_group_norm_bwd_bf16
        four.argtypes = [p] * 12 + [i64, i64, i32, i32, i32, i64, i32, p]
        prepare = lib.tfos_group_norm_bwd_one_pass_prepare
        prepare.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
        for fn in (one, four, prepare):
            fn.restype = i32
        _BWD_LIB = (one, four, prepare)
    return _BWD_LIB


@contextlib.contextmanager
def capture_scratch(held: dict):
    """While a CUDA graph is captured, keep the backward's scratch in
    ``held``, which the graph's owner keeps as long as the graph (the
    compiled step does).  A buffer allocated during a capture comes from
    the graph's memory pool, and the graph writes it at every replay: were
    it evicted from the shared cache, the pool could hand its memory to
    another tensor under a live graph.  The ``torch.zeros`` that makes a
    buffer is captured too, so each replay zeroes it first."""
    global _CAPTURE_SCRATCH
    outer, _CAPTURE_SCRATCH = _CAPTURE_SCRATCH, held
    try:
        yield held
    finally:
        _CAPTURE_SCRATCH = outer


def _bwd_scratch(device: torch.device, stream: int, n: int, c: int,
                 groups: int, plan: BwdPlan) -> torch.Tensor:
    """The backward's f32 scratch, allocated once per (device, stream, n,
    c, groups, path) and zeroed then: for ``one_pass`` the (N, C, 2)
    per-sample channel sums and ``_TICKETS`` int tickets (which each launch
    leaves at 0); for ``four_launch`` the partials (N, chunks, C, 2), the
    channel sums (N, C, 2) and the coefficients (N, G, 2).  Calls on one
    stream run in order, so they may share it.  Under
    :func:`capture_scratch` the buffers live in the capture's own dict,
    never evicted."""
    if plan.path == "one_pass":
        numel = n * c * 2 + _TICKETS
    else:
        numel = n * plan.chunks * c * 2 + n * c * 2 + n * groups * 2
    key = (device, stream, n, c, groups, plan.path)
    cache = _BWD_SCRATCH if _CAPTURE_SCRATCH is None else _CAPTURE_SCRATCH
    buf = cache.get(key)
    if buf is None or buf.numel() < numel:
        if cache is _BWD_SCRATCH and len(cache) >= _SCRATCH_KEYS:
            cache.clear()  # freed in stream order: no launch races
        buf = cache[key] = torch.zeros(numel, dtype=torch.float32,
                                       device=device)
    return buf


def _launch(x, gamma, beta, groups, eps, residual, relu, keep_stats=False,
            plan: Plan | None = None):
    """The forward on the card: ``y``, or ``(y, stats)`` with
    ``keep_stats``, ``stats`` the ``(N, G, 2)`` f32 ``(mean, rstd)``, on
    the path of ``plan``: by default :func:`_plan`'s; the card tests and
    ``chip_smoke.py`` pass :func:`_two_pass_plan` to hold the two passes
    against the one pass at the same shape."""
    global launches
    _check(x, gamma, beta, groups, residual)
    n, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    stats = (torch.empty((n, groups, 2), dtype=torch.float32,
                         device=x.device) if keep_stats else None)
    if x.numel() == 0:
        return (y, stats) if keep_stats else y
    one, two, prepare = _lib()
    device = x.device.index
    if plan is None:
        plan = _plan(n, h, w, c, groups)
        if plan.cluster > _CLUSTER_MAX:  # sized by the card's capacity
            plan = _plan(n, h, w, c, groups, _capacity("forward", device))
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


def _launch_backward(dy, x, y, gamma, stats, groups, residual, relu,
                     plan: BwdPlan | None = None):
    """The backward on the card: ``(dx, d_residual or None, dγ, dβ)``, on
    the path of ``plan``: by default :func:`_plan_backward`'s; the card
    tests and ``chip_smoke.py`` pass :func:`_four_launch_plan` to hold the
    four launches against the one pass at the same shape."""
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
    dparams = torch.empty((2, c), dtype=torch.float32, device=x.device)
    dgamma, dbeta = dparams[0], dparams[1]
    if x.numel() == 0:
        dparams.zero_()
        return dx, dres, dgamma, dbeta
    one, four, prepare = _bwd_lib()
    device = x.device.index
    if plan is None:
        plan = _plan_backward(n, h, w, c, groups)
        if plan.cluster > _CLUSTER_MAX:  # sized by the card's capacity
            plan = _plan_backward(n, h, w, c, groups,
                                  _capacity("backward", device))
    ptrs = (dy.data_ptr(), x.data_ptr(), y.data_ptr() if relu else None,
            gamma.data_ptr(), stats.data_ptr(), dx.data_ptr(),
            dres.data_ptr() if residual else None)
    with (contextlib.nullcontext() if device == torch.cuda.current_device()
          else torch.cuda.device(device)):
        stream = torch._C._cuda_getCurrentRawStream(device)
        scratch = _bwd_scratch(x.device, stream, n, c, groups, plan)
        base = scratch.data_ptr()
        if plan.path == "one_pass":
            _prepare(plan, device, prepare)
            err = one(*ptrs, dparams.data_ptr(), base, base + n * c * 2 * 4,
                      n, h * w, c, groups, plan.cluster, plan.smem,
                      int(plan.x_resident), int(bool(relu)), stream)
        else:
            chan = base + n * plan.chunks * c * 2 * 4
            err = four(*ptrs, dgamma.data_ptr(), dbeta.data_ptr(), base,
                       chan, chan + n * c * 2 * 4, n, h * w, c, groups,
                       plan.chunks, plan.rows_per_chunk, int(bool(relu)),
                       stream)
    if err != 0:
        raise RuntimeError(f"group_norm_act backward kernel ({plan.path}) "
                           f"launch failed: CUDA error {err}")
    launches += 1
    launches_by_path["backward_" + plan.path] += 1
    return dx, dres, dgamma, dbeta
