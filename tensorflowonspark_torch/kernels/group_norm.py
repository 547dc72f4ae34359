"""Fused GroupNorm (+ residual add) (+ ReLU), forward.

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
  :data:`launches`, or raises.  It never falls back.
- On a CPU tensor it computes :func:`group_norm_act_plain`, the same
  arithmetic as explicit tensor ops.  The CPU tests reach the function
  through that path; ``chip_smoke.py`` compares the two on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

#: Kernel launches by :func:`group_norm_act` in this process (one per call
#: that reached the CUDA kernel).  Plain int; reset by assigning 0.
launches = 0

_VEC = 8  # bf16 channels per 16-byte vector in the kernel
_MAX_THREADS = 256  # the stats pass's block size; C/8 must not exceed it
_TARGET_BLOCKS = 1024  # stats-pass blocks to aim for: ~8 per SM on 132 SMs
_LIB = None


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int, eps: float,
                         residual: torch.Tensor | None = None,
                         relu: bool = True) -> torch.Tensor:
    """The kernel's arithmetic as plain tensor ops, in f32.

    ``x`` is ``(N, C, H, W)`` in any memory format; the result has ``x``'s
    shape and dtype and is ``channels_last``."""
    n, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).float().reshape(n, h * w, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean,
                      min=0.0)
    scale = torch.rsqrt(var + eps) * gamma.float().reshape(1, 1, groups, -1)
    y = (xf - mean) * scale + beta.float().reshape(1, 1, groups, -1)
    y = y.reshape(n, h, w, c)
    if residual is not None:
        y = y + residual.permute(0, 2, 3, 1).float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 3, 1, 2)


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float,
                   residual: torch.Tensor | None = None,
                   relu: bool = True) -> torch.Tensor:
    """``act(GN(x) * gamma + beta + residual)``; see the module docstring.

    ``x`` (and ``residual``) are ``(N, C, H, W)``; on the card they must be
    bf16 and ``channels_last``-contiguous, ``gamma``/``beta`` f32 ``(C,)``.
    """
    if x.device.type == "cpu":
        return group_norm_act_plain(x, gamma, beta, groups, eps, residual,
                                    relu)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"group_norm_act: tensors on {x.device} are not supported "
            "(cpu takes the plain path, cuda the kernel)")
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


def _lib():
    global _LIB
    if _LIB is None:
        from tensorflowonspark_torch.kernels import _build

        lib = _build.load("group_norm")
        fn = lib.tfos_group_norm_act_bf16
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i64, i64, i32, i32, i32, i64,
                       ctypes.c_float, i32, p]
        fn.restype = i32
        _LIB = fn
    return _LIB


def _launch(x, gamma, beta, groups, eps, residual, relu) -> torch.Tensor:
    global launches
    _check(x, gamma, beta, groups, residual)
    n, c, h, w = x.shape
    hw = h * w
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return y
    rows_per_iter = _MAX_THREADS // (c // _VEC)
    chunks = max(1, min(math.ceil(hw / rows_per_iter),
                        math.ceil(_TARGET_BLOCKS / n)))
    rows_per_chunk = math.ceil(hw / chunks)
    chunks = math.ceil(hw / rows_per_chunk)
    partials = torch.empty((n, chunks, groups, 2), dtype=torch.float32,
                           device=x.device)
    stats = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 partials.data_ptr(), stats.data_ptr(), n, hw, c, groups,
                 chunks, rows_per_chunk, float(eps), int(bool(relu)), stream)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y
