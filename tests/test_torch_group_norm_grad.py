"""Gradients of the port's fused GroupNorm(+add)(+ReLU) against JAX's.

The JAX package differentiates flax ``nn.GroupNorm`` (+ the block-end add)
(+ ``nn.relu``) with ``jax.value_and_grad``; here ``jax.vjp`` of the same
function gives the reference gradients.  On the CPU the port's backward is
``group_norm_act_backward_plain`` (the backward kernel's arithmetic as
tensor ops), reached through the ``autograd.Function`` the wrapper uses
whenever a gradient is wanted; the CUDA kernel is held against that plain
twin on the card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
Inputs are NHWC, drawn with numpy from a seed, and fed to both packages.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch.kernels import group_norm

EPS = 1e-6  # flax nn.GroupNorm default

#: (N, H, W, C, groups), as the forward's parity test
SHAPES = [(2, 8, 8, 64, 32), (2, 7, 7, 2048, 32), (3, 5, 6, 12, 4)]
MODES = [(False, True), (True, True), (False, False)]  # (residual, relu)
MODE_IDS = ["relu", "add_relu", "plain"]
#: f32: the same arithmetic summed in another order; bf16: flax rounds
#: the forward's and the backward's intermediates to bf16, the port
#: computes in f32 and rounds each gradient once (rel L2, as the forward)
F32_TOL = 1e-5
BF16_REL_L2 = 2e-2


def _draw(shape, residual, relu):
    n, h, w, c, _ = shape
    rng = np.random.RandomState(c + 7 * residual + 3 * relu)
    x = (rng.randn(n, h, w, c) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.5 * rng.randn(c)).astype(np.float32)
    beta = (0.5 * rng.randn(c)).astype(np.float32)
    res = rng.randn(n, h, w, c).astype(np.float32) if residual else None
    dy = rng.randn(n, h, w, c).astype(np.float32)
    return x, gamma, beta, res, dy


def _flax_grads(x, gamma, beta, res, dy, groups, relu, dtype):
    """(dx, d_residual, dγ, dβ) from ``jax.vjp``, and the forward's output,
    as float32 numpy, NHWC."""
    def f(x, gamma, beta, res):
        y = nn.GroupNorm(num_groups=groups, epsilon=EPS, dtype=dtype).apply(
            {"params": {"scale": gamma, "bias": beta}}, x)
        if res is not None:
            y = res + y
        return nn.relu(y) if relu else y

    args = (jnp.asarray(x, dtype), jnp.asarray(gamma), jnp.asarray(beta),
            None if res is None else jnp.asarray(res, dtype))
    y, vjp = jax.vjp(f, *args)
    dx, dgamma, dbeta, dres = vjp(jnp.asarray(dy, y.dtype))
    return tuple(None if g is None else np.array(g.astype(jnp.float32))
                 for g in (dx, dres, dgamma, dbeta)), np.array(
                     y.astype(jnp.float32))


def _nchw(a, dtype, grad=False):
    t = torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2).detach()
    return t.requires_grad_() if grad else t


def _nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1).float().numpy()


def _port_plain(x, gamma, beta, res, dy, groups, relu, dtype, y=None):
    """(dx, d_residual, dγ, dβ) from ``group_norm_act_backward_plain``; its
    ReLU mask from ``y`` (NHWC) when given, else from the port's own
    forward."""
    xt = _nchw(x, dtype)
    rt = None if res is None else _nchw(res, dtype)
    own_y, stats = group_norm._plain_forward(
        xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups, EPS, rt,
        relu)
    y = own_y if y is None else _nchw(y, dtype)
    dx, dres, dgamma, dbeta = group_norm.group_norm_act_backward_plain(
        _nchw(dy, dtype), xt, y, torch.from_numpy(gamma), stats, groups,
        res is not None, relu)
    assert dx.dtype == dtype and dx.is_contiguous(
        memory_format=torch.channels_last)
    assert dgamma.dtype == dbeta.dtype == torch.float32
    return _nhwc(dx), _nhwc(dres), dgamma.numpy(), dbeta.numpy()


def _port_autograd(fn, x, gamma, beta, res, dy, groups, relu, dtype):
    """(dx, d_residual, dγ, dβ) from autograd through ``fn``."""
    xt = _nchw(x, dtype, grad=True)
    rt = None if res is None else _nchw(res, dtype, grad=True)
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    y = fn(xt, gt, bt, groups, EPS, rt, relu)
    assert y.grad_fn is not None
    y.backward(_nchw(dy, dtype))
    return (_nhwc(xt.grad), _nhwc(None if rt is None else rt.grad),
            gt.grad.numpy(), bt.grad.numpy())


def _close_f32(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, rtol=F32_TOL,
                                       atol=F32_TOL * np.abs(w).max())


@pytest.mark.parametrize("residual,relu", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_plain_matches_autograd_of_the_plain_forward(shape, residual,
                                                              relu):
    """The hand-derived backward against torch's autograd of the plain
    forward, in f32."""
    x, gamma, beta, res, dy = _draw(shape, residual, relu)
    args = (x, gamma, beta, res, dy, shape[-1], relu, torch.float32)
    _close_f32(_port_plain(*args),
               _port_autograd(group_norm.group_norm_act_plain, *args))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual,relu", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradients_match_flax(shape, residual, relu, dtype):
    """The plain backward, and autograd through the wrapper's
    ``autograd.Function``, against ``jax.vjp`` of flax's GroupNorm.

    In bf16 the two forwards round at different places (flax rounds the
    norm's output, then the add; the port rounds once), so an element whose
    pre-ReLU value lies within a rounding of 0 can be on either side of the
    mask.  The bf16 comparison therefore gives the port's backward flax's
    forward output as its ``y``: it holds the backward's arithmetic to
    JAX's on the same mask."""
    x, gamma, beta, res, dy = _draw(shape, residual, relu)
    groups = shape[-1]
    want, flax_y = _flax_grads(x, gamma, beta, res, dy, groups, relu,
                               getattr(jnp, dtype))
    args = (x, gamma, beta, res, dy, groups, relu, getattr(torch, dtype))
    plain = _port_plain(*args)
    through_function = _port_autograd(group_norm.group_norm_act, *args)
    for a, b in zip(plain, through_function):  # the same arithmetic
        assert (a is None and b is None) or np.array_equal(a, b)
    if dtype == "float32":
        _close_f32(plain, want)
        return
    for g, w in zip(_port_plain(*args, y=flax_y), want):
        assert (g is None) == (w is None)
        if w is not None:
            assert np.linalg.norm(g - w) <= BF16_REL_L2 * np.linalg.norm(w)


def test_no_gradient_wanted_takes_the_inference_path():
    """Without an input that requires a gradient (or under no_grad) the
    wrapper returns a plain tensor: nothing is saved for a backward."""
    x, gamma, beta, _, _ = _draw(SHAPES[0], False, True)
    xt = _nchw(x, torch.float32)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    assert group_norm.group_norm_act(xt, g, b, 32, EPS).grad_fn is None
    with torch.no_grad():
        y = group_norm.group_norm_act(xt, g.requires_grad_(), b, 32, EPS)
    assert y.grad_fn is None
