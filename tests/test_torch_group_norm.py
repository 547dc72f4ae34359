"""The fused GroupNorm(+add)(+ReLU) of the port against flax ``nn.GroupNorm``.

On the CPU the wrapper runs the kernel's plain twin (the CUDA kernel runs
only on the card, where ``chip_smoke.py`` holds it against that twin).
Inputs are NHWC, drawn with numpy from a seed, and fed to both packages.
"""

import os

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch.kernels import _build, group_norm

EPS = 1e-6  # flax nn.GroupNorm default

#: (N, H, W, C, groups): 2 channels per group (the ResNet stem), 64 per
#: group at 7x7 (the last stage), and a ragged 3 per group
SHAPES = [(2, 8, 8, 64, 32), (2, 7, 7, 2048, 32), (3, 5, 6, 12, 4)]
MODES = [(False, True), (True, True), (False, False)]  # (residual, relu)


def _flax(x, gamma, beta, groups, residual, relu, dtype):
    y = nn.GroupNorm(num_groups=groups, dtype=dtype).apply(
        {"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x, dtype))
    if residual is not None:
        y = jnp.asarray(residual, dtype) + y
    if relu:
        y = nn.relu(y)
    return np.asarray(y.astype(jnp.float32))


def _port(x, gamma, beta, groups, residual, relu, dtype):
    def t(a):
        return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)

    y = group_norm.group_norm_act(
        t(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, EPS,
        None if residual is None else t(residual), relu)
    assert y.dtype == dtype and y.shape == t(x).shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    return y.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual,relu", MODES,
                         ids=["relu", "add_relu", "plain"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_flax_group_norm(shape, residual, relu, dtype):
    n, h, w, c, groups = shape
    rng = np.random.RandomState(c + 7 * residual + 3 * relu)
    x = (rng.randn(n, h, w, c) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.5 * rng.randn(c)).astype(np.float32)
    beta = (0.5 * rng.randn(c)).astype(np.float32)
    res = rng.randn(n, h, w, c).astype(np.float32) if residual else None
    ref = _flax(x, gamma, beta, groups, res, relu, getattr(jnp, dtype))
    got = _port(x, gamma, beta, groups, res, relu, getattr(torch, dtype))
    if dtype == "float32":
        # same f32 arithmetic, summed in another order
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        # the port rounds once; flax rounds the norm's output and then the
        # add: at most 2 bf16 ulps apart (one ulp is 2^-7 of the magnitude)
        tol = 2 * 2.0 ** -7 * np.maximum(1.0, np.abs(ref))
        assert np.all(np.abs(got - ref) <= tol), np.abs(got - ref).max()


def test_wrapper_raises_off_cpu_and_cuda():
    x = torch.empty((1, 8, 2, 2), device="meta")
    g = torch.ones(8)
    with pytest.raises(RuntimeError, match="not supported"):
        group_norm.group_norm_act(x, g, g, 2, EPS)


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("case,error", [
    (dict(x=_cl((2, 64, 4, 4), torch.float32)), TypeError),
    (dict(x=torch.zeros((2, 64, 4, 4), dtype=torch.bfloat16)), ValueError),
    (dict(groups=5), ValueError),
    (dict(x=_cl((2, 12, 4, 4)), groups=4), ValueError),  # C % 8
    (dict(x=_cl((1, 4096, 1, 2)), groups=32), ValueError),  # C > 2048
    (dict(gamma=torch.ones(64, dtype=torch.bfloat16)), ValueError),
    (dict(residual=_cl((2, 64, 2, 2))), ValueError),
    (dict(residual=torch.zeros((2, 64, 4, 4), dtype=torch.bfloat16)),
     ValueError),
], ids=["f32", "nchw", "groups", "c_not_vec", "c_too_wide", "gamma_dtype",
        "residual_shape", "residual_layout"])
def test_kernel_input_checks_raise(case, error):
    """What the kernel does not take raises before any launch."""
    args = dict(x=_cl((2, 64, 4, 4)), gamma=torch.ones(64),
                beta=torch.zeros(64), groups=32, residual=None)
    args.update(case)
    c = args["x"].shape[1]
    if "gamma" not in case:
        args["gamma"], args["beta"] = torch.ones(c), torch.zeros(c)
    with pytest.raises(error):
        group_norm._check(args["x"], args["gamma"], args["beta"],
                          args["groups"], args["residual"])
    ok = dict(x=_cl((2, 64, 4, 4)), gamma=torch.ones(64),
              beta=torch.zeros(64), groups=32, residual=_cl((2, 64, 4, 4)))
    group_norm._check(**ok)


def test_build_module_needs_no_compiler_until_asked(monkeypatch, tmp_path):
    """The source and its build module import without a CUDA toolkit;
    building without ``nvcc`` raises instead of falling back."""
    assert "group_norm" in _build.sources()
    src = os.path.join(_build.CSRC_DIR, "group_norm.cu")
    with open(src, encoding="utf-8") as f:
        text = f.read()
    assert 'extern "C" int tfos_group_norm_act_bf16(' in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("group_norm")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert _build.source_hash("group_norm") in os.path.basename(path)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no_nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("group_norm")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()

