"""The CUDA kernels of the port on the card, against their plain twins.

Needs a CUDA card (the kernels have no CPU mode) and skips without one.
It imports nothing of JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels_cuda.py`` from the repository root.
"""

import pytest
import torch

from tensorflowonspark_torch.kernels import group_norm

EPS = 1e-6
MODES = [(False, True), (True, True), (False, False)]  # (residual, relu)


def _inputs(shape, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]

    def draw():
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, res = draw(), draw()
    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    return x, res, gamma, beta


def _check_modes(shape, groups, path):
    """All three modes against the plain twin within 2 bf16 ulps, each
    launched on ``path``."""
    x, res, gamma, beta = _inputs(shape)
    n, c, h, w = shape
    assert group_norm._plan(n, h, w, c, groups).path == path
    before = group_norm.launches
    by_path = dict(group_norm.launches_by_path)
    for residual, relu in MODES:
        r = res if residual else None
        got = group_norm.group_norm_act(x, gamma, beta, groups, EPS, r, relu)
        ref = group_norm.group_norm_act_plain(x, gamma, beta, groups, EPS, r,
                                              relu)
        torch.cuda.synchronize()
        tol = 2 * 2.0 ** -7 * torch.clamp(ref.float().abs(), min=1.0)
        assert torch.all((got.float() - ref.float()).abs() <= tol)
    assert group_norm.launches == before + len(MODES)
    assert group_norm.launches_by_path[path] == by_path[path] + len(MODES)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 56, 56), (4, 2048, 7, 7),
                                   (3, 24, 5, 6)], ids=["stem", "last", "odd"])
def test_kernel_matches_plain_twin_on_card(shape):
    """All three modes at the stem's and the last stage's widths, and at
    3 channels per group with C/8 not a power of two: one-pass clusters of
    2, 2 and 1 blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_modes(shape, 8, "one_pass")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,path", [
    ((2, 64, 112, 112), 32, "one_pass"),  # cluster of 8, the stem
    ((2, 256, 56, 56), 32, "one_pass"),  # cluster of 8, stage 1 output
    ((2, 24, 181, 181), 8, "one_pass"),  # ragged ranks, 3 per group
    ((2, 64, 224, 224), 32, "two_pass"),  # 6.4 MB a sample
    ((2, 24, 250, 250), 8, "two_pass"),  # 3 per group
], ids=["stem_cluster8", "stage1_cluster8", "ragged_cluster8", "oversize",
        "oversize_odd"])
def test_both_paths_match_plain_twin_on_card(shape, groups, path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_modes(shape, groups, path)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 64, 112, 112), (8, 2048, 7, 7),
                                   (2, 64, 224, 224)],
                         ids=["cluster8", "cluster2", "two_pass"])
def test_kernel_gives_the_same_bits_twice(shape):
    """No float atomics on either path: the same input, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, res, gamma, beta = _inputs(shape, seed=1)
    first = group_norm.group_norm_act(x, gamma, beta, 32, EPS, res, True)
    second = group_norm.group_norm_act(x, gamma, beta, 32, EPS, res, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


BWD_MODES = [(False, True), (True, True), (False, False), (True, False)]


def _check_backward(shape, groups, seed=0):
    """Every mode: the backward kernel's dx and d_residual within 2 bf16
    ulps of max(1, max|plain|) of the plain twin, dγ and dβ within rel L2
    1e-3, each backward one kernel launch."""
    x, res, gamma, beta = _inputs(shape, seed)
    dy = _inputs(shape, seed + 1)[0]
    for residual, relu in BWD_MODES:
        r = res if residual else None
        y, stats = group_norm._launch(x, gamma, beta, groups, EPS, r, relu,
                                      keep_stats=True)
        before = group_norm.launches_by_path["backward"]
        got = group_norm._launch_backward(dy, x, y, gamma, stats, groups,
                                          residual, relu)
        want = group_norm.group_norm_act_backward_plain(
            dy, x, y, gamma, stats, groups, residual, relu)
        torch.cuda.synchronize()
        assert group_norm.launches_by_path["backward"] == before + 1
        for g, w in zip(got[:2], want[:2]):
            assert (g is None) == (w is None)
            if w is None:
                continue
            assert g.is_contiguous(memory_format=torch.channels_last)
            tol = 2 * 2.0 ** -7 * max(1.0, float(w.float().abs().max()))
            assert float((g.float() - w.float()).abs().max()) <= tol
        for g, w in zip(got[2:], want[2:]):
            assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) \
                <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [
    ((4, 64, 56, 56), 32), ((4, 2048, 7, 7), 32), ((3, 24, 5, 6), 8),
    ((2, 256, 56, 56), 32)], ids=["stem", "last", "odd", "stage1"])
def test_backward_kernel_matches_plain_twin_on_card(shape, groups):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_backward(shape, groups)


@pytest.mark.cuda
def test_backward_kernel_gives_the_same_bits_twice():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, res, gamma, beta = _inputs((8, 256, 28, 28), seed=2)
    dy = _inputs((8, 256, 28, 28), seed=3)[0]
    y, stats = group_norm._launch(x, gamma, beta, 32, EPS, res, True,
                                  keep_stats=True)
    first = group_norm._launch_backward(dy, x, y, gamma, stats, 32, True,
                                        True)
    second = group_norm._launch_backward(dy, x, y, gamma, stats, 32, True,
                                         True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_forward_with_grad_reaches_upstream_conv_weight():
    """A CUDA call whose inputs require a gradient has a ``grad_fn``, and
    the gradient reaches the weight of the conv before it (through the
    backward kernel), for x, the residual, γ and β."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    image = torch.randn(2, 16, 12, 12, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    weight = torch.randn(32, 16, 3, 3, generator=gen, device="cuda",
                         requires_grad=True)
    res = torch.randn(2, 32, 12, 12, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    res.requires_grad_()
    gamma = torch.ones(32, device="cuda", requires_grad=True)
    beta = torch.zeros(32, device="cuda", requires_grad=True)
    x = torch.nn.functional.conv2d(
        image, weight.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), padding=1)
    before = dict(group_norm.launches_by_path)
    y = group_norm.group_norm_act(x, gamma, beta, 8, EPS, res, True)
    assert y.grad_fn is not None
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert group_norm.launches_by_path["one_pass"] == before["one_pass"] + 1
    assert group_norm.launches_by_path["backward"] == before["backward"] + 1
    for t in (weight, res, gamma, beta):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.float().abs().sum()) > 0
