"""The CUDA kernels of the port on the card, against their plain twins:
the fused GroupNorm forward and backward, the AdaGrad table update, and
the decode tier's paged K/V append and attention (with the decode engine
that runs them inside CUDA graphs).

Needs a CUDA card (the kernels have no CPU mode) and skips without one.
It imports nothing of JAX, so it also runs where JAX is not installed:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels_cuda.py`` from the repository root.
"""

import pytest
import torch

import chip_smoke
from tensorflowonspark_torch import embedding
from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad

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


def _check_modes(shape, groups, path, plan=None):
    """All three modes against the plain twin within 2 bf16 ulps, each
    launched on ``path``, the planned one, or on ``plan``'s path where a
    plan is forced."""
    x, res, gamma, beta = _inputs(shape)
    n, c, h, w = shape
    assert group_norm._plan(n, h, w, c, groups).path == path
    launched = plan.path if plan else path
    before = group_norm.launches
    by_path = dict(group_norm.launches_by_path)
    for residual, relu in MODES:
        r = res if residual else None
        if plan is None:
            got = group_norm.group_norm_act(x, gamma, beta, groups, EPS, r,
                                            relu)
        else:
            got = group_norm._launch(x, gamma, beta, groups, EPS, r, relu,
                                     plan=plan)
        ref = group_norm.group_norm_act_plain(x, gamma, beta, groups, EPS, r,
                                              relu)
        torch.cuda.synchronize()
        tol = 2 * 2.0 ** -7 * torch.clamp(ref.float().abs(), min=1.0)
        assert torch.all((got.float() - ref.float()).abs() <= tol)
    assert group_norm.launches == before + len(MODES)
    assert (group_norm.launches_by_path[launched]
            == by_path[launched] + len(MODES))


#: Inception-v3's stem samples that no cluster of 8 holds, at batch 16:
#: one pass over a non-portable cluster of 9–16 blocks
STEM = [(16, 64, 147, 147), (16, 192, 71, 71), (16, 64, 150, 150),
        (16, 192, 75, 75)]
STEM_IDS = ["canonical_147x64", "canonical_71x192", "same_150x64",
            "same_75x192"]


def _card_cluster(shape, groups, backward=False):
    """The cluster of the plan the wrapper takes on this card."""
    n, c, h, w = shape
    device = torch.cuda.current_device()
    if backward:
        return group_norm._plan_backward(n, h, w, c, groups,
                                         group_norm._capacity(
                                             "backward", device)).cluster
    return group_norm._plan(n, h, w, c, groups, group_norm._capacity(
        "forward", device)).cluster


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
    ((2, 24, 360, 360), 8, "two_pass"),  # 3 per group, beyond 16 blocks
] + [(shape, 32, "one_pass") for shape in STEM],
    ids=["stem_cluster8", "stage1_cluster8", "ragged_cluster8", "oversize",
         "oversize_odd"] + STEM_IDS)
def test_both_paths_match_plain_twin_on_card(shape, groups, path):
    """Each path on its planned shapes; Inception's stem samples over 9–16
    blocks, the same bits twice, and their forced two-pass twin held to
    the plain twin the same way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_modes(shape, groups, path)
    if shape in STEM:
        n, c, h, w = shape
        assert 9 <= _card_cluster(shape, groups) <= 16
        _check_modes(shape, groups, path,
                     plan=group_norm._two_pass_plan(n, h, w, c))
        x, res, gamma, beta = _inputs(shape, seed=1)
        first = group_norm.group_norm_act(x, gamma, beta, 32, EPS, res, True)
        second = group_norm.group_norm_act(x, gamma, beta, 32, EPS, res,
                                           True)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


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


def _check_backward(shape, groups, seed=0, path="one_pass", modes=None,
                    plan=None):
    """Every mode: the backward kernel's dx and d_residual within 2 bf16
    ulps of max(1, max|plain|) of the plain twin, dγ and dβ within rel L2
    1e-3, each backward one wrapper call counted on ``path``, the planned
    one, or on ``plan``'s path where a plan is forced."""
    x, res, gamma, beta = _inputs(shape, seed)
    dy = _inputs(shape, seed + 1)[0]
    n, c, h, w = shape
    assert group_norm._plan_backward(n, h, w, c, groups).path == path
    launched = plan.path if plan else path
    for residual, relu in modes or BWD_MODES:
        r = res if residual else None
        y, stats = group_norm._launch(x, gamma, beta, groups, EPS, r, relu,
                                      keep_stats=True)
        before = dict(group_norm.launches_by_path)
        got = group_norm._launch_backward(dy, x, y, gamma, stats, groups,
                                          residual, relu, plan)
        want = group_norm.group_norm_act_backward_plain(
            dy, x, y, gamma, stats, groups, residual, relu)
        torch.cuda.synchronize()
        took = {k: v - before[k]
                for k, v in group_norm.launches_by_path.items()}
        assert took == {k: int(k == "backward_" + launched) for k in took}
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
@pytest.mark.parametrize("shape,modes,path,x_resident,forced", [
    ((4, 64, 56, 56), BWD_MODES, "one_pass", True, False),
    ((8, 256, 56, 56), [(True, True)], "one_pass", False, False),
    ((2, 64, 224, 224), [(True, True), (False, False)], "four_launch", False,
     False),
    ((8, 256, 56, 56), [(True, True), (False, False)], "one_pass", False,
     True),
] + [(shape, BWD_MODES, "one_pass", False, forced)
     for forced in (False, True) for shape in STEM],
    ids=["x_resident", "x_streamed", "four_launch", "four_launch_forced"]
    + STEM_IDS + [i + "_four_launch_forced" for i in STEM_IDS])
def test_both_backward_paths_match_plain_twin_on_card(shape, modes, path,
                                                      x_resident, forced):
    """The one-pass kernel with x in shared memory and with x streamed
    (8×256×56×56 GN+add+ReLU, a cluster of 8; Inception's stem samples
    over 9–16 blocks), the four-launch kernels at the oversize shape on
    their planned path, and forced where the plan takes one pass (the twin
    ``chip_smoke.py`` times the one pass against); the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, c, h, w = shape
    assert group_norm._plan_backward(n, h, w, c, 32).x_resident == x_resident
    if shape in STEM:
        assert 9 <= _card_cluster(shape, 32, backward=True) <= 16
    plan = group_norm._four_launch_plan(n, h, w, c) if forced else None
    _check_backward(shape, 32, seed=5, path=path, modes=modes, plan=plan)
    x, res, gamma, beta = _inputs(shape, seed=6)
    dy = _inputs(shape, seed=7)[0]
    y, stats = group_norm._launch(x, gamma, beta, 32, EPS, res, True,
                                  keep_stats=True)
    first = group_norm._launch_backward(dy, x, y, gamma, stats, 32, True,
                                        True, plan)
    second = group_norm._launch_backward(dy, x, y, gamma, stats, 32, True,
                                         True, plan)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


#: Inception-v3's channels per group (its ``gn_groups``: the largest
#: divisor of C up to 32), each at its width C = 32 x cpg: where 8 % cpg
#: and cpg % 8 are both nonzero, one 16-byte vector of 8 channels holds
#: two or three groups
INCEPTION_CPG = [1, 3, 5, 6, 10, 12, 14, 24]


@pytest.mark.cuda
@pytest.mark.parametrize("cpg", INCEPTION_CPG)
def test_inception_group_widths_forward_and_backward_on_card(cpg):
    """Forward (every mode) and backward (every mode) at 17²×(32·cpg),
    32 groups: the kernels against their plain twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape = (2, 32 * cpg, 17, 17)
    _check_modes(shape, 32, "one_pass")
    _check_backward(shape, 32, seed=cpg)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 147, 147), (2, 192, 71, 71),
                                   (2, 64, 150, 150), (2, 192, 75, 75)],
                         ids=["canonical_147x64", "canonical_71x192",
                              "same_150x64", "same_75x192"])
def test_inception_stem_sites_take_a_wide_cluster_on_card(shape):
    """The Inception stem's samples that no cluster of 8 holds, at 2
    samples: one pass over 9–16 blocks, forward and backward, on their
    planned paths against the plain twins (GN+ReLU, as the model calls
    them, and GN alone), and within 2 bf16 ulps of the two-pass and
    four-launch twins, forced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, c, h, w = shape
    assert 9 <= _card_cluster(shape, 32) <= 16
    _check_modes(shape, 32, "one_pass")
    _check_backward(shape, 32, seed=11, path="one_pass",
                    modes=[(False, True), (False, False)])
    x, _, gamma, beta = _inputs(shape, seed=12)
    dy = _inputs(shape, seed=13)[0]
    y, stats = group_norm._launch(x, gamma, beta, 32, EPS, None, True,
                                  keep_stats=True)
    twin, twin_stats = group_norm._launch(
        x, gamma, beta, 32, EPS, None, True, keep_stats=True,
        plan=group_norm._two_pass_plan(n, h, w, c))
    got = group_norm._launch_backward(dy, x, y, gamma, stats, 32, False, True)
    want = group_norm._launch_backward(
        dy, x, y, gamma, stats, 32, False, True,
        group_norm._four_launch_plan(n, h, w, c))
    torch.cuda.synchronize()
    for a, b in ((y, twin), (got[0], want[0])):
        tol = 2 * 2.0 ** -7 * max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= tol
    assert torch.allclose(stats, twin_stats, rtol=1e-4, atol=1e-5)
    for a, b in zip(got[2:], want[2:]):
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [
    ((4, 768, 1, 1), 32), ((4, 128, 5, 5), 32), ((3, 32, 149, 149), 32),
    ((3, 32, 147, 147), 32), ((3, 80, 73, 73), 20), ((3, 48, 35, 35), 24),
    ((3, 160, 17, 17), 32), ((3, 448, 8, 8), 32)],
    ids=["aux_1x1", "aux_5x5", "149", "147", "73", "35", "17", "8"])
def test_one_pass_cluster_split_at_inception_sizes_on_card(shape, groups):
    """The aux head's one-pixel and 25-pixel samples (a cluster wider than
    the sample's rows) and odd spatial sizes at N > 1 (a last block with
    fewer rows): one pass, forward and backward, against the plain
    twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_modes(shape, groups, "one_pass")
    _check_backward(shape, groups, seed=3)


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
    assert (group_norm.launches_by_path["backward_one_pass"]
            == before["backward_one_pass"] + 1)
    for t in (weight, res, gamma, beta):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.float().abs().sum()) > 0


@pytest.mark.cuda
def test_group_norm_op_is_the_kernel_on_card():
    """``torch.ops.tfos.group_norm_act`` (what an exported program calls)
    launches the same kernel as ``group_norm_act``: the same bits at a
    ResNet-50 site, one counted launch a call; its fake returns the
    kernel's shape, dtype and channels_last strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, res, gamma, beta = _inputs((8, 256, 56, 56), seed=5)
    before = group_norm.launches_by_path["one_pass"]
    got = torch.ops.tfos.group_norm_act(x, gamma, beta, 32, EPS, res, True)
    want = group_norm.group_norm_act(x, gamma, beta, 32, EPS, res, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert group_norm.launches_by_path["one_pass"] == before + 2
    assert got.stride() == want.stride()
    with FakeTensorMode() as mode:
        fake = torch.ops.tfos.group_norm_act(
            mode.from_tensor(x), mode.from_tensor(gamma),
            mode.from_tensor(beta), 32, EPS, None, True)
    assert (fake.shape, fake.dtype, fake.stride()) == (
        want.shape, want.dtype, want.stride())


# --- the AdaGrad table update (csrc/sparse_adagrad.cu) ---------------------

#: |kernel - plain| <= this x max|plain| over the touched rows: f32, and
#: only the order of the duplicates' sums differs (the plain version's
#: index_add_ uses atomics on the card), besides torch.rsqrt's ulps.  The
#: plain version run on the CPU adds in batch order, as the kernel does:
#: there the gate is bit for bit (see chip_smoke.TABLE_TOL_REL for the one
#: case, a row that takes every occurrence, where the atomic order alone
#: moves the card's plain version past this).
TABLE_TOL_REL = 1e-5
CONFIG_VOCAB = 26 * 100_000  # widedeep.Config()'s fused table


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _table_case(vocab, row, ids_shape, id_dtype, dups, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randn(vocab, *row, generator=gen, device="cuda")
    acc = torch.rand(vocab, *row, generator=gen, device="cuda")
    n = int(torch.tensor(ids_shape).prod())
    ids = (torch.randint(0, max(1, vocab // 8), (n,), generator=gen,
                         device="cuda") if dups
           else torch.randperm(vocab, generator=gen, device="cuda")[:n])
    ids = ids.reshape(ids_shape).to(id_dtype)
    g = torch.randn(*ids_shape, *row, generator=gen, device="cuda")
    return table, acc, ids, g


def _check_tables(tables, ids, grads, combine, atomic_gate=True):
    """The table path twice on copies: one grouping and one update launch a
    call, the same bits twice, bit for bit the plain version run on the
    CPU, within ``TABLE_TOL_REL`` of the plain version on the card (unless
    ``atomic_gate`` is false), untouched rows bit-identical."""
    path = "combine" if combine else "sparse"
    rows = tables[0][0].shape[0]
    flat = embedding.wrap_ids(ids.reshape(-1).long(), rows)
    touched = torch.zeros(rows, dtype=torch.bool, device="cuda")
    touched[flat[(flat >= 0) & (flat < rows)]] = True
    outs = []
    for _ in range(2):
        pairs = [(t.clone(), a.clone()) for t, a in tables]
        before = dict(sparse_adagrad.launches_by_path)
        if len(pairs) == 1:
            assert embedding.sparse_adagrad_update(
                *pairs[0], ids, grads[0], 0.1, combine=combine) == pairs[0]
        else:
            assert embedding.sparse_adagrad_update_tables(
                pairs, ids, grads, 0.1, combine=combine) == pairs
        torch.cuda.synchronize()
        assert sparse_adagrad.launches_by_path == {
            **before, "group": before["group"] + 1, path: before[path] + 1}
        outs.append(pairs)
    got, again = outs
    touched_rows, cpu = chip_smoke.plain_on_cpu_rows(tables, ids, grads, 0.1,
                                                     combine)
    for (t1, a1), (t2, a2), (tc, ac), (t0, a0), g in zip(got, again, cpu,
                                                         tables, grads):
        assert torch.equal(t1, t2) and torch.equal(a1, a2)
        assert torch.equal(t1[touched_rows].cpu(), tc)
        assert torch.equal(a1[touched_rows].cpu(), ac)
        tp, ap = embedding.sparse_adagrad_update_plain(
            t0.clone(), a0.clone(), ids, g, 0.1, combine=combine)
        for x, want, orig in ((t1, tp, t0), (a1, ap, a0)):
            x2, want2 = x.reshape(rows, -1), want.reshape(rows, -1)
            err = (x2 - want2).abs()[touched].max()
            assert (err <= TABLE_TOL_REL * want2.abs()[touched].max()
                    or not atomic_gate)
            moved = (x != orig).reshape(rows, -1).any(dim=1)
            assert not bool((moved & ~touched).any())
            assert bool(moved[touched].any())


def _zipf_ids(n, seed=0):
    import numpy as np

    cat = chip_smoke.criteo_ids(np.random.RandomState(seed), n, 100_000,
                                chip_smoke.WD_ZIPF)
    return (torch.from_numpy(cat).cuda()
            + torch.arange(26, device="cuda") * 100_000)


def _grouping_case(name):
    gen = torch.Generator(device="cuda").manual_seed(3)
    if name == "empty":
        return torch.zeros(0, dtype=torch.int32, device="cuda"), 64
    if name == "one":
        return torch.tensor([5], dtype=torch.int32, device="cuda"), 64
    if name == "all_equal":
        return torch.full((26_624,), 1_234_567, dtype=torch.int32,
                          device="cuda"), CONFIG_VOCAB
    if name == "all_out_of_range":
        return torch.tensor([64, 99, -65, -1000] * 50, dtype=torch.int64,
                            device="cuda"), 64
    if name == "negatives_wrap":
        ids = torch.randint(-64, 64, (3000,), generator=gen, device="cuda")
        ids[::11] = 64  # and some dropped
        return ids.int(), 64
    if name == "int64_rows":
        return torch.randint(0, CONFIG_VOCAB, (26_624,), generator=gen,
                             device="cuda"), CONFIG_VOCAB
    if name == "int32_rows":
        return torch.randint(0, CONFIG_VOCAB, (26_624,), generator=gen,
                             device="cuda").int(), CONFIG_VOCAB
    if name == "zipf_8_ranks":
        return _zipf_ids(8 * 1024).reshape(-1).int(), CONFIG_VOCAB
    return torch.randint(0, 5, (1000,), generator=gen, device="cuda"), 5


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "empty", "one", "all_equal", "all_out_of_range", "negatives_wrap",
    "int64_rows", "int32_rows", "zipf_8_ranks", "vocab_5"])
def test_grouping_equals_sort_ids_on_card(name):
    """The grouping kernel's outputs equal ``sort_ids`` of the same ids bit
    for bit (through ``group_ids_plain``): in-range occurrences, dropped
    tail, segment starts, counts; the same bits twice; one launch."""
    _needs_card()
    ids, vocab = _grouping_case(name)
    before = sparse_adagrad.launches_by_path["group"]
    got = [embedding.group_ids(ids, vocab) for _ in range(2)]
    torch.cuda.synchronize()
    assert sparse_adagrad.launches_by_path["group"] == before + 2
    assert chip_smoke.grouping_matches(got[0], ids, vocab)
    assert chip_smoke.grouping_matches(got[1], ids, vocab)


@pytest.mark.cuda
def test_grouping_rejects_what_it_does_not_take():
    """A vocab whose out-of-range key would not fit int32, or more ids than
    int32 positions, raises before any launch; nothing falls back."""
    _needs_card()
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    before = dict(sparse_adagrad.launches_by_path)
    with pytest.raises(ValueError, match="vocab"):
        embedding.group_ids(ids, 2**31)
    with pytest.raises(ValueError, match="at most"):
        sparse_adagrad.group(ids[:1].expand(2**31), 10)
    with pytest.raises(TypeError, match="int32 or int64"):
        embedding.group_ids(ids.float(), 10)
    assert sparse_adagrad.launches_by_path == before


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("row,ids_shape,id_dtype,dups", [
    ((32,), (64, 26), torch.int32, True),  # deep rows, duplicates
    ((32,), (64, 26), torch.int64, False),  # deep rows, unique, int64
    ((), (64, 26), torch.int32, True),  # the wide table's scalar rows
    ((), (300,), torch.int64, True),
    ((5,), (7, 3), torch.int64, True),  # a row narrower than a warp
    ((40,), (50,), torch.int32, True),  # wider: lanes loop over the row
    ((32,), (5000,), torch.int32, True),  # segments longer than 32
], ids=["deep_dups", "deep_unique_int64", "wide_dups", "wide_int64",
        "row5", "row40", "deep_long_segments"])
def test_table_kernel_matches_plain_on_card(row, ids_shape, id_dtype, dups,
                                            combine):
    _needs_card()
    table, acc, ids, g = _table_case(4096, row, ids_shape, id_dtype, dups)
    _check_tables([(table, acc)], ids, [g], combine)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("rows", [((32,), ()), ((), (32,)), ((5,), (40,)),
                                  ((), ())],
                         ids=["deep_wide", "wide_deep", "row5_row40",
                              "wide_wide"])
def test_two_tables_in_one_launch_match_plain_on_card(rows, combine):
    """Two tables sharing the ids: one grouping and one update launch, each
    table bit for bit its plain update on the CPU."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, 512, (64, 26), generator=gen, device="cuda").int()
    tables = [(torch.randn(4096, *row, generator=gen, device="cuda"),
               torch.rand(4096, *row, generator=gen, device="cuda"))
              for row in rows]
    grads = [torch.randn(64, 26, *row, generator=gen, device="cuda")
             for row in rows]
    _check_tables(tables, ids, grads, combine)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("ids_kind", ["zipf_8_ranks", "all_equal"])
def test_step_pair_at_config_vocab_matches_plain_on_card(ids_kind, combine):
    """The wide&deep step's pair at ``Config()``'s vocab: the 8-rank
    all-gathered batch of Zipf ids, and a batch whose ids are all one (held
    bit for bit to the plain version on the CPU; its distance to the
    card's atomic plain version is the atomic order's, not gated)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids = (_zipf_ids(8 * 1024) if ids_kind == "zipf_8_ranks"
           else torch.full((1024, 26), 42, device="cuda")).int()
    tables = [(0.01 * torch.randn(CONFIG_VOCAB, *row, generator=gen,
                                  device="cuda"),
               1e-6 * torch.rand(CONFIG_VOCAB, *row, generator=gen,
                                 device="cuda"))
              for row in ((32,), ())]
    grads = [1e-4 * torch.randn(*ids.shape, *t.shape[1:], generator=gen,
                                device="cuda") for t, _ in tables]
    _check_tables(tables, ids, grads, combine,
                  atomic_gate=ids_kind != "all_equal")


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
def test_table_kernel_drops_out_of_range_ids_on_card(combine):
    _needs_card()
    table, acc, ids, g = _table_case(64, (32,), (40,), torch.int64, True)
    ids[::7] = 64
    ids[3] = -65  # below -vocab: dropped, as JAX's scatter drops it
    ids[4] = -1  # row 63, as JAX's .at[ids] reads a negative index
    _check_tables([(table, acc)], ids, [g], combine)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_table_kernel_wraps_negative_ids_on_card(combine, id_dtype):
    """An id in ``[-vocab, 0)`` is row ``id + vocab``: the same bits as the
    wrapped ids, its occurrences in one segment with the row's others."""
    _needs_card()
    table, acc, ids, g = _table_case(64, (32,), (40,), id_dtype, True)
    ids[::3] -= 64
    assert bool((ids < 0).any())
    _check_tables([(table, acc)], ids, [g], combine)
    got = [x.clone() for x in (table, acc)]
    want = [x.clone() for x in (table, acc)]
    embedding.sparse_adagrad_update(*got, ids, g, 0.1, combine=combine)
    embedding.sparse_adagrad_update(*want, ids % 64, g, 0.1, combine=combine)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_table_kernel_rejects_what_it_does_not_take():
    _needs_card()
    table, acc, ids, g = _table_case(64, (32,), (8,), torch.int32, False)
    with pytest.raises(ValueError, match="contiguous float32"):
        embedding.sparse_adagrad_update(table.double(), acc, ids, g, 0.1)
    with pytest.raises(ValueError, match="contiguous float32"):
        embedding.sparse_adagrad_update(table.t().contiguous().t(), acc, ids,
                                        g, 0.1)
    with pytest.raises(ValueError, match="group_ids"):  # another vocab's
        embedding.sparse_adagrad_update(
            table, acc, ids, g, 0.1, grouping=embedding.group_ids(ids, 65))
    with pytest.raises(ValueError, match="group_ids"):  # other ids'
        embedding.sparse_adagrad_update(
            table, acc, ids, g, 0.1,
            grouping=embedding.group_ids(ids[:4], 64))
    with pytest.raises(ValueError, match="1 or 2 tables"):
        sparse_adagrad.update([(table, acc, g)] * 3,
                              embedding.group_ids(ids, 64), 0.1, 1e-10, True)


@pytest.mark.cuda
def test_table_path_makes_no_host_sync():
    """The grouping and the update of two tables under
    ``torch.cuda.set_sync_debug_mode("error")``: no ``.item()``, no
    read-back of the segment count."""
    _needs_card()
    table, acc, ids, g = _table_case(4096, (32,), (64, 26), torch.int32, True)
    wide, wide_acc = torch.randn(4096, device="cuda"), torch.rand(
        4096, device="cuda")
    gw = torch.randn(64, 26, device="cuda")
    embedding.sparse_adagrad_update_tables(  # build and load the library
        [(table, acc), (wide, wide_acc)], ids, [g, gw], 0.1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for combine in (False, True):
            embedding.sparse_adagrad_update_tables(
                [(table, acc), (wide, wide_acc)], ids, [g, gw], 0.1,
                combine=combine)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("table_update", ["dense", "sparse"])
def test_wide_deep_step_launches_one_grouping_and_one_update(table_update):
    """``Trainer("wide_deep")`` on the card: a grouping and one update
    launch for both tables a step, on the mode's path, a finite loss, and
    the same step with the plain table update run on the CPU (which adds a
    row's occurrences in batch order, as the kernel does) leaves the same
    MLP and tables bit for bit."""
    _needs_card()
    import dataclasses

    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    config = dataclasses.replace(widedeep.Config.tiny(),
                                 table_update=table_update)
    batch = widedeep.example_batch(config, 64, seed=1)
    path = "combine" if table_update == "dense" else "sparse"
    t = Trainer("wide_deep", config=config, device="cuda")
    before = dict(sparse_adagrad.launches_by_path)
    loss = float(t.step(batch))
    torch.cuda.synchronize()
    assert sparse_adagrad.launches_by_path == {
        **before, "group": before["group"] + 1, path: before[path] + 1}
    assert loss == loss and loss > 0
    plain = Trainer("wide_deep", config=config, device="cuda")
    kernel_update = embedding.sparse_adagrad_update_tables
    embedding.sparse_adagrad_update_tables = chip_smoke._plain_tables_update
    try:
        assert float(plain.step(batch)) == loss
    finally:
        embedding.sparse_adagrad_update_tables = kernel_update
    for k, p in t.model.named_parameters():
        assert torch.equal(p, dict(plain.model.named_parameters())[k]), k
    for group, leaves in t.model.collections().items():
        for k, got in leaves.items():
            assert torch.equal(got, plain.model.collections()[group][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cifar10_cnn", "dense", "sparse"])
def test_compiled_step_replays_the_eager_step_on_card(case):
    """``Trainer``'s compiled step on the card (eager, captured at the
    second step, then replayed) against the same trainer stepping the eager
    step: every loss and tensor the same bits; the wrappers count the eager
    step's and the capture's launches, the eager trainer's every step, and
    a replay none (it calls no wrapper); and the GroupNorm backward's
    scratch held by the graph: evicting the shared cache between replays
    changes nothing."""
    _needs_card()
    import dataclasses

    from tensorflowonspark_torch.kernels import sparse_adagrad
    from tensorflowonspark_torch.models import cifar, widedeep
    from tensorflowonspark_torch.parallel import train as train_lib
    from tensorflowonspark_torch.trainer import Trainer

    if case == "cifar10_cnn":
        name, lib, config, n = "cifar10_cnn", cifar, cifar.Config(), 16
    else:
        name, lib, n = "wide_deep", widedeep, 64
        config = dataclasses.replace(widedeep.Config.tiny(),
                                     table_update=case)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                lib.example_batch(config, n, seed=i).items()}
               for i in range(5)]

    def counts():
        return {**group_norm.launches_by_path,
                **sparse_adagrad.launches_by_path}

    def run(compiled):
        t = Trainer(name, config=config, device="cuda", seed=0)
        if not compiled:
            step = t.train_step.step
            t.train_step = lambda state, batch: step(state, t.shard(batch))
        losses, launches = [], []
        for i, b in enumerate(batches):
            before = counts()
            losses.append(t.step(b))
            torch.cuda.synchronize()
            launches.append({k: v - before[k] for k, v in counts().items()})
            if compiled and i == 2:
                group_norm._BWD_SCRATCH.clear()
        state = {k: v.detach().clone()
                 for k, v in t.model.state_dict().items()}
        state.update({f"{k}/{s}": v.clone()
                      for k, p in t.model.named_parameters()
                      for s, v in t.optimizer.state[p].items()})
        return t, losses, launches, state

    replayed = train_lib.replayed_steps
    t, losses, launches, state = run(True)
    assert train_lib.replayed_steps - replayed == 3
    _, want, want_launches, want_state = run(False)
    assert t.train_step.captures == 1 and t.train_step.replays == 4
    assert [float(v) for v in losses] == [float(v) for v in want]
    none = dict.fromkeys(want_launches[0], 0)
    assert launches == want_launches[:2] + [none] * 3
    assert all(d == want_launches[0] for d in want_launches)
    assert all(torch.equal(state[k], want_state[k]) for k in want_state)
    if case == "cifar10_cnn":
        assert t.train_step.graph_of(batches[0]).scratch
        assert all(d["one_pass"] > 0 for d in want_launches)
    else:
        assert all(d["group"] == 1 for d in want_launches)


# ---------------------------------------------------------------------------
# The decode tier: paged K/V append and attention, and the engine
# ---------------------------------------------------------------------------


def _paged_card_case(label, L, seed):
    """``(case, max_len)`` for a card case label: ``chip_smoke.py``'s
    17(a) rows (``decode``, ``chunkN``, ``long``), with ``_kNN`` a head of
    NN instead of 32."""
    base, _, k = label.partition("_k")
    head_dim = int(k) if k else 32
    rows = chip_smoke.paged_case_rows(base, L)
    if base == "long":
        return chip_smoke.paged_case(
            rows, L, 1 + chip_smoke.LONG_PAGES * len(rows), seed,
            head_dim=head_dim, width=chip_smoke.LONG_PAGES), \
            chip_smoke.LONG_MAX_LEN
    return chip_smoke.paged_case(rows, L, 1 + 8 * len(rows), seed,
                                 head_dim=head_dim), 128


@pytest.mark.cuda
@pytest.mark.parametrize("label,L", [
    ("decode", 1), ("chunk16", 16), ("chunk32", 32), ("decode_k16", 1),
    ("chunk16_k16", 16), ("decode_k64", 1), ("chunk32_k64", 32),
    ("decode_k128", 1), ("chunk16_k128", 16), ("long", 1), ("chunk24", 24)])
def test_paged_kernels_match_plain_twins_on_card(label, L):
    """At the decode engine's geometry (tinylm.Config(): 4 heads of 32,
    pages of 16, 128 positions; heads of 16, 64 and 128 too): rows
    inactive, crossing a page, sharing another's pages, ending at max_len
    - 1; the long decode case (16 rows over up to 1,024 positions, 64
    pages of 16 a row); a chunk of 24 whose valid queries end inside a
    query tile.  The append bit for bit its twin outside page 0, the
    attention within 1e-5 and the same bits twice, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tensorflowonspark_torch.kernels import paged_attention as pa

    case, max_len = _paged_card_case(label, L, 7)
    before = dict(pa.launches_by_kernel)
    for layer in (0, 1):
        kc, vc = case["k_pool"].clone(), case["v_pool"].clone()
        kt, vt = case["k_pool"].clone(), case["v_pool"].clone()
        idx = (case["tables"], case["start"], case["lens"])
        pa.kv_append(kc, vc, layer, case["k"], case["v"], *idx,
                     max_len=max_len)
        pa.kv_append_plain(kt, vt, layer, case["k"], case["v"], *idx,
                           max_len=max_len)
        attn = [pa.paged_attention(case["q"], kc, vc, layer, case["tables"],
                                   case["start"], max_len=max_len)
                for _ in range(2)]
        plain = pa.paged_attention_plain(case["q"], kc, vc, layer,
                                         case["tables"], case["start"],
                                         max_len=max_len)
        torch.cuda.synchronize()
        assert torch.equal(kc[:, 1:], kt[:, 1:])
        assert torch.equal(vc[:, 1:], vt[:, 1:])
        assert float((attn[0] - plain).abs().max()) <= 1e-5
        assert torch.equal(attn[0], attn[1])
    assert pa.launches_by_kernel == {"kv_append": before["kv_append"] + 2,
                                     "paged_attention":
                                         before["paged_attention"] + 4}


@pytest.mark.cuda
@pytest.mark.parametrize("label,L", [
    ("verify2", 2), ("verify3", 3), ("verify5", 5), ("draft_decode", 1),
    ("draft_chunk32", 32)])
def test_spec_shapes_match_plain_twins_on_card(label, L):
    """Speculation's shapes (``chip_smoke.py`` 17(a)): the verify steps at
    k + 1 = 2, 3, 5 positions over 8 rows with step lengths 0..L (4 heads
    of 32), and the draft model's (``Config.draft_for``: one layer, 2
    heads of 16) decode step and top chunk rung.  The append bit for bit
    its twin outside page 0, the attention within 1e-5 and the same bits
    twice, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tensorflowonspark_torch.kernels import paged_attention as pa
    from tensorflowonspark_torch.models import tinylm

    draft = tinylm.Config.draft_for(tinylm.Config())
    base = label.partition("draft_")[2] or label
    rows = chip_smoke.paged_case_rows(base, L)
    geo = ({"heads": draft.n_heads, "head_dim": draft.head_dim,
            "layers": draft.n_layers} if label.startswith("draft_") else {})
    case = chip_smoke.paged_case(rows, L, 1 + 8 * len(rows), 13, **geo)
    layer = case["k_pool"].shape[0] - 1
    before = dict(pa.launches_by_kernel)
    bits, err, (kc, vc), _ = chip_smoke.append_against_twin(case, 128,
                                                            layer)
    attn = [pa.paged_attention(case["q"], kc, vc, layer, case["tables"],
                               case["start"], max_len=128)
            for _ in range(2)]
    plain = pa.paged_attention_plain(case["q"], kc, vc, layer,
                                     case["tables"], case["start"],
                                     max_len=128)
    torch.cuda.synchronize()
    assert bits, err
    assert float((attn[0] - plain).abs().max()) <= 1e-5
    assert torch.equal(attn[0], attn[1])
    assert pa.launches_by_kernel == {"kv_append": before["kv_append"] + 1,
                                     "paged_attention":
                                         before["paged_attention"] + 2}


#: one plan of every instantiation of the attention kernel: (query tile,
#: position tile, head_dim)
EVERY_TILE = [(1, 64, 32), (1, 32, 128), (4, 64, 32), (8, 64, 32),
              (16, 64, 32), (32, 64, 32), (32, 64, 16), (4, 32, 64),
              (8, 32, 32), (8, 32, 128), (16, 32, 64), (16, 32, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", EVERY_TILE,
                         ids=["x".join(map(str, t)) for t in EVERY_TILE])
def test_every_attention_tile_matches_the_twin_on_card(tiles):
    """Each (query tile, position tile) the kernel has an instantiation
    for, launched through ``_launch`` at the chunk-32 rows (the decode rows
    for a tile of 1): within 1e-5 of the twin and the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tensorflowonspark_torch.kernels import paged_attention as pa

    q_tile, pos_tile, head_dim = tiles
    L = 1 if q_tile == 1 else 32
    label = ("decode" if L == 1 else "chunk32") + f"_k{head_dim}"
    case, max_len = _paged_card_case(label, L, 11)
    q, tables, start = case["q"], case["tables"], case["start"]
    R, _, H, K = q.shape
    p = pa.tiled(R, L, H, K, 16, max_len, q_tile, pos_tile)
    got = [pa._launch(q, case["k_pool"], case["v_pool"], 1, tables, start,
                      max_len, K ** -0.5, p) for _ in range(2)]
    plain = pa.paged_attention_plain(q, case["k_pool"], case["v_pool"], 1,
                                     tables, start, max_len=max_len)
    torch.cuda.synchronize()
    assert float((got[0] - plain).abs().max()) <= 1e-5
    assert torch.equal(got[0], got[1])


@pytest.mark.cuda
def test_paged_attention_reads_nothing_past_the_bound_on_card():
    """Positions past each query's bound are never read: NaN there leaves
    every output bit as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tensorflowonspark_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(3)
    kp = torch.randn(1, 5, 16, 2, 32, generator=gen, device="cuda")
    vp = torch.randn(1, 5, 16, 2, 32, generator=gen, device="cuda")
    q = torch.randn(1, 4, 2, 32, generator=gen, device="cuda")
    tables = torch.tensor([[3, 1, 0, 0]], dtype=torch.int32, device="cuda")
    start = torch.tensor([17], dtype=torch.int32, device="cuda")
    o = pa.paged_attention(q, kp, vp, 0, tables, start, max_len=64)
    kp[0, 1, 5:] = float("nan")  # positions 21.. of the row: past 17 + 3
    vp[0, 1, 5:] = float("nan")
    kp[0, 0] = float("nan")
    vp[0, 0] = float("nan")
    again = pa.paged_attention(q, kp, vp, 0, tables, start, max_len=64)
    torch.cuda.synchronize()
    assert torch.isfinite(again).all() and torch.equal(o, again)


@pytest.mark.cuda
@pytest.mark.parametrize("label,L", [("decode", 1), ("chunk24", 24),
                                     ("long", 1)])
def test_paged_attention_ignores_nan_past_every_bound_on_card(label, L):
    """Every pool place no query of the case sees (inside the last staged
    tile of a block's walk or past it, on the rows' pages, on page 0 past
    the inactive row's one position, on unused pages) turned NaN: every
    output the same bits and finite.  For the chunk, the places only
    padded queries (t >= lens[r]) see are poisoned too: the valid queries'
    outputs are unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from tensorflowonspark_torch.kernels import paged_attention as pa

    case, max_len = _paged_card_case(label, L, 5)
    q, tables, start = case["q"], case["tables"], case["start"]
    kp, vp = case["k_pool"], case["v_pool"]
    ps = kp.shape[2]
    lens = (np.full(len(start), L) if case["lens_np"] is None
            else case["lens_np"])
    o = pa.paged_attention(q, kp, vp, 1, tables, start, max_len=max_len)
    seen = np.zeros(kp.shape[1:3], bool)
    for r, s in enumerate(case["start_np"]):
        if lens[r] == 0:
            continue
        last = min(max(int(s) + int(lens[r]) - 1, 0), max_len - 1)
        for j in range(last + 1):
            seen[case["tables_np"][r, j // ps], j % ps] = True
    if case["lens_np"] is not None:  # inactive rows still read position 0
        for r in np.flatnonzero(lens == 0):
            seen[case["tables_np"][r, 0], 0] = True
    poison = torch.from_numpy(~seen).cuda()
    kp, vp = kp.clone(), vp.clone()
    kp[1][poison] = float("nan")
    vp[1][poison] = float("nan")
    again = pa.paged_attention(q, kp, vp, 1, tables, start, max_len=max_len)
    torch.cuda.synchronize()
    valid = torch.from_numpy(np.arange(L)[None, :] < lens[:, None]).cuda()
    assert torch.isfinite(again[valid]).all()
    assert torch.equal(o[valid], again[valid])


def _append_card_case(kind):
    """``(case, max_len)`` of one append case: ``synthetic`` (256 rows x
    128 positions over 2,049 pages), ``odd`` (37 rows x 39 positions,
    1,443 items: three spare warps in the last block), ``decode_k128``
    and ``chunk16_k128`` (4 heads of 128: H K = 512, four float4s a lane),
    ``outside`` (chunk 16 with page ids past the pool and below 0)."""
    if kind == "synthetic":
        rows = [(0, chip_smoke.SYNTH_POSITIONS,
                 [("own", j) for j in range(8)])
                for _ in range(chip_smoke.SYNTH_ROWS)]
        return chip_smoke.paged_case(rows, chip_smoke.SYNTH_POSITIONS,
                                     1 + 8 * len(rows), 23), 128
    if kind == "odd":
        rows = [(8 * (r % 11), 39 - r % 5, [] if r % 9 == 4 else
                 [("own", j) for j in range(8)]) for r in range(37)]
        return chip_smoke.paged_case(rows, 39, 1 + 8 * len(rows), 29), 128
    if kind == "outside":
        case, max_len = _paged_card_case("chunk16", 16, 31)
        case["tables"][0, 0] = case["k_pool"].shape[1] + 7
        case["tables"][1, 1] = -3
        return case, max_len
    base = kind.split("_")[0]
    return _paged_card_case(kind, 1 if base == "decode" else 16, 37)


#: the append's card cases
APPEND_CASES = ("synthetic", "odd", "decode_k128", "chunk16_k128",
                "outside")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", APPEND_CASES)
def test_kv_append_plans_match_the_twin_on_card(kind):
    """256 x 128, a grid leaving spare warps in its last block, rows of
    512 floats, lens given and null, page ids outside the pool (dropped):
    the kernel bit for bit its twin outside page 0 in both layers, another
    layer untouched; one launch a call."""
    _needs_card()
    from tensorflowonspark_torch.kernels import paged_attention as pa

    case, max_len = _append_card_case(kind)
    idx = (case["tables"], case["start"], case["lens"])
    before = pa.launches_by_kernel["kv_append"]
    for layer in (0, 1):
        kt, vt = case["k_pool"].clone(), case["v_pool"].clone()
        pa.kv_append_plain(kt, vt, layer, case["k"], case["v"], *idx,
                           max_len=max_len)
        kc, vc = case["k_pool"].clone(), case["v_pool"].clone()
        pa.kv_append(kc, vc, layer, case["k"], case["v"], *idx,
                     max_len=max_len)
        torch.cuda.synchronize()
        assert torch.equal(kc[:, 1:], kt[:, 1:]), layer
        assert torch.equal(vc[:, 1:], vt[:, 1:]), layer
        assert torch.equal(kc[1 - layer], case["k_pool"][1 - layer])
    assert pa.launches_by_kernel["kv_append"] == before + 2


@pytest.mark.cuda
def test_kv_append_refuses_a_misaligned_view_and_a_foreign_plan_on_card():
    """A ``k`` view 4 bytes off 16-byte alignment raises ``ValueError``
    naming it and launches nothing; a plan whose grid is not the shapes',
    or whose block is not whole warps, is refused by the C entry (the
    wrapper raises) and counts nothing."""
    _needs_card()
    from tensorflowonspark_torch.kernels import paged_attention as pa

    case, max_len = _paged_card_case("chunk16", 16, 41)
    idx = (case["tables"], case["start"], case["lens"])
    k = case["k"]
    flat = torch.empty(k.numel() + 4, device="cuda")
    view = flat[1:1 + k.numel()].view(k.shape)
    view.copy_(k)
    before = pa.launches_by_kernel["kv_append"]
    with pytest.raises(ValueError, match="k must start 16-byte aligned"):
        pa.kv_append(case["k_pool"], case["v_pool"], 0, view, case["v"],
                     *idx, max_len=max_len)
    R, L, H, K = k.shape
    p = pa.append_plan(R, L, H, K)
    for foreign in (p._replace(blocks=p.blocks + 1),
                    p._replace(threads=48)):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            pa._append_launch(case["k_pool"], case["v_pool"], 0, k,
                              case["v"], *idx, max_len, foreign)
    assert pa.launches_by_kernel["kv_append"] == before


@pytest.mark.cuda
def test_planted_append_fault_fails_the_gate_on_card():
    """A build whose append writes offset (p + 1) % page_size differs from
    the twin outside page 0 at the decode and chunk cases."""
    _needs_card()
    from tensorflowonspark_torch.kernels import _build
    from tensorflowonspark_torch.kernels import paged_attention as pa

    saved = pa._LIB
    try:
        pa._LIB = pa._bind(_build.load("paged_attention",
                                       chip_smoke.PLANTED_APPEND))
        for label, L in (("decode", 1), ("chunk32", 32)):
            case, max_len = _paged_card_case(label, L, 43)
            assert not chip_smoke.append_against_twin(case, max_len)[0]
    finally:
        pa._LIB = saved


@pytest.mark.cuda
def test_paged_kernels_reject_what_they_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from tensorflowonspark_torch.kernels import paged_attention as pa

    kp = torch.zeros(2, 5, 16, 2, 32, device="cuda")
    q = torch.zeros(1, 1, 2, 32, device="cuda")
    tables = torch.zeros(1, 4, dtype=torch.int32, device="cuda")
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="one device"):
        pa.paged_attention(q, kp, kp, 0, tables.cpu(), start, max_len=64)
    with pytest.raises(ValueError, match="float32"):
        pa.paged_attention(q.half(), kp, kp, 0, tables, start, max_len=64)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, kp, kp, 0, tables.long(), start, max_len=64)
    with pytest.raises(ValueError, match="max_len"):
        pa.paged_attention(q, kp, kp, 0, tables, start, max_len=65)
    with pytest.raises(ValueError, match="layer"):
        pa.kv_append(kp, kp.clone(), 2, q, q.clone(), tables, start,
                     max_len=64)
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros(1, 5, 16, 1, 160, device="cuda")
        pa.paged_attention(torch.zeros(1, 1, 1, 160, device="cuda"), wide,
                           wide, 0, tables, start, max_len=64)
    with pytest.raises(ValueError, match="multiple of 4"):
        odd = torch.zeros(1, 5, 16, 1, 18, device="cuda")
        pa.paged_attention(torch.zeros(1, 1, 1, 18, device="cuda"), odd, odd,
                           0, tables, start, max_len=64)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 0], ids=["chunked", "legacy"])
def test_decode_engine_on_card_equals_the_cpu_engine(chunk):
    """The engine on the card (its default device) serves the CPU
    engine's greedy streams on the same weights, concurrently, with
    prefix sharing and a mid-page COW; warmup() captured one graph a
    signature and serving captured and ran eagerly nothing after; the
    pools never moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import threading

    import numpy as np

    from tensorflowonspark_torch import decode
    from tensorflowonspark_torch.models import tinylm

    config = tinylm.Config()
    params = tinylm.init_params(config, seed=5)
    geometry = dict(max_seqs=8, page_size=16, max_len=128,
                    max_prompt_len=64, prefill_chunk=chunk)
    rng = np.random.RandomState(5)
    base = rng.randint(0, 256, size=(48,))
    prompts = [base] + [rng.randint(0, 256, size=(n,)) for n in (4, 17, 64)]
    prompts += [np.concatenate([base[:24], rng.randint(0, 256, size=(9,))]),
                np.concatenate([base[:32], rng.randint(0, 256, size=(5,))])]
    cpu = decode.DecodeEngine(config, params, device="cpu", **geometry)
    cpu.start()
    want = [cpu.submit(p, max_new_tokens=20).result() for p in prompts]
    cpu.stop()
    eng = decode.DecodeEngine(config, params, **geometry)
    assert eng.device.type == "cuda"
    ptrs = (eng._kp.data_ptr(), eng._vp.data_ptr(), eng.kv_pool_bytes)
    eng.warmup()
    sigs = len(eng.enumerate_signatures())
    assert eng.captures == eng.eager_calls == sigs
    eng.start()
    got = [eng.submit(p, max_new_tokens=20).result() for p in prompts]
    out = [None] * len(prompts)

    def run(i):
        out[i] = eng.submit(prompts[i], max_new_tokens=20).result()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == want and out == want
    assert eng.captures == eng.eager_calls == sigs and eng.replays > 0
    if chunk:
        assert eng.stats()["admission"]["kv"]["cow_copies_total"] >= 1
    eng.stop()
    assert eng.pool.used_pages == 0 and eng.pool.invariant()["ok"]
    assert (eng._kp.data_ptr(), eng._vp.data_ptr(),
            eng.kv_pool_bytes) == ptrs


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_engine_on_card_equals_the_cpu_engine(drafter):
    """A speculating engine on the card (spec_tokens=4) serves the CPU
    single-token engine's greedy streams on the same weights, at once,
    with prefix sharing and a mid-page COW; warmup() captured one graph a
    signature (the verify rungs and, for the model drafter, its
    ``draft_`` set) and serving captured and ran eagerly nothing after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import threading

    import numpy as np

    from tensorflowonspark_torch import decode
    from tensorflowonspark_torch.models import tinylm

    config = tinylm.Config()
    params = tinylm.init_params(config, seed=5)
    geometry = dict(max_seqs=8, page_size=16, max_len=128,
                    max_prompt_len=64)
    rng = np.random.RandomState(6)
    base = rng.randint(0, 256, size=(48,))
    prompts = [base] + [rng.randint(0, 256, size=(n,)) for n in (4, 17, 64)]
    prompts += [np.concatenate([base[:24], rng.randint(0, 256, size=(9,))]),
                np.concatenate([base[:32], rng.randint(0, 256, size=(5,))])]
    cpu = decode.DecodeEngine(config, params, device="cpu", **geometry)
    cpu.start()
    want = [cpu.submit(p, max_new_tokens=24).result() for p in prompts]
    cpu.stop()
    eng = decode.DecodeEngine(config, params, spec_tokens=4,
                              spec_drafter=drafter, **geometry)
    assert eng.device.type == "cuda"
    eng.warmup()
    sigs = len(eng.enumerate_signatures())
    assert eng.captures == eng.eager_calls == sigs
    eng.start()
    out = [None] * len(prompts)

    def run(i):
        out[i] = eng.submit(prompts[i], max_new_tokens=24).result()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert out == want
    assert eng.captures == eng.eager_calls == sigs and eng.replays > 0
    assert eng.stats()["admission"]["kv"]["cow_copies_total"] >= 1
    eng.stop()
    assert eng.pool.used_pages == 0 and eng.pool.invariant()["ok"]


@pytest.mark.cuda
def test_a_predict_fn_that_reads_its_params_serves_every_batch_on_card(
        tmp_path):
    """A user's ``predict_fn`` is served as given on the card, never
    captured: one that moves its numpy params to the device and reads a
    scalar back (both syncs, which a capture forbids) serves several
    batches of one bucket, through ``_RunModel`` and the online tier, and
    runs once a batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from tensorflowonspark_torch import compat, online, pipeline

    w = np.arange(20, dtype=np.float32).reshape(4, 5) / 10.0
    d = str(tmp_path / "export")
    compat.export_saved_model({"params": {"w": w}}, d)
    calls = []

    def predict(p, b):
        calls.append(int(b["features"].shape[0]))
        wt = torch.as_tensor(p["w"]).to(b["features"].device)
        scale = float(wt.abs().sum().item())
        return {"score": (b["features"] @ wt) * scale / scale}

    x = np.random.RandomState(0).rand(48, 4).astype(np.float32)
    run = pipeline._RunModel(d, None, predict, 8, {"features": "features"},
                             None, ["features"], bucket_sizes=[8])
    rows = list(run(iter([{"features": x[i]} for i in range(48)])))
    np.testing.assert_allclose([r.score for r in rows], x @ w, rtol=1e-5,
                               atol=1e-6)
    assert calls == [8] * 6
    calls.clear()
    srv = online.OnlineServer()
    srv.add_tenant("a", export_dir=d, predict_fn=predict, batch_size=8,
                   bucket_sizes=[8], flush_ms=1.0, warmup=True,
                   warmup_example={"features": np.zeros(4, np.float32)})
    srv.start()
    try:
        for i in range(6):
            got = srv.submit("a", {"features": x[8 * i:8 * i + 8]},
                             timeout=60.0)
            np.testing.assert_allclose(got["score"], x[8 * i:8 * i + 8] @ w,
                                       rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()
    assert calls == [8] * 7  # the warm-up, then one a batch


@pytest.mark.cuda
def test_the_health_probe_kernel_runs_on_the_card(monkeypatch):
    """The probe's kernel (PTX through the CUDA driver API) runs and checks
    on the card, in-process and in the probe's child; a kernel that writes
    a wrong element fails it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tensorflowonspark_torch import health

    health._card_probe(0)
    assert health.probe_chip_health(timeout_s=60) is None
    monkeypatch.setattr(health, "_PROBE_PTX", health._PROBE_PTX.replace(
        "0f3F800000", "0f40000000"))  # 3 i + 2
    with pytest.raises(RuntimeError, match="wrong elements"):
        health._card_probe(0)
