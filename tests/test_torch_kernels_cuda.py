"""The CUDA kernels of the port on the card, against their plain twins:
the fused GroupNorm forward and backward, and the AdaGrad table update.

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
], ids=["x_resident", "x_streamed", "four_launch", "four_launch_forced"])
def test_both_backward_paths_match_plain_twin_on_card(shape, modes, path,
                                                      x_resident, forced):
    """The one-pass kernel with x in shared memory and with x streamed
    (8×256×56×56 GN+add+ReLU, a cluster of 8), the four-launch kernels at
    the oversize shape on their planned path, and forced where the plan
    takes one pass (the twin ``chip_smoke.py`` times the one pass
    against); the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, c, h, w = shape
    assert group_norm._plan_backward(n, h, w, c, 32).x_resident == x_resident
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


# --- the AdaGrad table update (csrc/sparse_adagrad.cu) ---------------------

#: |kernel - plain| <= this x max|plain| over the touched rows: f32, and
#: only the order of the duplicates' sums differs (the plain version's
#: index_add_ uses atomics), besides torch.rsqrt's ulps
TABLE_TOL_REL = 1e-5


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


def _check_table(table, acc, ids, g, combine):
    """The kernel twice on copies against the plain version: within
    ``TABLE_TOL_REL``, untouched rows bit-identical, the same bits twice,
    one launch a call on the mode's path."""
    path = "combine" if combine else "sparse"
    rows = table.shape[0]
    flat = embedding.wrap_ids(ids.reshape(-1).long(), rows)
    touched = torch.zeros(rows, dtype=torch.bool, device="cuda")
    touched[flat[(flat >= 0) & (flat < rows)]] = True
    outs = []
    for _ in range(2):
        t, a = table.clone(), acc.clone()
        before = dict(sparse_adagrad.launches_by_path)
        assert embedding.sparse_adagrad_update(t, a, ids, g, 0.1,
                                               combine=combine) == (t, a)
        torch.cuda.synchronize()
        assert sparse_adagrad.launches_by_path == {
            **before, path: before[path] + 1}
        outs.append((t, a))
    tp, ap = embedding.sparse_adagrad_update_plain(
        table.clone(), acc.clone(), ids, g, 0.1, combine=combine)
    (t1, a1), (t2, a2) = outs
    assert torch.equal(t1, t2) and torch.equal(a1, a2)
    for got, want, orig in ((t1, tp, table), (a1, ap, acc)):
        got2, want2 = got.reshape(rows, -1), want.reshape(rows, -1)
        err = (got2 - want2).abs()[touched].max()
        assert err <= TABLE_TOL_REL * want2.abs()[touched].max()
        moved = (got != orig).reshape(rows, -1).any(dim=1)
        assert not bool((moved & ~touched).any())
        assert bool(moved[touched].any())


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("row,ids_shape,id_dtype,dups", [
    ((32,), (64, 26), torch.int32, True),  # deep rows, duplicates
    ((32,), (64, 26), torch.int64, False),  # deep rows, unique, int64
    ((), (64, 26), torch.int32, True),  # the wide table's scalar rows
    ((), (300,), torch.int64, True),
    ((5,), (7, 3), torch.int64, True),  # a row narrower than a warp
    ((40,), (50,), torch.int32, True),  # wider: lanes loop over the row
], ids=["deep_dups", "deep_unique_int64", "wide_dups", "wide_int64",
        "row5", "row40"])
def test_table_kernel_matches_plain_on_card(row, ids_shape, id_dtype, dups,
                                            combine):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _check_table(*_table_case(4096, row, ids_shape, id_dtype, dups),
                 combine)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
def test_table_kernel_drops_out_of_range_ids_on_card(combine):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    table, acc, ids, g = _table_case(64, (32,), (40,), torch.int64, True)
    ids[::7] = 64
    ids[3] = -65  # below -vocab: dropped, as JAX's scatter drops it
    ids[4] = -1  # row 63, as JAX's .at[ids] reads a negative index
    _check_table(table, acc, ids, g, combine)


@pytest.mark.cuda
@pytest.mark.parametrize("combine", [False, True], ids=["sparse", "combine"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_table_kernel_wraps_negative_ids_on_card(combine, id_dtype):
    """An id in ``[-vocab, 0)`` is row ``id + vocab``: the same bits as the
    wrapped ids, its occurrences in one segment with the row's others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    table, acc, ids, g = _table_case(64, (32,), (40,), id_dtype, True)
    ids[::3] -= 64
    assert bool((ids < 0).any())
    _check_table(table, acc, ids, g, combine)
    got = [x.clone() for x in (table, acc)]
    want = [x.clone() for x in (table, acc)]
    embedding.sparse_adagrad_update(*got, ids, g, 0.1, combine=combine)
    embedding.sparse_adagrad_update(*want, ids % 64, g, 0.1, combine=combine)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_table_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    table, acc, ids, g = _table_case(64, (32,), (8,), torch.int32, False)
    with pytest.raises(ValueError, match="contiguous float32"):
        embedding.sparse_adagrad_update(table.double(), acc, ids, g, 0.1)
    with pytest.raises(ValueError, match="contiguous float32"):
        embedding.sparse_adagrad_update(table.t().contiguous().t(), acc, ids,
                                        g, 0.1)
    with pytest.raises(ValueError, match="sort_ids"):
        embedding.sparse_adagrad_update(table, acc, ids, g, 0.1,
                                        order=embedding.sort_ids(ids.long(), 64))


@pytest.mark.cuda
@pytest.mark.parametrize("table_update", ["dense", "sparse"])
def test_wide_deep_step_launches_the_table_kernel_twice(table_update):
    """``Trainer("wide_deep")`` on the card: 2 table launches a step on the
    mode's path, a finite loss, and the same step with the plain table
    update leaves the same MLP and tables within the kernel's tolerance.
    The plain update runs on the CPU, where ``index_add_`` adds a row's
    occurrences in batch order as the kernel does: at zero accumulators a
    row whose occurrences nearly cancel makes the update ill-conditioned,
    so the card's atomic order would not do as the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
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
    assert sparse_adagrad.launches_by_path == {**before,
                                               path: before[path] + 2}
    assert loss == loss and loss > 0
    plain = Trainer("wide_deep", config=config, device="cuda")
    kernel_update = embedding.sparse_adagrad_update
    embedding.sparse_adagrad_update = chip_smoke._plain_table_update
    try:
        assert float(plain.step(batch)) == loss
    finally:
        embedding.sparse_adagrad_update = kernel_update
    for k, p in t.model.named_parameters():
        assert torch.equal(p, dict(plain.model.named_parameters())[k]), k
    for group, leaves in t.model.collections().items():
        for k, got in leaves.items():
            want = plain.model.collections()[group][k]
            assert float((got - want).abs().max()) <= \
                TABLE_TOL_REL * float(want.abs().max()), k
