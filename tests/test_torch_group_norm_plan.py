"""How the GroupNorm wrapper picks the kernel's path, checked on the CPU.

``group_norm._plan`` is pure Python: by shape and the card's cluster
capacity table alone it sends a call to the one-pass cluster kernel (a
sample in the shared memory of at most 8 blocks, or of a non-portable
cluster of 9–16 where 8 cannot hold it) or to the two-pass kernels.  The
norm shapes come from the real ResNet-50 forward, traced on the ``meta``
device (no weights, no compute); the capacity tables are stubs.
"""

import collections

import pytest
import torch

from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import resnet

SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared memory

#: Stub capacity tables, ``((k, clusters of k at once), ...)`` for k 9–16:
#: "gpc" as an H100 SXM's 8 GPCs of 18, 18, 18, 18, 16, 16, 14 and 14 SMs
#: would hold them (one block an SM, clusters within a GPC), "flat" 8
#: clusters of any size, "nine" a card that runs twice as many 9-block
#: clusters as larger ones, "none" a card that co-schedules none.
GPCS = (18, 18, 18, 18, 16, 16, 14, 14)
CAPACITY = {
    "gpc": tuple((k, sum(g // k for g in GPCS)) for k in range(9, 17)),
    "flat": tuple((k, 8) for k in range(9, 17)),
    "nine": ((9, 14),) + tuple((k, 7) for k in range(10, 17)),
    "none": tuple((k, 0) for k in range(9, 17)),
}
#: Inception-v3's stem samples that no cluster of 8 holds (canonical
#: 147²×64 and 71²×192, SAME 150²×64 and 75²×192): (C, H, W), the least
#: cluster whose blocks hold a sample (forward, backward's dz), and the
#: cluster each stub table's busy-SM rule picks.
STEM_SITES = {
    "canonical_147x64": ((64, 147, 147), 13,
                         {"gpc": 14, "flat": 16, "nine": 16, "none": 13}),
    "canonical_71x192": ((192, 71, 71), 9,
                         {"gpc": 14, "flat": 16, "nine": 9, "none": 9}),
    "same_150x64": ((64, 150, 150), 13,
                    {"gpc": 14, "flat": 16, "nine": 16, "none": 13}),
    "same_75x192": ((192, 75, 75), 10,
                    {"gpc": 14, "flat": 16, "nine": 16, "none": 10}),
}


def _resnet50_sites():
    """(C, H, W, groups) of every norm call of one Config() forward."""
    with torch.device("meta"):
        model = resnet.ResNet(resnet.Config())
    sites = []

    def recorder(x, gamma, beta, groups, eps, residual=None, relu=True):
        sites.append((*x.shape[1:], groups))
        return torch.empty_like(x)

    model.norm_act = recorder
    with torch.inference_mode():
        model(torch.empty(1, 224, 224, 3, device="meta"))
    return sites


SITES = _resnet50_sites()


def test_resnet50_has_53_norm_calls_in_12_shapes():
    assert len(SITES) == 53
    assert len(set(SITES)) == 12


@pytest.mark.parametrize("batch", [1, 32, 256])
def test_every_resnet50_norm_takes_the_one_pass_path(batch):
    clusters = collections.Counter()
    for c, h, w, groups in SITES:
        plan = group_norm._plan(batch, h, w, c, groups)
        assert plan.path == "one_pass", (c, h, w)
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.smem <= SMEM_PER_BLOCK
        # the block's share of the sample is in its shared memory
        assert plan.smem >= -(-h * w // plan.cluster) * c * 2
        assert plan.threads % (c // 8) == 0 and plan.threads <= 256
        clusters[plan.cluster] += 1
    # the 1.6 MB samples (112²×64, 56²×256) need the full cluster
    assert clusters[8] == 5


@pytest.mark.parametrize("site", sorted(set(SITES)) + [
    (*s[0], 32) for s in STEM_SITES.values()],
    ids=lambda s: "x".join(map(str, s[:3])))
def test_one_pass_cluster_is_the_least_that_fits(site):
    """Up to 8 blocks the least power of two that holds a sample (the
    half does not); beyond, no power of two up to 8 holds it, and the
    cluster is the busy-SM rule's among the 9–16 that do."""
    c, h, w, groups = site
    plan = group_norm._plan(32, h, w, c, groups, CAPACITY["gpc"])
    if 1 < plan.cluster <= group_norm._CLUSTER_MAX:
        smaller = group_norm._one_pass_smem(h * w, c, groups,
                                            plan.cluster // 2, plan.threads)
        assert smaller > SMEM_PER_BLOCK
    if plan.cluster > group_norm._CLUSTER_MAX:
        assert group_norm._one_pass_smem(h * w, c, groups, 8,
                                         plan.threads) > SMEM_PER_BLOCK
        fits = [k for k in range(9, 17) if group_norm._one_pass_smem(
            h * w, c, groups, k, plan.threads) <= SMEM_PER_BLOCK]
        assert plan.cluster == group_norm._wide_cluster(fits,
                                                        CAPACITY["gpc"])


@pytest.mark.parametrize("table", sorted(CAPACITY))
@pytest.mark.parametrize("site", sorted(set(SITES)),
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_resnet50_plans_do_not_read_the_capacity(site, table):
    """Every ResNet-50 sample fits 8 blocks: its plans, forward and
    backward, are the same whatever the card's capacity table."""
    c, h, w, groups = site
    assert group_norm._plan(64, h, w, c, groups, CAPACITY[table]) \
        == group_norm._plan(64, h, w, c, groups)
    assert group_norm._plan_backward(64, h, w, c, groups, CAPACITY[table]) \
        == group_norm._plan_backward(64, h, w, c, groups)


@pytest.mark.parametrize("table", sorted(CAPACITY))
@pytest.mark.parametrize("site", sorted(STEM_SITES))
def test_inception_stem_takes_a_wide_cluster(site, table):
    """At batch 64 each stem sample runs one pass, forward and backward
    (dz in shared memory, x streamed), over the 9–16-block cluster that
    keeps the most SMs busy by the card's table: the largest
    k × clusters, the smaller k on a tie."""
    (c, h, w), least, picks = STEM_SITES[site]
    capacity = CAPACITY[table]
    fwd = group_norm._plan(64, h, w, c, 32, capacity)
    bwd = group_norm._plan_backward(64, h, w, c, 32, capacity)
    for plan in (fwd, bwd):
        assert plan.path == "one_pass"
        assert 9 <= plan.cluster <= 16
        assert plan.cluster == picks[table]
        assert plan.smem <= SMEM_PER_BLOCK
    assert not bwd.x_resident and bwd.launches == 1
    assert fwd.smem == group_norm._one_pass_smem(h * w, c, 32, fwd.cluster,
                                                 fwd.threads)
    assert bwd.smem == group_norm._one_pass_bwd_smem(
        h * w, c, 32, bwd.cluster, bwd.threads, False)
    # the block's share of the sample (of dz) is in its shared memory, and
    # one block fewer than the least would not hold it
    rows = -(-h * w // fwd.cluster)
    assert fwd.smem >= rows * c * 2 and bwd.smem >= rows * c * 2
    assert group_norm._one_pass_smem(h * w, c, 32, least - 1,
                                     fwd.threads) > SMEM_PER_BLOCK
    assert group_norm._one_pass_smem(h * w, c, 32, least,
                                     fwd.threads) <= SMEM_PER_BLOCK
    assert group_norm._one_pass_bwd_smem(h * w, c, 32, least - 1,
                                         bwd.threads, False) > SMEM_PER_BLOCK
    # without a table (a caller after the path alone): the least that fits
    assert group_norm._plan(64, h, w, c, 32).cluster == least
    assert group_norm._plan_backward(64, h, w, c, 32).cluster == least


@pytest.mark.parametrize("fits,capacity,want", [
    ([9, 10, 11], ((9, 4), (10, 4), (11, 3)), 10),  # 40 > 36, 33
    ([13, 14, 15, 16], ((13, 8), (14, 8), (15, 8), (16, 8)), 16),  # 128
    ([13, 14], ((13, 8), (14, 0)), 13),
    ([14, 15, 16], ((14, 8), (15, 7), (16, 7)), 14),  # 112 = 112 > 105
    ([12, 13], ((12, 13), (13, 12)), 12),  # 156 = 156: the smaller
    ([15, 16], (), 15),
], ids=["most_sms", "largest", "zero", "tie", "tie_largest", "no_table"])
def test_wide_cluster_keeps_the_most_sms_busy(fits, capacity, want):
    assert group_norm._wide_cluster(fits, capacity) == want


def test_capacity_table_is_read_once_per_kernel_and_device(monkeypatch):
    """Sizes 9–16 at a whole SM's threads and shared memory, through each
    kernel's prepare call; a size the card refuses counts 0 clusters."""
    calls = []

    def prepare(kernel):
        def call(cluster, threads, smem, fit):
            calls.append((kernel, cluster, threads, smem))
            fit._obj.value = 20 - cluster
            return 1 if cluster == 16 else 0
        return call

    monkeypatch.setattr(group_norm, "_CAPACITY", {})
    monkeypatch.setattr(group_norm, "_lib",
                        lambda: (None, None, prepare("forward")))
    monkeypatch.setattr(group_norm, "_bwd_lib",
                        lambda: (None, None, prepare("backward")))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    want = tuple((k, 20 - k) for k in range(9, 16)) + ((16, 0),)
    assert group_norm._capacity("forward", 0) == want
    assert group_norm._capacity("forward", 0) is group_norm._capacity(
        "forward", 0)
    assert group_norm._capacity("backward", 0) == want
    assert [c[:2] for c in calls] == [
        (kernel, k) for kernel in ("forward", "backward")
        for k in range(9, 17)]
    assert {c[2:] for c in calls} == {(256, SMEM_PER_BLOCK)}


@pytest.mark.parametrize("shape", [(2, 64, 224, 224), (2, 24, 360, 360),
                                   (1, 2048, 30, 30)],
                         ids=["224sq_64", "odd_groups", "wide"])
def test_oversize_samples_take_the_two_pass_path(shape):
    """Samples beyond 16 blocks (3 channels per group at odd_groups)."""
    n, c, h, w = shape
    plan = group_norm._plan(n, h, w, c, 8, CAPACITY["flat"])
    assert plan.path == "two_pass" and plan.cluster == 0
    assert plan == group_norm._two_pass_plan(n, h, w, c)
    assert group_norm._one_pass_smem(h * w, c, 8, 16,
                                     plan.threads) > SMEM_PER_BLOCK
    # the stats blocks cover every pixel, and none is empty
    assert plan.chunks * plan.rows_per_chunk >= h * w
    assert (plan.chunks - 1) * plan.rows_per_chunk < h * w


@pytest.mark.parametrize("err,fit", [(0, 0), (1, 4), (720, 0)],
                         ids=["no_cluster_fits", "cuda_error", "both"])
def test_cluster_capacity_check_raises(err, fit):
    """A card that cannot hold the plan's cluster raises before a launch."""
    plan = group_norm._plan(256, 112, 112, 64, 32)
    with pytest.raises(RuntimeError, match="cannot run a cluster of 8"):
        group_norm._check_capacity(plan, err, fit)
    group_norm._check_capacity(plan, 0, 16)


def test_reset_launches_zeroes_every_count(monkeypatch):
    monkeypatch.setattr(group_norm, "launches", 7)
    monkeypatch.setattr(group_norm, "launches_by_path",
                        {"one_pass": 5, "two_pass": 2})
    group_norm.reset_launches()
    assert group_norm.launches == 0
    assert group_norm.launches_by_path == {"one_pass": 0, "two_pass": 0}


# ---- the backward's plan: ``group_norm._plan_backward`` ----

# the sites where x and dz of a sample exceed 8 blocks' shared memory
# together: 112²×64 (the stem's norm) and 56²×256 (stage 1's outputs)
X_STREAMED = {(64, 112, 112, 32), (256, 56, 56, 32)}


@pytest.mark.parametrize("batch", [1, 32, 64, 256])
def test_every_resnet50_norm_backward_takes_the_one_pass_path(batch):
    streamed = 0
    for c, h, w, groups in SITES:
        plan = group_norm._plan_backward(batch, h, w, c, groups)
        assert plan.path == "one_pass" and plan.launches == 1, (c, h, w)
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.smem <= SMEM_PER_BLOCK
        assert plan.smem == group_norm._one_pass_bwd_smem(
            h * w, c, groups, plan.cluster, plan.threads, plan.x_resident)
        # the block's share of dz (and of x, where resident) is in its
        # shared memory
        tensors = 2 if plan.x_resident else 1
        assert plan.smem >= tensors * -(-h * w // plan.cluster) * c * 2
        assert plan.threads % (c // 8) == 0 and plan.threads <= 256
        streamed += not plan.x_resident
    assert streamed == 5


@pytest.mark.parametrize("site", sorted(set(SITES)),
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_backward_x_resident_exactly_where_x_and_dz_fit(site):
    c, h, w, groups = site
    plan = group_norm._plan_backward(64, h, w, c, groups)
    both_fit = group_norm._one_pass_bwd_smem(
        h * w, c, groups, 8, plan.threads, True) <= SMEM_PER_BLOCK
    assert plan.x_resident == both_fit
    assert (site in X_STREAMED) == (not plan.x_resident)


@pytest.mark.parametrize("site", sorted(set(SITES)),
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_backward_cluster_is_the_least_that_fits(site):
    c, h, w, groups = site
    plan = group_norm._plan_backward(32, h, w, c, groups)
    if plan.cluster > 1:
        smaller = group_norm._one_pass_bwd_smem(
            h * w, c, groups, plan.cluster // 2, plan.threads,
            plan.x_resident)
        assert smaller > SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", [(2, 64, 224, 224), (2, 24, 360, 360),
                                   (1, 2048, 30, 30)],
                         ids=["224sq_64", "odd_groups", "wide"])
def test_oversize_backward_takes_the_four_launch_path(shape):
    n, c, h, w = shape
    plan = group_norm._plan_backward(n, h, w, c, 8, CAPACITY["flat"])
    assert plan.path == "four_launch" and plan.launches == 4
    assert plan.cluster == 0 and not plan.x_resident
    # dz alone does not fit 16 blocks
    assert group_norm._one_pass_bwd_smem(
        h * w, c, 8, 16, plan.threads, False) > SMEM_PER_BLOCK
    assert plan.chunks * plan.rows_per_chunk >= h * w
    assert (plan.chunks - 1) * plan.rows_per_chunk < h * w


def test_plan_backward_is_cached():
    first = group_norm._plan_backward(64, 28, 28, 512, 32)
    hits = group_norm._plan_backward.cache_info().hits
    assert group_norm._plan_backward(64, 28, 28, 512, 32) is first
    assert group_norm._plan_backward.cache_info().hits == hits + 1


def test_reset_launches_zeroes_the_backward_counts(monkeypatch):
    assert set(group_norm.launches_by_path) == {
        "one_pass", "two_pass", "backward_one_pass", "backward_four_launch"}
    for k in group_norm.launches_by_path:
        monkeypatch.setitem(group_norm.launches_by_path, k, 3)
    monkeypatch.setattr(group_norm, "launches", 12)
    group_norm.reset_launches()
    assert group_norm.launches == 0
    assert all(v == 0 for v in group_norm.launches_by_path.values())


@pytest.mark.parametrize("shape", [(64, 64, 56, 56), (2, 64, 224, 224),
                                   (64, 64, 147, 147), (64, 192, 71, 71)],
                         ids=["one_pass", "four_launch", "wide_147x64",
                              "wide_71x192"])
def test_backward_scratch_is_cached_and_zeroed(monkeypatch, shape):
    """One zeroed scratch per (device, stream, n, c, groups, path), sized
    for the plan (a one pass's tickets one for each of up to 16 ranks),
    and the same tensor on the next call."""
    monkeypatch.setattr(group_norm, "_BWD_SCRATCH", {})
    n, c, h, w = shape
    plan = group_norm._plan_backward(n, h, w, c, 32, CAPACITY["flat"])
    assert group_norm._TICKETS == 16 >= plan.cluster
    cpu = torch.device("cpu")
    buf = group_norm._bwd_scratch(cpu, 0, n, c, 32, plan)
    if plan.path == "one_pass":
        assert buf.numel() == n * c * 2 + 16
    else:
        assert buf.numel() == (n * plan.chunks * c * 2 + n * c * 2
                               + n * 32 * 2)
    assert not bool(buf.any())
    assert group_norm._bwd_scratch(cpu, 0, n, c, 32, plan) is buf
    assert group_norm._bwd_scratch(cpu, 1, n, c, 32, plan) is not buf


def test_backward_wrapper_checks_dy_before_any_launch():
    x = torch.zeros(2, 16, 4, 4, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    dy = torch.zeros(2, 16, 4, 4, dtype=torch.float32)
    with pytest.raises(ValueError, match="does not match x"):
        group_norm._launch_backward(dy, x, x, torch.ones(16),
                                    torch.zeros(2, 8, 2), 8, False, True)
