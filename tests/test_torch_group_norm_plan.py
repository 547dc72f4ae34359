"""How the GroupNorm wrapper picks the kernel's path, checked on the CPU.

``group_norm._plan`` is pure Python: by shape alone it sends a call to the
one-pass cluster kernel (a sample in the shared memory of at most 8
blocks) or to the two-pass kernels.  The norm shapes come from the real
ResNet-50 forward, traced on the ``meta`` device (no weights, no compute).
"""

import collections

import pytest
import torch

from tensorflowonspark_torch.kernels import group_norm
from tensorflowonspark_torch.models import resnet

SMEM_PER_BLOCK = 232448  # an H100 block's dynamic shared memory


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


@pytest.mark.parametrize("site", sorted(set(SITES)),
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_one_pass_cluster_is_the_least_that_fits(site):
    c, h, w, groups = site
    plan = group_norm._plan(32, h, w, c, groups)
    if plan.cluster > 1:
        smaller = group_norm._one_pass_smem(h * w, c, groups,
                                            plan.cluster // 2, plan.threads)
        assert smaller > SMEM_PER_BLOCK


@pytest.mark.parametrize("shape", [(2, 64, 224, 224), (2, 24, 250, 250),
                                   (1, 2048, 30, 30)],
                         ids=["224sq_64", "odd_groups", "wide"])
def test_oversize_samples_take_the_two_pass_path(shape):
    n, c, h, w = shape
    plan = group_norm._plan(n, h, w, c, 8)
    assert plan.path == "two_pass" and plan.cluster == 0
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
