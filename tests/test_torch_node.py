"""The port's node runtime helpers: card claiming and visibility, the
rendezvous health probe, and when ``torch.distributed`` is formed.

Counterparts of the JAX package's ``chip_info``, ``health`` and
``parallel/distributed`` rules, on the CPU (no card here).
"""

import types

import pytest

from tensorflowonspark_torch import chip_info, gpu_info, health
from tensorflowonspark_torch.parallel import distributed


def test_num_host_chips_override_and_count(monkeypatch):
    monkeypatch.setenv("TFOS_NUM_CHIPS", "3")
    assert chip_info.get_num_host_chips() == 3
    monkeypatch.delenv("TFOS_NUM_CHIPS")
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_info.get_num_host_chips() == 0


def test_claims_partition_the_cards(monkeypatch, tmp_path):
    monkeypatch.setenv("TFOS_NUM_CHIPS", "2")
    monkeypatch.setenv("TFOS_SCRATCH_ROOT", str(tmp_path))
    monkeypatch.setattr(chip_info, "MAX_RETRIES", 0)
    first = chip_info.claim_chips(1, "app", "executor_0")
    second = chip_info.claim_chips(1, "app", "executor_1")
    assert sorted(first + second) == [0, 1]
    with pytest.raises(RuntimeError, match="could not claim"):
        chip_info.claim_chips(1, "app", "executor_2")
    chip_info.release_chips(first + second, "app")
    assert gpu_info.get_gpus(2, app_id="app") == "0,1"
    chip_info.release_chips([0, 1], "app")
    with pytest.raises(RuntimeError, match="only 2"):
        chip_info.claim_chips(3, "app", "executor_0")


def test_visibility_env_maps_through_an_inherited_list(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    chip_info.set_visibility_env([1, 0])
    import os

    assert os.environ["CUDA_VISIBLE_DEVICES"] == "1,0"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,6,7")
    chip_info.set_visibility_env([2])
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "7"
    chip_info.set_visibility_env([])  # nothing claimed: unchanged
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "7"


def test_should_probe_rules(monkeypatch):
    monkeypatch.delenv("TFOS_HEALTH_PROBE", raising=False)
    assert health.should_probe({}, [0])
    assert not health.should_probe({}, [])
    assert health.should_probe({"health_probe": True}, [])
    monkeypatch.setenv("TFOS_HEALTH_PROBE", "0")
    assert not health.should_probe({"health_probe": True}, [0])


def test_probe_passes_on_a_healthy_device_and_names_a_hang(monkeypatch):
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert health.probe_chip_health(timeout_s=120) is None
    monkeypatch.setenv("TFOS_HEALTH_PROBE_HANG", "1")
    reason = health.probe_chip_health(timeout_s=2)
    assert reason is not None and "hung" in reason


def test_process_group_is_formed_only_where_it_should_be(monkeypatch):
    """One node, ``TFOS_TORCH_DISTRIBUTED=0`` and card-less hosts without
    ``=1`` all skip ``init_process_group``; the rank is the position among
    the sorted executor ids."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(distributed, "master_address",
                        lambda ctx: "127.0.0.1:1234")
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setenv("TFOS_NUM_CHIPS", "0")
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")

    def ctx(eid, ids):
        return types.SimpleNamespace(
            executor_id=eid, num_workers=len(ids),
            cluster_info=[{"executor_id": i} for i in ids])

    monkeypatch.delenv(distributed.DISTRIBUTED_ENV, raising=False)
    assert not distributed.maybe_initialize(ctx(0, [0]))
    assert not distributed.maybe_initialize(ctx(0, [0, 2]))
    monkeypatch.setenv(distributed.DISTRIBUTED_ENV, "0")
    assert not distributed.maybe_initialize(ctx(0, [0, 2]))
    assert calls == []
    monkeypatch.setenv(distributed.DISTRIBUTED_ENV, "1")
    assert distributed.maybe_initialize(ctx(2, [0, 2]))
    [(args, kwargs)] = calls
    assert args == ("gloo",)
    assert kwargs["init_method"] == "tcp://127.0.0.1:1234"
    assert (kwargs["world_size"], kwargs["rank"]) == (2, 1)
