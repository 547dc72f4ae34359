"""Pieces of ``chip_smoke.py`` that need no card: its profiler filter and
kernel families, the table path's bounds and the wide&deep data it
draws; and the stamped source ``tools/torch_grouping_probe.py`` builds."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from tensorflowonspark_torch.models import widedeep


def _event(name, us, device=True, annotation=False):
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, device_type=kind.CUDA if device else kind.CPU,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(elapsed_us=lambda: us))


def test_device_kernels_leave_out_host_ops_and_annotation_spans():
    """The optimizer's ``record_function`` span shows on the card's
    timeline as a CUDA event covering its kernels: counting it too
    doubles the optimizer's device time (the fault the profile phases had
    until the wide&deep step's profile showed it as half the step)."""
    lambda_kernel = ("void at::native::elementwise_kernel<128, 4, "
                     "at::native::gpu_kernel_impl_nocast<at::native::"
                     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
                     "{lambda()#3}::operator()() const::{lambda(float)#1}> >")
    prof = types.SimpleNamespace(events=lambda: [
        _event("Optimizer.step#AdamW.step", 300.0, annotation=True),
        _event("Optimizer.step#AdamW.step", 300.0),  # flag missing: by name
        _event("void multi_tensor_apply_kernel<...>", 150.0),
        _event("aten::mm", 500.0, device=False),
        _event(lambda_kernel, 100.0),  # a kernel whose name holds '#'
        _event(GROUPING, 50.0),
    ])
    assert list(chip_smoke.device_kernels(prof, calls=5)) == [
        ("void multi_tensor_apply_kernel<...>", 0.03),
        (lambda_kernel, 0.02),
        (GROUPING, 0.01)]


#: the table path's kernels as the profiler names them on the card
GROUPING = ("void (anonymous namespace)::tfos_id_grouping<int>(int const*, "
            "long, int, int, int*, int*, int*, int*, int*, int*)")
UPDATE = ("void (anonymous namespace)::tfos_adagrad_segment_walk<1, 2>(int "
          "const*, int const*, int const*, int const*, (anonymous namespace)"
          "::TableArg, (anonymous namespace)::TableArg, int, float, float, "
          "int)")


def test_step_families_name_the_table_kernels_apart_from_the_sort():
    """The grouping kernel is a radix sort too: it must be booked under
    its own family, not as ``torch.sort``'s, and the update not as
    "other"."""
    cub = ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<"
           "at_cuda_detail::cub::DeviceRadixSortPolicy<int, long, unsigned "
           "int>::Policy900, true, int, long>")
    assert chip_smoke.wd_step_family(GROUPING) == "id grouping"
    assert chip_smoke.wd_step_family(UPDATE) == "table update"
    assert chip_smoke.wd_step_family(cub) == "id sort"
    assert chip_smoke.wd_step_family(
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n") == "GEMMs"
    assert chip_smoke.wd_step_family(
        "void at::native::vectorized_elementwise_kernel<4>") == "other"
    assert chip_smoke.table_family(cub) is None


def test_table_bound_counts_the_touched_rows_once():
    bound = chip_smoke.table_bound_ms(n=1024 * 26, id_bytes=4, dim=32,
                                      unique=26_473)
    want = 26_624 * 4 + 26_624 * 32 * 4 + 26_473 * 32 * 4 * 4
    assert bound["bytes"] == want and bound["bound_by"] == "bytes"
    assert abs(bound["bound_ms"] - want / chip_smoke.HBM_BYTES_PER_S * 1e3) \
        < 1e-12


def test_step_bound_sums_each_resource_over_the_pair():
    """A training step's two table calls: bytes and operations each summed,
    then the larger taken, and ``bound_by`` names it."""
    deep = chip_smoke.table_bound_ms(n=26_624, id_bytes=4, dim=32,
                                     unique=26_473)
    wide = chip_smoke.table_bound_ms(n=26_624, id_bytes=4, dim=1,
                                     unique=26_473)
    pair = chip_smoke._bound(deep["bytes_ms"] + wide["bytes_ms"],
                             deep["ops_ms"] + wide["ops_ms"])
    assert pair["bound_by"] == "bytes"
    assert pair["bound_ms"] == deep["bytes_ms"] + wide["bytes_ms"]
    assert chip_smoke._bound(1.0, 2.0) == {
        "bound_ms": 2.0, "bytes_ms": 1.0, "ops_ms": 2.0,
        "bound_by": "operations"}


def test_step_bound_of_the_pair_under_zipf_ids():
    """The step's table path (deep and wide sharing 26,624 int32 ids, the
    ≈ 17,300 rows a Zipf(1.1) batch touches): the ids counted once, each
    table's gradient rows, and each touched row of both tables and
    accumulators read and written; bytes bound it."""
    rng = np.random.RandomState(0)
    ids = chip_smoke.criteo_ids(rng, 1024, 100_000, chip_smoke.WD_ZIPF)
    ids = ids + np.arange(widedeep.NUM_CAT) * 100_000
    unique = len(np.unique(ids))
    assert 15_000 < unique < 20_000
    bound = chip_smoke.step_bound_ms(n=ids.size, id_bytes=4, dims=(32, 1),
                                     unique=unique)
    want = (26_624 * 4 + 26_624 * 32 * 4 + 26_624 * 4
            + unique * 32 * 16 + unique * 16)
    assert bound["bytes"] == want and bound["bound_by"] == "bytes"
    assert bound["bound_ms"] == pytest.approx(
        want / chip_smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    deep = chip_smoke.table_bound_ms(26_624, 4, 32, unique)
    assert bound["bytes"] < deep["bytes"] + chip_smoke.table_bound_ms(
        26_624, 4, 1, unique)["bytes"]  # the ids once, not twice


def test_grouping_bound_counts_ids_in_and_groups_out():
    bound = chip_smoke.group_bound_ms(n=26_624, id_bytes=8, segments=17_000)
    assert bound["bytes"] == 26_624 * 8 + 26_624 * 8 + 17_001 * 4 + 8
    assert bound["bound_by"] == "bytes"


def test_criteo_draws_are_seeded_and_zipf_is_heavy_tailed():
    rng = np.random.RandomState(0)
    uniform = chip_smoke.criteo_ids(rng, 1024, 100_000)
    zipf = chip_smoke.criteo_ids(rng, 1024, 100_000, chip_smoke.WD_ZIPF)
    assert uniform.shape == zipf.shape == (1024, widedeep.NUM_CAT)
    assert zipf.min() >= 0 and zipf.max() < 100_000
    # bucket 0 is a Zipf(1.1) feature's most frequent value, by far
    assert (zipf == 0).mean() > 0.05 > (uniform == 0).mean()
    assert len(np.unique(zipf[:, 0])) < len(np.unique(uniform[:, 0]))
    rows = chip_smoke.synth_criteo(16, 50, seed=3, zipf=chip_smoke.WD_ZIPF)
    assert rows == chip_smoke.synth_criteo(16, 50, seed=3,
                                           zipf=chip_smoke.WD_ZIPF)
    batch = chip_smoke.rows_to_batch(rows)
    assert batch["dense"].shape == (16, widedeep.NUM_DENSE)
    assert batch["cat"].dtype == np.int32 and batch["label"].dtype == np.int32


def test_grouping_probe_stamps_every_phase_of_the_kernel_source():
    """The probe finds each of its markers once in the shipped source
    (it stops on a missing one, so a kernel edit that moves a phase shows
    here, on the CPU, before a chip run)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(chip_smoke.__file__), "tools",
                        "torch_grouping_probe.py")
    spec = importlib.util.spec_from_file_location("probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = probe.stamped_source()
    assert src.count("STAMP(") == len(probe.MARKS) + 2  # + STAMP(0), define
    assert "tfos_probe_read" in src


# ---------------------------------------------------------------------------
# Phases 11-12 (InputMode.TENSORFLOW): the replays, the gates, the rates
# ---------------------------------------------------------------------------


@pytest.fixture()
def one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def test_tf_resnet_replay_follows_the_examples_reader(tmp_path, one_thread):
    """Phase 11's replay reads the one node's shard with the example's
    arguments (batch 64, one reader, the seeded shuffle of task 0): the
    same batches as a plain ``tfrecord_batches`` loop with them, into a
    fresh trainer, the same losses each time."""
    from tensorflowonspark_torch import readers
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    resnet.write_synthetic_tfrecords(str(tmp_path), 2 * 64 + 5, 3, 16,
                                     seed=1, num_classes=10)
    args = chip_smoke.tf_resnet_args(str(tmp_path), tiny=True)
    assert (args.batch_size, args.readers, args.shuffle_buffer, args.epochs,
            args.lr) == (chip_smoke.SLICE_TRAIN_BATCH, 1,
                         chip_smoke.TF_SHUFFLE, 1, chip_smoke.TRAIN_LR)
    replay = chip_smoke.tf_resnet_replay(args, "cpu")
    assert len(replay) == 2 and all(np.isfinite(replay))
    assert chip_smoke.tf_resnet_replay(args, "cpu") == replay
    t = Trainer("resnet50", config=resnet.Config.tiny(),
                learning_rate=chip_smoke.TRAIN_LR, device="cpu")
    files = sorted(str(p) for p in tmp_path.glob("part-*"))
    want = [float(t.step(b)) for b in readers.tfrecord_batches(
        files, 64, parse_fn=resnet.tfrecord_parse_fn(16), readers=1,
        shuffle_buffer=chip_smoke.TF_SHUFFLE, shuffle_files=True, seed=0,
        drop_remainder=True)]
    assert replay == want


def test_tf_wd_replay_trains_on_the_saved_rows(tmp_path, one_thread):
    """Phase 12's replay: the DataFrame saved by ``dfutil.saveAsParquet``
    comes back through ``parquet_batches`` and the example's stager as the
    rows, in partition order, with the step's dtypes."""
    from tensorflowonspark_torch import dfutil, sparkapi

    rows = chip_smoke.synth_criteo(2 * 1024, widedeep.Config.tiny()
                                   .hash_buckets, seed=9,
                                   zipf=chip_smoke.WD_ZIPF)
    args = chip_smoke.tf_wd_args(str(tmp_path), tiny=True)
    assert (args.batch_size, args.epochs, args.input, args.tiny) == (
        chip_smoke.WD_BATCH, 1, "parquet", True)
    assert chip_smoke.tf_wd_args(str(tmp_path)).tiny is False
    sc = sparkapi.LocalSparkContext("local[1]")
    try:
        df = sparkapi.LocalSparkSession(sc).createDataFrame(
            rows, ["dense", "cat", "label"]).repartition(4)
        dfutil.saveAsParquet(df, args.parquet_dir)
    finally:
        sc.stop()
    losses, seen = chip_smoke.tf_wd_replay(args, "cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    want = chip_smoke.rows_to_batch(rows)
    for k in want:
        assert seen[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(seen[k], want[k], err_msg=k)
    assert chip_smoke.tf_wd_replay(args, "cpu")[0] == losses


def _node(**over):
    node = {"state": "finished", "device": "cuda:0", "losses": [2.0, 1.5],
            "launches": {"group": 2, "combine": 2, "sparse": 0}}
    node.update(over)
    return node


def test_slice_gates_pass_a_good_node_and_name_each_fault():
    want = {"group": 2, "combine": 2, "sparse": 0}
    gate = dict(steps=2, want_launches=want, tol=1e-5, final_only=False)
    assert chip_smoke.slice_failures(_node(), [2.0, 1.5], **gate) == []
    assert chip_smoke.slice_failures(
        _node(device="cpu"), [2.0, 1.5], **gate, device="cpu") == []
    faults = {
        "state": _node(state="failed"),
        "device": _node(device="cpu"),
        "steps": _node(losses=[2.0]),
        "finite": _node(losses=[2.0, float("nan")]),
        "rel": _node(losses=[2.0, 1.5 * (1 + 2e-5)]),
        "launches": _node(launches={"group": 2, "combine": 1, "sparse": 0}),
    }
    for name, node in faults.items():
        failures = chip_smoke.slice_failures(node, [2.0, 1.5], **gate)
        assert failures, name
    # the final loss only (phase 11): an earlier step may differ
    assert chip_smoke.slice_failures(
        _node(losses=[2.1, 1.5]), [2.0, 1.5], **{**gate, "final_only": True,
                                                 "tol": 1e-2}) == []
    assert chip_smoke.loss_rel([2.1, 1.5], [2.0, 1.5], False) == \
        pytest.approx(0.05)
    assert chip_smoke.loss_rel([], [], True) == float("inf")


def test_slice_rates_read_the_one_nodes_metrics():
    agg = {"total_examples_per_sec": 2048.0, "nodes": {"chief:0": {
        "step": 8, "total_examples": 8192, "elapsed_sec": 4.0}}}
    assert chip_smoke.slice_rates(agg, 1024) == {
        "rate": 2.0, "wall_rate": 2.0, "steps": 8}
    assert chip_smoke.slice_rates(agg, 1)["wall_rate"] == 2048.0
    idle = {"total_examples_per_sec": None, "nodes": {"chief:0": {
        "step": 0, "total_examples": 0, "elapsed_sec": 0.0}}}
    assert chip_smoke.slice_rates(idle, 1) == {
        "rate": None, "wall_rate": None, "steps": 0}


def test_job_timeline_splits_the_wall_time():
    node = {"map_fun_start": 102.0, "map_fun_end": 110.5}
    assert chip_smoke.job_timeline(100.0, 101.0, 111.0, node, 2.5) == (
        "formed 1.0 s, map_fun started at 2.0 s, trainer build 6.0 s, "
        "loop 2.5 s, after the loop 0.5 s")
    assert chip_smoke.job_timeline(100.0, 101.0, 111.0, {}, 2.5) == (
        "timeline not published")
