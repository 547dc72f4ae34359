"""Pieces of ``chip_smoke.py`` that need no card: its profiler filter and
kernel families, the table path's bounds and the wide&deep data it
draws; and the stamped source ``tools/torch_grouping_probe.py`` builds."""

import os
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
    per_step = {"group": 1, "combine": 1, "sparse": 0}
    gate = dict(steps=2, per_step=per_step, tol=1e-5, final_only=False)
    assert chip_smoke.slice_failures(_node(), [2.0, 1.5], **gate) == []
    # a step a graph replay ran alone is not counted by the wrappers
    assert chip_smoke.slice_failures(_node(
        replays=1, launches={"group": 1, "combine": 1, "sparse": 0}),
        [2.0, 1.5], **gate) == []
    assert chip_smoke.slice_failures(
        _node(device="cpu"), [2.0, 1.5], **gate, device="cpu") == []
    faults = {
        "state": _node(state="failed"),
        "device": _node(device="cpu"),
        "steps": _node(losses=[2.0]),
        "finite": _node(losses=[2.0, float("nan")]),
        "rel": _node(losses=[2.0, 1.5 * (1 + 2e-5)]),
        "launches": _node(launches={"group": 2, "combine": 1, "sparse": 0}),
        "launches (want": _node(replays=1),
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


# ---------------------------------------------------------------------------
# Phase 13 (persistence): the resumed job's arguments, the snapshot check
# and its planted fault, the CPU export, the gates and the last line
# ---------------------------------------------------------------------------


def test_resume_args_continue_phase_11s_reader(tmp_path, one_thread):
    """The resumed job reads two epochs of the same records and stops
    ``RESUME_STEPS`` after the first epoch: its first epoch is phase 11's,
    batch for batch, so steps 9-12 of one replay are what it trains on."""
    from tensorflowonspark_torch.models import resnet

    resnet.write_synthetic_tfrecords(str(tmp_path / "r"), 2 * 64, 2, 16,
                                     seed=1, num_classes=10)
    args = chip_smoke.tf_resnet_args(str(tmp_path / "r"), tiny=True,
                                     ckpt_dir=str(tmp_path / "ck"),
                                     model_dir=str(tmp_path / "ex"))
    assert (args.ckpt_dir, args.model_dir) == (str(tmp_path / "ck"),
                                               str(tmp_path / "ex"))
    resume = chip_smoke.tf_resnet_resume_args(args)
    assert (resume.epochs, resume.model_dir, resume.ckpt_dir) == (
        2, None, args.ckpt_dir)
    assert resume.max_steps == (chip_smoke.TF_RECORDS // args.batch_size
                                + chip_smoke.RESUME_STEPS)
    resume.max_steps = 3  # 2 batches an epoch here
    longer, state = chip_smoke.tf_resnet_replay(resume, "cpu",
                                                with_state=True)
    assert len(longer) == 3
    assert longer[:2] == chip_smoke.tf_resnet_replay(args, "cpu")
    assert int(state["step"]) == 3
    assert any(k.startswith("opt_state/") for k in state)


def test_the_cadence_reaches_the_example_through_the_environment(
        monkeypatch):
    """Phase 11's and 13's jobs checkpoint at their last steps (8, then 4
    after the restore) by ``TFOS_CKPT_EVERY_STEPS``, set in the executor
    only while the example's ``map_fun`` runs."""
    from tensorflowonspark_torch.examples import resnet_spark

    seen = []
    monkeypatch.setattr(resnet_spark, "map_fun", lambda args, ctx: seen.append(
        os.environ.get("TFOS_CKPT_EVERY_STEPS")))
    ctx = types.SimpleNamespace(mgr=types.SimpleNamespace(
        set=lambda k, v: None))
    args = chip_smoke.tf_resnet_args("records", ckpt_dir="ck")
    resume = chip_smoke.tf_resnet_resume_args(args)
    monkeypatch.delenv("TFOS_CKPT_EVERY_STEPS", raising=False)
    chip_smoke.tf_resnet_map_fun(args, ctx)
    assert "TFOS_CKPT_EVERY_STEPS" not in os.environ
    monkeypatch.setenv("TFOS_CKPT_EVERY_STEPS", "7")
    chip_smoke.tf_resnet_map_fun(resume, ctx)
    assert os.environ["TFOS_CKPT_EVERY_STEPS"] == "7"
    steps = chip_smoke.TF_RECORDS // chip_smoke.SLICE_TRAIN_BATCH
    assert seen == [str(steps), str(chip_smoke.RESUME_STEPS)]


def test_counted_jobs_publish_their_launches(monkeypatch):
    """A counted job publishes the GroupNorm launches its ``map_fun`` made
    (counted from 0) and the table kernels' (their counters left running,
    so phase 14 can read an executor's across its jobs)."""
    import functools

    from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad
    from tensorflowonspark_torch.parallel import train as train_lib

    published = {}
    ctx = types.SimpleNamespace(mgr=types.SimpleNamespace(
        set=published.__setitem__))
    monkeypatch.setattr(train_lib, "replayed_steps", 0)
    monkeypatch.setitem(group_norm.launches_by_path, "one_pass", 7)
    monkeypatch.setitem(sparse_adagrad.launches_by_path, "group", 5)

    def map_fun(args, ctx):
        group_norm.launches_by_path["two_pass"] += 2
        sparse_adagrad.launches_by_path["group"] += 1
        sparse_adagrad.launches_by_path["combine"] += 3
        train_lib.replayed_steps += 4

    monkeypatch.setitem(group_norm.launches_by_path, "two_pass", 0)
    monkeypatch.setitem(sparse_adagrad.launches_by_path, "combine", 0)
    functools.partial(chip_smoke.run_counted, map_fun)(None, ctx)
    assert published["launches"] == chip_smoke.launch_counts(two_pass=2)
    assert published["table_launches"] == {"group": 1, "sparse": 0,
                                           "combine": 3}
    assert sparse_adagrad.launches_by_path["group"] == 6
    assert published["replays"] == 4
    assert published["map_fun_start"] <= published["map_fun_end"]


def test_snapshot_check_passes_and_catches_the_planted_fault(
        tmp_path, one_thread, monkeypatch):
    """Phase 13(b) on the tiny ResNet on the CPU: the committed checkpoint
    is the clone taken when the save fired; the planted fault (a writer
    reading the live tensors) differs from it in every tensor the next
    steps moved."""
    from tensorflowonspark_torch import ckpt
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    t = Trainer("resnet50", config=resnet.Config.tiny(), device="cpu",
                learning_rate=1e-2)
    batch = t.shard(resnet.example_batch(resnet.Config.tiny(), 8))
    good = chip_smoke.snapshot_run(t, batch, str(tmp_path / "a"), False)
    # each run takes 4 steps before checkpointing is on, and the save
    # fires at the second step after
    assert good["diff"] == [] and good["step"] == 6 and good["bytes"] > 0
    assert ckpt._Snapshot is not chip_smoke._LiveSnapshot
    planted = chip_smoke.snapshot_run(t, batch, str(tmp_path / "b"), True)
    assert ckpt._Snapshot is not chip_smoke._LiveSnapshot  # restored
    assert planted["step"] == 18  # the first run took 12 steps
    assert any(k.startswith("params/") for k in planted["diff"])
    assert any(k.startswith("opt_state/") for k in planted["diff"])


def test_state_rel_finds_the_tensor_furthest_from_the_replay():
    want = {"a": np.array([1.0, -4.0]), "b": np.zeros(2), "step": 12}
    assert chip_smoke.state_rel(dict(want), want) == (None, 0.0)
    assert chip_smoke.state_rel(
        {**want, "a": np.array([1.0, -3.0])}, want) == ("a", 0.25)
    assert chip_smoke.state_rel({**want, "step": 4}, want) == (
        "step", 8 / 12)
    assert chip_smoke.state_rel({**want, "b": np.ones(2)}, want) == (
        "b", float("inf"))
    assert chip_smoke.state_rel({"a": want["a"]}, want)[1] == float("inf")
    assert chip_smoke.state_rel({**want, "a": np.ones(3)}, want)[1] == (
        float("inf"))


def test_restart_reader_is_timed_after_the_skipped_batches(
        tmp_path, monkeypatch):
    """Phase 13(a)'s restart reader on the CPU: the first batch after
    ``skip`` trained ones arrives, over as many passes as that takes."""
    from tensorflowonspark_torch.models import resnet

    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "TF_RECORDS", 32)
    resnet.write_synthetic_tfrecords(str(tmp_path / "r"), 32, 2, 16,
                                     seed=1, num_classes=10)
    args = chip_smoke.tf_resnet_args(str(tmp_path / "r"), tiny=True)
    args.batch_size = 4
    assert chip_smoke.restart_reader_s(args, 21) > 0


def test_state_diff_names_every_difference():
    a = {"x": np.zeros(2), "y": np.ones(1, np.float32)}
    assert chip_smoke.state_diff(a, dict(a)) == []
    assert chip_smoke.state_diff(a, {"x": np.zeros(2)}) == ["y"]
    assert chip_smoke.state_diff(
        a, {"x": np.array([0.0, -0.0]), "y": np.ones(1)}) == ["y"]
    assert chip_smoke.state_diff(
        a, {"x": np.array([0.0, 1e-30]), "y": a["y"]}) == ["x"]


def test_cpu_export_process_writes_a_servable_export(tmp_path, one_thread):
    """Phase 13(d)'s second export: a process that sees no card re-exports
    a weights export with its serialized forward; it serves as the weights
    do."""
    from tensorflowonspark_torch import ckpt, compat, saved_model
    from tensorflowonspark_torch.models import resnet

    config = resnet.Config.tiny()
    model = resnet.make_model(config, seed=3).eval()
    compat.export_saved_model(resnet.state_of(model), str(tmp_path / "w"))
    proc = chip_smoke.start_cpu_export(str(tmp_path / "w"),
                                       str(tmp_path / "cpu"))
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out
    fn, sig = saved_model.load_forward(str(tmp_path / "cpu"), "cpu")
    assert sig["model_name"] == "resnet50" and sig["batch"] == "polymorphic"
    images = np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32)
    state = ckpt.load_pytree(str(tmp_path / "cpu" / "model"))
    with torch.inference_mode():
        want = model(torch.from_numpy(images))
    torch.testing.assert_close(fn(state, {"image": images}), want, rtol=0,
                               atol=0)


def test_phase_13_gates_and_the_last_line():
    """Every gate of phase 13 raises through one ``SystemExit``; its
    launches reach the kernels line; the last line is the contract's."""
    import inspect

    src = inspect.getsource(chip_smoke.persistence_phase)
    for gate in ("(a) ", "(b) the checkpoint is not the snapshot",
                 "(b) the restored trainer is not the snapshot",
                 "'s state is {state_err:.3e} from the ",
                 "tol=RESUME_LOSS_REL",
                 "(b) the planted fault", "(c) restored step",
                 "(c) the restored trainer differs", "(c) table launches",
                 "(d) the {label}-written export", "(d) wide_deep",
                 "(e) the re-export was not served fresh",
                 "restored step"):
        assert gate in src, gate
    assert 'raise SystemExit("persistence phase failed: "' in src
    main = inspect.getsource(chip_smoke.main)
    assert main.count('"launches_phase13"') == 3
    assert main.index("persistence_phase(") < main.index("print(card)")
    last = main[main.rindex("print(json.dumps("):]
    assert '{"ok": True, "device": {' in last
    assert '"platform": "gpu", "kind": torch.cuda.get_device_name(0)' in last
    assert '"count": torch.cuda.device_count()}}' in last


def test_phase_10_serves_wide_deep_by_name_and_serialized():
    """Phase 10 scores the export through its serialized forward and, by
    ``setModelName("wide_deep")``, a weights-only export of the same
    weights through the zoo's forward; both gate."""
    import inspect

    src = inspect.getsource(chip_smoke.wd_slice_phase)
    assert "compat.export_saved_model(state, weights_only)" in src
    assert '.setExportDir(weights_only).setModelName("wide_deep")' in src
    assert "not serialized_err <= WD_SCORES_VS_FORWARD" in src
    assert "not by_name_err <= WD_SCORES_VS_FORWARD" in src


def test_zoo_site_tables_count_each_models_norms():
    """Phase 14's sites come from the real models on the ``meta`` device:
    Inception canonical 96 in training (its aux head's 2), the SAME
    variant 94, MobileNet 27, the CIFAR CNN 6."""
    tables = chip_smoke.zoo_site_tables()
    assert {k: sum(v.values()) for k, v in tables.items()} == {
        "inception_v3 canonical": 96, "inception_v3": 94,
        "mobilenet_v1": 27, "cifar10_cnn": 6}
    assert (768, 1, 1, 32) in tables["inception_v3 canonical"]
    assert (768, 1, 1, 32) not in tables["inception_v3"]
    assert len(set().union(*tables.values())) == 50


def test_step_launches_put_the_stem_on_the_one_pass():
    """A training step of Inception canonical launches its two stem
    samples beyond a cluster of 8 (147²×64, 71²×192) on the one pass too,
    over 9–16 blocks: no two-pass forward and no four-launch backward; a
    served batch (the SAME variant, 150²×64 and 75²×192) makes one-pass
    forwards only; MobileNet takes one pass everywhere."""
    tables = chip_smoke.zoo_site_tables()
    assert chip_smoke.step_launches(tables["inception_v3 canonical"], 8) \
        == {"one_pass": 8 * 96, "two_pass": 0, "backward_one_pass": 8 * 96,
            "backward_four_launch": 0}
    assert chip_smoke.step_launches(tables["inception_v3"], 3,
                                    backward=False) == {
        "one_pass": 3 * 94, "two_pass": 0, "backward_one_pass": 0,
        "backward_four_launch": 0}
    assert chip_smoke.step_launches(tables["mobilenet_v1"]) == {
        "one_pass": 27, "two_pass": 0, "backward_one_pass": 27,
        "backward_four_launch": 0}


def test_phase14_entry_sums_the_sites_of_each_path():
    """The kernels line's ``phase14_*`` numbers: per path, the sites that
    took it (as each case records), their summed times, the largest
    error, and apart each site over more than 8 blocks, with its cluster
    and its forced twin's ms, and each site off the one pass."""
    case = {"ms": 1.0, "bound_ms": 0.5, "library_ms": 2.0,
            "max_abs_err": 0.01, "path": "one_pass", "cluster": 2}
    wide = dict(case, ms=0.2, max_abs_err=0.02, cluster=16, two_pass_ms=0.3)
    bwd = dict(case, path="backward_one_pass", four_launch_ms=1.5)
    wide_bwd = dict(wide, path="backward_one_pass", cluster=13,
                    four_launch_ms=0.4)
    del wide_bwd["two_pass_ms"]
    kern = {"forward": {(64, 147, 147, 32): wide, (32, 17, 17, 32): case},
            "backward": {(64, 147, 147, 32): wide_bwd,
                         (32, 17, 17, 32): bwd}}
    site = f"{chip_smoke.ZOO_BATCH}x147x147x64/G32"
    one = chip_smoke.phase14_entry(kern, "one_pass")
    assert one == {"phase14_sites": 2, "phase14_max_abs_err": 0.02,
                   "phase14_ms": 1.2, "phase14_bound_ms": 1.0,
                   "phase14_library_ms": 4.0, "phase14_by_site": {site: {
                       "ms": 0.2, "bound_ms": 0.5, "library_ms": 2.0,
                       "max_abs_err": 0.02, "cluster": 16,
                       "two_pass_ms": 0.3}}}
    back = chip_smoke.phase14_entry(kern, "backward_one_pass")
    assert back["phase14_by_site"] == {site: {
        "ms": 0.2, "bound_ms": 0.5, "library_ms": 2.0, "max_abs_err": 0.02,
        "cluster": 13, "four_launch_ms": 0.4}}
    assert chip_smoke.phase14_entry(kern, "two_pass") == {}
    assert chip_smoke.phase14_entry(kern, "backward_four_launch") == {}
    off = dict(case, path="two_pass", cluster=0)
    assert chip_smoke.phase14_entry({"forward": {(64, 224, 224, 32): off}},
                                    "two_pass")["phase14_by_site"] == {
        f"{chip_smoke.ZOO_BATCH}x224x224x64/G32": {
            "ms": 1.0, "bound_ms": 0.5, "library_ms": 2.0,
            "max_abs_err": 0.01, "cluster": 0}}
    assert chip_smoke.phase14_entry({"forward": {}, "backward": {}},
                                    "two_pass") == {}


def test_phase_14_gates_and_the_kernels_line():
    """Every sub-phase of phase 14 gates, the failures raise one
    ``SystemExit`` after all ran, and its launches reach the kernels
    line."""
    import inspect

    for fn, gates in (
            (chip_smoke.inception_model_phase,
             ('"(b) gradients"', '"(b) trajectory"',
              'f"(b) the backward alone', "_planted_fault(drop)",
              "min(faults.values()) <= GRADS_SAME_FORWARD")),
            (chip_smoke.zoo_tf_slice, ("slice_failures(",)),
            (chip_smoke.zoo_serving, ('f"(e) {label}',
                                      "(name is None and not bits)")),
            (chip_smoke.zoo_mnist, ('f"(f) mnist', "MNIST_LOSS_VS_REPLAY",
                                     "or not bits")),
            (chip_smoke.zoo_cifar, ('f"(g) cifar', "not falls"))):
        src = inspect.getsource(fn)
        for gate in gates:
            assert gate in src, (fn.__name__, gate)
    src = inspect.getsource(chip_smoke.zoo_phase)
    assert 'raise SystemExit("zoo phase 14 failed: "' in src
    assert 'f"table kernels launched {table_launches}"' in src
    main = inspect.getsource(chip_smoke.main)
    assert main.count('"launches_phase14"') == 3
    assert main.count('"launches_phase14": zoo[') == 3  # read, not written
    assert main.index("zoo_phase(sc, work)") < main.index("sc.stop()")


# ---------------------------------------------------------------------------
# Phase 15: BERT-base SQuAD
# ---------------------------------------------------------------------------


def test_bert_flops_count_the_recipes_step():
    """6 × the 84.9 M dense weights (qkv, out, MLP, the span head) a token
    plus 12 · S · H a token and layer for the scores and PV: 6.784 TFLOP
    at 32 × 384; a forward is a third of it."""
    from tensorflowonspark_torch.models import bert

    config = bert.Config()
    step = chip_smoke.bert_flops(config, 32, 384, train=True)
    dense = 12 * (4 * 768 ** 2 + 2 * 768 * 3072) + 2 * 768
    assert dense == 84_936_192
    assert step == 6 * dense * 12_288 + 12 * 12 * 384 * 768 * 12_288
    assert round(step / 1e12, 3) == 6.784
    assert chip_smoke.bert_flops(config, 32, 384, train=False) * 3 == step


#: the BERT step's kernels as the profiler names them on an H100
BERT_KERNELS = {
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_"
    "64x64x128_4x1x1_kernel0_0": "attention",
    "void cudnn::fusion::compute_dot_do_o_specialized<true, 64>(void "
    "const*, void const*)": "attention",
    "fmha_cutlassB_bf16_aligned_64x64_k64_sm80": "attention",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float,"
    " float, float, at::native::(anonymous namespace)::SoftMaxForwardEpilogue>"
    : "attention",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTN": "gemm",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<"
    "float, float>(int, float, float const*, float const*, float const*, "
    "float*, float*, float*)": "layernorm+add+cast",
    "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel_"
    "32x32<float, float>": "layernorm+add+cast",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >":
        "layernorm+add+cast",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)>": "layernorm+add+cast",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "GeluCUDAKernelImpl(at::TensorIteratorBase&, at::native::"
    "GeluType)>": "gelu",
    "void at::native::indexSelectLargeIndex<float, long, unsigned int, 2, "
    "2, -2, true>": "embedding",
    "void at::native::(anonymous namespace)::compute_grad_weight<float, "
    "long>": "embedding",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
    "at::native::(anonymous namespace)::TensorListMetadata<4>>": "adamw",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float,"
    " float, float, at::native::(anonymous namespace)::"
    "LogSoftMaxForwardEpilogue>": "other",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<"
    "c10::BFloat16>>": "other",
}


def test_bert_families_name_each_kernel_and_the_sdpa_backend():
    for kernel, family in BERT_KERNELS.items():
        assert chip_smoke.bert_family(kernel) == family, kernel
    norm = [k for k, f in BERT_KERNELS.items() if f == "layernorm+add+cast"]
    assert [chip_smoke.norm_part(k) for k in norm] == [
        "layernorm", "layernorm", "add", "cast"]
    names = list(BERT_KERNELS)
    assert chip_smoke.sdpa_backend(names[:2]) == "cudnn"
    assert chip_smoke.sdpa_backend(names[2:3]) == "memory-efficient"
    assert chip_smoke.sdpa_backend(["flash_fwd_kernel<...>"]) == "flash"
    assert chip_smoke.sdpa_backend(names[3:4]) == "math"
    assert chip_smoke.sdpa_backend([]) == "none"


def _bert_grads(config, lengths, attention, dtype="bfloat16"):
    import dataclasses

    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import bert

    model = bert.make_model(dataclasses.replace(config, dtype=dtype), seed=0)
    rows = bert_squad.synth_squad(len(lengths), config.vocab_size, 64, 1)
    batch = {k: torch.from_numpy(v) for k, v in
             chip_smoke.bert_batch(rows).items()}
    for i, n in enumerate(lengths):  # padding tails, labels inside
        batch["attention_mask"][i, n:] = 0
        batch["input_ids"][i, n:] = 0
        batch["start_positions"][i] = batch["end_positions"][i] = n // 2
    return chip_smoke.bert_grads(model, batch, attention)[0]


def test_bert_grad_gates_pass_the_paths_and_catch_a_dropped_mask(
        one_thread):
    """Phase 15(a) on the CPU at BERT-base's widths cut to 2 layers and a
    512-token vocabulary, batch 4 × 64, the CPU's SDPA as the
    card's path: the gates hold, the planted fault (the mask dropped)
    reads above the gate, and a card path as far from f32 as the fault
    fails them.  The two leaves whose true gradient is 0 are ~0."""
    import dataclasses

    from tensorflowonspark_torch.models import bert

    config = dataclasses.replace(bert.Config(), vocab_size=512, layers=2,
                                 max_len=64)
    lengths = (64, 20, 12, 40)
    card = _bert_grads(config, lengths, bert.attention_sdpa)
    plain = _bert_grads(config, lengths, bert.attention_plain)
    f32 = _bert_grads(config, lengths, bert.attention_plain, "float32")
    fault = _bert_grads(config, lengths,
                        chip_smoke.dropped_mask(bert.attention_sdpa))
    skip = chip_smoke.bert_zero_grad_leaves(config)
    assert skip == ("span.bias", "layers.1.ln_mlp.bias")
    scale = max(float(g.abs().max()) for g in f32.values())
    assert all(float(f32[k].abs().max()) < 1e-5 * scale for k in skip)
    d, failures = chip_smoke.bert_grad_gates(card, plain, f32, fault, skip)
    assert failures == [], d
    assert d["fault_f32"] > d["gate"] > d["card_f32"]
    assert d["worst_leaf"] not in skip
    _, failures = chip_smoke.bert_grad_gates(fault, plain, f32, fault, skip)
    assert any("card vs f32 / plain" in f for f in failures)
    _, failures = chip_smoke.bert_grad_gates(card, plain, f32, card, skip)
    assert any("planted fault missed" in f for f in failures)
    missing = {k: v for k, v in card.items() if k != "span.weight"}
    _, failures = chip_smoke.bert_grad_gates(missing, plain, f32, fault,
                                             skip)
    assert "a gradient is missing or not finite" in failures


class _StubFeed:
    """A node's ``DataFeed`` in ``InputMode.SPARK``: each partition's rows
    as int64 columns, ``batch_size`` at a time, a partition's tail short,
    handed through ``device_put``."""

    def __init__(self, partitions, batch_size):
        self.batches = []
        for rows in partitions:
            for lo in range(0, len(rows), batch_size):
                cols = list(zip(*rows[lo:lo + batch_size]))
                self.batches.append({
                    c: np.asarray(cols[i], np.int64) for i, c in
                    enumerate(("input_ids", "token_type_ids",
                               "attention_mask", "start_positions",
                               "end_positions"))})

    def should_stop(self):
        return not self.batches

    def next_batch(self, batch_size, device_put=False):
        return device_put(self.batches.pop(0))


def test_bert_replay_equals_the_examples_map_fun(monkeypatch, one_thread):
    """Phase 15(e)'s replay steps what the example's ``map_fun`` trains on
    (each partition's full batches, the tails dropped): the same losses,
    bit for bit, on the CPU."""
    from tensorflowonspark_torch.examples import bert_squad
    from tensorflowonspark_torch.models import bert

    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    args = bert_squad.parse_args(["--tiny", "--batch_size", "4",
                                  "--seq_len", "32"])
    rows = [list(r) for r in bert_squad.synth_squad(
        22, bert.Config.tiny().vocab_size, 32)]
    partitions = [rows[:10], rows[10:]]  # tails of 2 and 0 rows... and 4
    published = {}
    ctx = types.SimpleNamespace(
        num_workers=1, executor_id=1, mgr=types.SimpleNamespace(
            set=published.__setitem__),
        get_data_feed=lambda **_: _StubFeed(partitions, args.batch_size))
    bert_squad.map_fun(args, ctx)
    replay = chip_smoke.bert_replay(args, partitions, "cpu")
    assert published["steps"] == len(replay) == 2 + 3
    assert published["losses"] == replay
    assert published["final_loss"] == replay[-1]
    assert published["device"] == "cpu"


def test_bert_slice_and_serving_on_cpu_executors(tmp_path, monkeypatch,
                                                 one_thread):
    """Phase 15(e)-(f) end to end at ``--tiny`` on the CPU: the example's
    job on one executor against the replay (every gate passes), then its
    export served with one all-padding row, both columns the eager
    forward's bits."""
    from tensorflowonspark_torch import pipeline, sparkapi

    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    sc = sparkapi.LocalSparkContext("local[1]")
    try:
        sliced = chip_smoke.bert_slice(sc, str(tmp_path), device="cpu",
                                       tiny=True)
        served = chip_smoke.bert_serving(sc, sliced["export"], device="cpu")
    finally:
        sc.stop()
        pipeline._MODEL_CACHE.clear()
    assert sliced["failures"] == [] and served["failures"] == []
    assert sliced["sequences_per_s"] > 0
    assert not any(sliced["launches"].values())


def test_phase_15_gates_and_the_kernels_line():
    import inspect

    for fn, gates in (
            (chip_smoke.bert_model_phase,
             ("bert_grad_gates(", 'f"(b) trajectory', "not falls",
              "dropped_mask(bert.attention)")),
            (chip_smoke.bert_slice, ("slice_failures(",
                                     "losses[:1] != replay[:1]")),
            (chip_smoke.bert_serving, ('f"(f) rows', "not all(bits)"))):
        src = inspect.getsource(fn)
        for gate in gates:
            assert gate in src, (fn.__name__, gate)
    src = inspect.getsource(chip_smoke.bert_phase)
    assert 'raise SystemExit("bert phase 15 failed: "' in src
    main = inspect.getsource(chip_smoke.main)
    assert main.count('"launches_phase15": bert_base["launches"]') == 3
    assert main.index("bert_phase(sc, work)") < main.index("sc.stop()")


# ---------------------------------------------------------------------------
# Phase 16: the compiled step
# ---------------------------------------------------------------------------

_PLANNED = {"one_pass": 1, "group": 0}


def _run(losses, launches=None, actions=None, state=None, traced=None,
         planned=_PLANNED, eager=False):
    """A run as ``run_trajectory`` returns it: by default a graph run on
    ``planned`` (the wrappers counting the eager step and the capture,
    nothing in a replay; the trace of a step finding the planned
    kernels), with ``eager`` an eager one."""
    n = len(losses)
    none = dict.fromkeys(planned, 0)
    counted = ([dict(planned)] * n if eager
               else [dict(planned)] * 2 + [none] * (n - 2))
    if actions is None:
        actions = (["eager"] * n if eager
                   else ["eager", "capture"] + ["replay"] * (n - 2))
    return {"losses": list(losses),
            "launches": launches or counted,
            "traced": (chip_smoke.traced_plan(planned) if traced is None
                       else traced),
            "actions": actions,
            "state": state or {"w": torch.ones(3)}}


def test_phase16_trajectory_gate_passes_equal_runs_and_names_each_fault():
    planned = _PLANNED
    none = {"one_pass": 0, "group": 0}
    good = _run([1.0, 0.9, 0.8, 0.7])
    eager = _run([1.0, 0.9, 0.8, 0.7], eager=True)
    assert chip_smoke.trajectory_gate("resnet50", good, eager, planned) == []
    faults = {
        "losses differ": _run([1.0, 0.9, 0.8, 0.70001]),
        "state tensors differ": _run([1.0, 0.9, 0.8, 0.7],
                                     state={"w": torch.ones(3) * 1.0001}),
        "actions": _run([1.0, 0.9, 0.8, 0.7], actions=["eager"] * 4),
        # a replay the wrappers counted: it re-entered Python
        "graph steps [3]": _run([1.0, 0.9, 0.8, 0.7], launches=[
            planned, planned, planned, none]),
        # the capture recorded no launch
        "graph steps [2]": _run([1.0, 0.9, 0.8, 0.7], launches=[
            planned, none, none, none]),
        # a replay whose trace lacks the planned kernel
        "the trace of graph step": _run([1.0, 0.9, 0.8, 0.7], traced={}),
    }
    for name, run in faults.items():
        got = chip_smoke.trajectory_gate("resnet50", run, eager, planned)
        assert len(got) == 1 and name in got[0], (name, got)
    bad_eager = _run([1.0, 0.9, 0.8, 0.7], eager=True, launches=[
        planned, planned, none, planned])
    got = chip_smoke.trajectory_gate("resnet50", good, bad_eager, planned)
    assert len(got) == 1 and "eager steps [3]" in got[0], got


def test_phase16_traces_count_the_kernels_by_name():
    """16(b) counts a replay's launches from the profiler's kernel names:
    each hand-written kernel maps to its counted path, both table update
    modes to the one segment walk; other kernels are not counted."""
    names = [
        "void (anonymous namespace)::gn_one_pass<true, true>(uint4 const*)",
        "void (anonymous namespace)::gn_one_pass<false, true>(uint4 const*)",
        "void (anonymous namespace)::gn_bwd_one_pass<true, false, true>("
        "BwdArgs)",
        "void (anonymous namespace)::tfos_id_grouping<int>(int const*)",
        "void tfos_adagrad_segment_walk<1, 2>(int const*)",
        "void (anonymous namespace)::gn_stats(uint4 const*)",
        "void at::native::vectorized_elementwise_kernel<4>(int)",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
        "void cudnn::align_kernel(float*)"]
    assert chip_smoke.traced_launches(names) == {
        "one_pass": 2, "backward_one_pass": 1, "group": 1,
        "table update": 1, "two_pass": 1}
    planned = chip_smoke.planned_launches(chip_smoke.zoo_site_tables())
    assert chip_smoke.traced_plan(planned["resnet50"]) == {
        "one_pass": 53, "backward_one_pass": 53}
    assert chip_smoke.traced_plan(planned["wide_deep dense"]) == \
        chip_smoke.traced_plan(planned["wide_deep sparse"]) == {
            "group": 1, "table update": 1}
    assert chip_smoke.traced_plan(planned["bert"]) == {}
    with pytest.raises(ValueError):
        chip_smoke.traced_plan({"two_pass": 1})


def test_phase16_bert_gate_is_phase_15s():
    planned = {"one_pass": 0}
    eager = _run([6.0, 5.0, 4.0], planned=planned, eager=True)
    near = _run([6.0, 5.0 * (1 + 2e-3), 4.0], planned=planned,
                state={"w": torch.ones(3) * 1.01})
    assert chip_smoke.trajectory_gate("bert remat=True", near, eager,
                                      planned) == []
    far = _run([6.0, 5.0 * (1 + 4e-3), 4.0], planned=planned)
    first = _run([6.000001, 5.0, 4.0], planned=planned)
    for run in (far, first):
        assert chip_smoke.trajectory_gate("bert remat=True", run, eager,
                                          planned)


def test_phase16_planted_stale_inputs_are_caught(monkeypatch):
    """16(c)'s planted fault, through stand-in graphs on the CPU: replays
    that keep the capture's batch give other losses than eager steps, and
    the trajectory gate says so."""
    from tensorflowonspark_torch.parallel import train as train_lib

    class Graphs:
        @staticmethod
        def applies(batch):
            return True

        @staticmethod
        def device_leaf(leaf):
            return torch.is_tensor(leaf)

        @staticmethod
        def capture(fn):
            out = fn()
            return {"fn": fn, "loss": out[1]}, out

        @staticmethod
        def replay(graph):
            state, loss = graph["fn"]()
            state.step -= 1
            graph["loss"].copy_(loss)

    def step(state, batch):
        state.step += 1
        return state, batch["x"].sum()

    batches = [{"x": torch.full((4,), float(i))} for i in range(5)]
    state = types.SimpleNamespace(step=0)
    eager = [float(step(state, b)[1]) for b in batches]
    runs = {}
    for name, cls in (("graph", train_lib.CompiledStep),
                      ("stale", chip_smoke.StaleInputsStep)):
        cs = cls(step)
        cs._graphs = Graphs()
        state = types.SimpleNamespace(step=0)
        runs[name] = [float(cs(state, b)[1]) for b in batches]
        assert state.step == len(batches)
    assert runs["graph"] == eager
    assert runs["stale"] == eager[:2] + [eager[1]] * 3
    planned = {"one_pass": 0}
    assert chip_smoke.trajectory_gate(
        "wide_deep dense", _run(runs["stale"], planned=planned),
        _run(eager, planned=planned, eager=True), planned)


def test_phase16_planned_launches_and_flat_counts():
    planned = chip_smoke.planned_launches(chip_smoke.zoo_site_tables())
    assert planned["resnet50"]["one_pass"] == 53
    assert planned["resnet50"]["backward_one_pass"] == 53
    inception = planned["inception_v3"]
    assert inception["one_pass"] == inception["backward_one_pass"] == 96
    assert planned["mobilenet_v1"]["one_pass"] == 27
    assert planned["cifar10_cnn"]["backward_one_pass"] == 6
    for name in ("bert", "mnist_mlp"):
        assert not any(planned[name].values())
    assert planned["wide_deep dense"] == {
        **dict.fromkeys(planned["bert"], 0), "group": 1, "combine": 1}
    assert planned["wide_deep sparse"]["sparse"] == 1
    from tensorflowonspark_torch.kernels import group_norm, sparse_adagrad

    assert chip_smoke.flat_counts() == {**group_norm.launches_by_path,
                                        **sparse_adagrad.launches_by_path}
    assert set(chip_smoke.flat_counts()) == set(planned["resnet50"])


def test_phase16_state_gap_counts_the_differing_tensors():
    want = {"a": torch.ones(2), "b": torch.zeros(2), "c": torch.ones(2)}
    got = {"a": torch.ones(2), "b": torch.tensor([0.0, 0.5]),
           "c": torch.ones(2, dtype=torch.float64)}
    differ, worst = chip_smoke.state_gap(got, want)
    assert differ == 2 and worst == pytest.approx(0.5)


def test_phase16_cache_gates_and_the_corrupted_entry(tmp_path):
    libs = ["group_norm-a.so", "group_norm_bwd-b.so", "sparse_adagrad-c.so"]
    first = {"libraries": libs, "disk_hits": 0, "disk_writes": 3,
             "disk_corrupt": 0}
    second = {"libraries": libs, "disk_hits": 3, "disk_writes": 0,
              "disk_corrupt": 0, "twins": {"group_norm": 0.0}}
    third = {"libraries": libs, "disk_hits": 2, "disk_writes": 1,
             "disk_corrupt": 1}
    assert chip_smoke.cache_gates(first, second, third) == []
    for bad in ({**second, "disk_hits": 2, "disk_writes": 1},
                {**second, "twins": {}}):
        assert chip_smoke.cache_gates(first, bad, third)
    assert chip_smoke.cache_gates(first, second, {**third, "disk_corrupt": 0,
                                                  "disk_hits": 3,
                                                  "disk_writes": 0})
    ns = tmp_path / "cc" / "torch-x-sm90"
    ns.mkdir(parents=True)
    for name in libs:
        (ns / name).write_bytes(bytes(256))
    path = chip_smoke.corrupt_entry(str(tmp_path / "cc"), "group_norm")
    assert os.path.basename(path) == "group_norm-a.so"
    assert (ns / "group_norm-a.so").read_bytes() != bytes(256)
    assert (ns / "group_norm_bwd-b.so").read_bytes() == bytes(256)


def test_phase_16_gates_budget_and_the_kernels_line():
    import inspect

    src = inspect.getsource(chip_smoke.compiled_step_phase)
    for gate in ("trajectory_gate(", '"(c) the planted stale-input fault',
                 '(d) restore after capture"', "cache_gates(",
                 "PHASE16_BUDGET_S",
                 'raise SystemExit("compiled-step phase failed: "'):
        assert gate in src, gate
    assert chip_smoke.PHASE16_BUDGET_S == 120
    main = inspect.getsource(chip_smoke.main)
    assert main.count('"launches_phase16": compiled["launches"]') == 3
    assert main.count('"replay_launches_phase16": compiled[') == 3
    assert main.index("compiled_step_phase(work)") < main.index("sc.stop()")
    assert "phase 16 {t_end - t16:.1f}" in main


# ---------------------------------------------------------------------------
# Phase 17: the generative decode tier
# ---------------------------------------------------------------------------


def _cpu_engine(**kw):
    from tensorflowonspark_torch import decode
    from tensorflowonspark_torch.models import tinylm

    geometry = dict(max_seqs=4, page_size=8, max_len=64, max_prompt_len=24,
                    device="cpu")
    geometry.update(kw)
    return decode.DecodeEngine(tinylm.Config.tiny(), **geometry)


def test_phase17_workload_extends_prefixes_within_the_geometry():
    """32 requests, prompts 4-64 and 16-64 new tokens within 128
    positions; a third extend one of the three registered 48-token
    prompts, most of them cut mid-page (a COW copy each); the same draw
    every run."""
    reqs = chip_smoke.decode_workload()
    assert len(reqs) == chip_smoke.DECODE_REQUESTS == 32
    assert all(4 <= len(p) <= 64 and 16 <= n <= 64 and len(p) + n <= 128
               and p.dtype == np.int32 for p, n in reqs)
    bases = [p for p, _ in reqs[:3]]
    assert all(len(b) == 48 for b in bases)
    family = [p for p, _ in reqs[3:]
              if any(np.array_equal(p[:16], b[:16]) for b in bases)]
    assert len(family) == 8
    cuts = sorted(max(int(np.argmax(np.append(p[:48] != b[:len(p[:48])],
                                              True)))
                      for b in bases) for p in family)
    assert sum(c % 16 != 0 for c in cuts) >= 4
    again = chip_smoke.decode_workload()
    assert all(np.array_equal(a, b) and m == n
               for (a, m), (b, n) in zip(reqs, again))


def test_phase17_case_rows_keep_shared_pages_read_only():
    """17(a)'s rows never write a page another row reads: the sharing row
    maps row 3's first two pages, which row 3 does not write."""
    for label, L in (("decode", 1), ("chunk16", 16), ("chunk32", 32)):
        rows = chip_smoke.paged_case_rows(label, L)
        assert len(rows) == 8
        start, n, entries = rows[4]
        assert entries[:2] == [("of", 3, 0), ("of", 3, 1)]
        s3, n3, _ = rows[3]
        last = min(s3 + (n3 or 1) - 1, 127)
        assert s3 // 16 >= 2 and last == 127  # ends at max_len - 1
        assert start // 16 >= 2  # writes its own pages only
        assert rows[2][2] == []  # inactive: an all-zero table


def test_phase17_serves_and_gates_on_the_cpu():
    """17(b)'s pieces on a CPU engine: streams at once equal streams one at
    a time and are the full forward's greedy choice (no tie needed); the
    pool contract after stop; the histogram quantiles of the run."""
    from tensorflowonspark_torch import obs

    eng = _cpu_engine()
    contract = (eng.kv_pool_bytes, (eng._kp.data_ptr(), eng._vp.data_ptr()))
    eng.warmup()
    eng.start()
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 64, size=(n,)).astype(np.int32), 6)
            for n in (3, 9, 17, 24, 5)]
    before = dict(obs.get_registry().peek("decode_itl_seconds").cumulative())
    conc, _ = chip_smoke.serve_all(eng, reqs, concurrent=True)
    q = chip_smoke.hist_quantiles("decode_itl_seconds", before)
    seq, _ = chip_smoke.serve_all(eng, reqs, concurrent=False)
    assert conc == seq and all(len(s) == 6 for s in conc)
    assert q["n"] == 5 * 5 and q["p50_ms"] <= q["p99_ms"]
    assert chip_smoke.greedy_gaps(eng._params, eng.config, reqs, conc) == (
        0, 0)
    wrong = [list(s) for s in conc]
    wrong[1][2] = (wrong[1][2] + 1) % 64
    assert chip_smoke.greedy_gaps(eng._params, eng.config, reqs,
                                  wrong)[0] >= 1
    eng.stop()
    assert chip_smoke.engine_contract(eng, *contract) == []
    assert chip_smoke.engine_contract(eng, contract[0] + 4, contract[1])


def test_phase17_idle_batches_take_free_pages_only():
    eng = _cpu_engine()
    eng.warmup()
    batches, pages = chip_smoke.idle_step_batches(eng, 3)
    assert set(batches) == {"decode", "chunk"}
    assert 0 not in pages and len(set(pages)) == len(pages)
    assert batches["chunk"]["tokens"].shape[1] == eng.prefill_chunks[-1]
    assert (batches["decode"]["seq_lens"] < eng.max_len).all()
    host, fresh = eng._run("decode", batches["decode"])
    assert not fresh and host.shape == (eng.max_seqs,)
    eng.pool.free(pages)
    eng.stop()


def test_phase17_traces_count_the_paged_kernels_by_name():
    names = ["void (anonymous namespace)::tfos_kv_append(float*, float*)",
             "void (anonymous namespace)::tfos_kv_append((anonymous "
             "namespace)::AppendArgs)",
             "void (anonymous namespace)::tfos_paged_attention(float const*)",
             "void (anonymous namespace)::tfos_paged_attention(float const*)",
             "void at::native::index_elementwise_kernel<128, 4>(int)"]
    assert chip_smoke.traced_launches(names) == {"kv_append": 2,
                                                 "paged_attention": 2}
    assert set(chip_smoke.PAGED_KERNELS.values()) == {"kv_append",
                                                      "paged_attention"}


def test_phase17_gates_budget_and_the_kernels_line():
    import inspect

    src = inspect.getsource(chip_smoke.decode_phase)
    for gate in ('"(b) streams differ', "tokens are not the full",
                 '"(b) no COW copy or no prefix hit"', '"(b) captures',
                 '"(b) wrapper launches', "planted {k} not caught",
                 '"(c) {kind} step launches', "engine_contract(",
                 '"(d) the HTTP stream differs', "PHASE17_BUDGET_S",
                 'raise SystemExit("decode phase 17 failed: "',
                 '"append at p + 1": append_caught', "PLANTED_APPEND"):
        assert gate in src, gate
    src = inspect.getsource(chip_smoke.paged_kernel_phase)
    assert "kv_append differs from its twin" in src
    assert "no kv_append launch in the" in src
    assert "ATTN_TOL" in src
    assert chip_smoke.PLANTED_APPEND == ("TFOS_PLANTED_APPEND_OFF_BY_ONE",)
    assert chip_smoke.PHASE17_BUDGET_S == 60
    main = inspect.getsource(chip_smoke.main)
    assert main.index("decode_phase()") > main.index("sc.stop()")
    assert "kernels += phase17_entries(decoded)" in main
    assert "choices=(16, 17, 18)" in main
    result = {
        "kernels": {label: {k: {"max_abs_err": 0.0, "ms": 1.0,
                                "plain_ms": 2.0, "bound_ms": 0.5,
                                "bound_by": "bytes", "library_ms": 3.0,
                                "device_ms": 0.25}
                            for k in ("kv_append", "paged_attention")}
                    for label in ("decode", "chunk16", "synthetic")},
        "launches": {"kv_append": 12, "paged_attention": 12},
        "replay_traced": {"kv_append": 4, "paged_attention": 4}}
    for res in result["kernels"].values():
        res["kv_append"]["cupti_ms"] = 0.002
    entries = chip_smoke.phase17_entries(result)
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "launches_phase17", "replay_launches_phase17"}
    for e in entries:
        assert keys <= set(e) and e["route"] == "cuda"
        assert e["source"] == (
            "tensorflowonspark_torch/csrc/paged_attention.cu")
        assert os.path.exists(os.path.join(
            os.path.dirname(chip_smoke.__file__), e["source"]))
        assert "ms_synthetic" in e and "ms_chunk16" in e
        assert e["device_ms"] == 0.25
        append = e["name"] == "tfos_kv_append"
        assert ("cupti_ms" in e) == ("cupti_ms_synthetic" in e) == append
    assert [e["launches"] for e in entries] == [12, 12]


def test_phase17_families_name_the_paged_kernels_apart():
    fam = chip_smoke.decode_family
    assert fam("void (anonymous namespace)::tfos_paged_attention(float "
               "const*)") == "paged_attention"
    assert fam("void (anonymous namespace)::tfos_kv_append(float*)") == \
        "kv_append"
    assert fam("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8") == \
        "GEMMs"
    assert fam("Memcpy HtoD (Pinned -> Device)") == "copies"
    assert fam("void at::native::reduce_kernel<512, 1>(int)") == "other"


@pytest.mark.parametrize("L", [2, 3, 5])
def test_phase17_verify_rows_take_every_step_length(L):
    """17(a)'s verify rows: 8 rows of k + 1 = L queries with step lengths
    from 0 (inactive, an all-zero table) to L, one ending at max_len - 1,
    the sharing row writing its own pages only."""
    rows = chip_smoke.paged_case_rows(f"verify{L}", L)
    assert len(rows) == 8
    lens = [n for _, n, _ in rows]
    assert min(lens) == 0 and max(lens) == L and 1 in lens
    assert all(0 <= n <= L for n in lens)
    s3, n3, _ = rows[3]
    assert s3 + n3 - 1 == 127
    start, _, entries = rows[4]
    assert entries[:2] == [("of", 3, 0), ("of", 3, 1)]
    assert start // 16 >= 2 and s3 // 16 >= 2
    assert rows[2][2] == []


def test_phase17e_engines_gate_on_the_cpu(monkeypatch):
    """17(e)'s engine run on CPU engines: the n-gram and the perfect model
    drafter serve the greedy engine's streams (no difference, every token
    the full forward's argmax), the perfect drafter's acceptance is 1.0,
    and the only gates that fail are the card's (no graphs captured, no
    kernel launched on the CPU)."""
    from tensorflowonspark_torch import decode
    from tensorflowonspark_torch.models import tinylm

    cfg = tinylm.Config.tiny()
    params = tinylm.init_params(cfg, seed=3)
    monkeypatch.setattr(chip_smoke, "DECODE_ENGINE", dict(
        max_seqs=4, page_size=8, max_len=64, max_prompt_len=24,
        device="cpu"))
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 64, size=(n,)).astype(np.int32), 10)
            for n in (3, 9, 17, 24, 5, 12)]
    base = _cpu_engine(**{"params": params})
    base.start()
    greedy, _ = chip_smoke.serve_all(base, reqs, concurrent=True)
    base.stop()
    for label, spec in (("ngram", {"spec_drafter": "ngram"}),
                        ("perfect", {"spec_drafter": "model",
                                     "draft_config": cfg,
                                     "draft_params": params})):
        out, fails, eng = chip_smoke.spec_engine_run(
            label, cfg, params, reqs, greedy, (8, 16), **spec)
        eng.stop()
        assert out["streams"] == greedy and out["diffs"] == []
        assert out["proposed"] > 0
        assert all("captures" in f or "wrapper launches" in f
                   for f in fails), fails
        assert chip_smoke.engine_contract(eng, *out["contract"]) == []
    assert out["acceptance"] == 1.0 and out["draft_steps"] > 0
    assert out["planned"] == (2 + 3) * cfg.n_layers * 2 + (2 + 1) * 2 * 2


def test_phase17e_first_differences_name_the_position_and_gap():
    from tensorflowonspark_torch.models import tinylm

    cfg = tinylm.Config.tiny()
    params = tinylm.init_params(cfg, seed=3)
    reqs = [(np.arange(1, 6, dtype=np.int32), 4),
            (np.arange(7, 10, dtype=np.int32), 4)]
    want = [[1, 2, 3, 4], [5, 6, 7, 8]]
    got = [[1, 2, 9, 4], [5, 6, 7]]
    diffs = chip_smoke.first_differences(params, cfg, reqs, want, got)
    assert [d[:2] for d in diffs] == [(0, 2), (1, 3)]
    assert 0 < diffs[0][2] < float("inf") and diffs[1][2] == float("inf")
    assert chip_smoke.first_differences(params, cfg, reqs, want, want) == []


def test_phase17e_gates_budget_and_the_kernels_line():
    import inspect

    src = inspect.getsource(chip_smoke.spec_engine_run)
    for gate in ("beyond a near-tie", "tokens are not the",
                 "captures {warm} -> {after}", "wrapper launches {launches}",
                 "pa.reset_launches()", "drafter.config.n_layers"):
        assert gate in src, gate
    src = inspect.getsource(chip_smoke.speculation_phase)
    for gate in ("the perfect drafter's acceptance",
                 "never moved the controller",
                 "seeded sampling the same on two engines",
                 "top_k=1 the greedy streams",
                 "causal j < p on the verify path", "every draft accepted",
                 "verify step launches", "SPEC_BUDGET_S",
                 "PLANTED_OFF_BY_ONE", "engine_contract("):
        assert gate in src, gate
    assert chip_smoke.SPEC_BUDGET_S == 30 and chip_smoke.SPEC_TOKENS == 4
    assert "speculation_phase(" in inspect.getsource(chip_smoke.decode_phase)
    result = {"kernels": {"decode": {k: {"ms": 1.0} for k in (
                  "kv_append", "paged_attention")}},
              "launches": {"kv_append": 12, "paged_attention": 12},
              "spec_launches": {"kv_append": 76, "paged_attention": 76},
              "replay_traced": {"kv_append": 4, "paged_attention": 4}}
    for e in chip_smoke.phase17_entries(result):
        assert e["launches_phase17e"] == 76 and e["launches"] == 12


# ---------------------------------------------------------------------------
# Phase 18 (BatchNorm training): the gates that need no card
# ---------------------------------------------------------------------------


def _bn_case(variant):
    import dataclasses

    from tensorflowonspark_torch.models import inception, resnet

    if variant == "resnet50":
        return "resnet50", resnet, resnet.Config.tiny("batch")
    return "inception_v3", inception, dataclasses.replace(
        inception.Config.tiny_canonical(), norm="batch")


@pytest.mark.parametrize("variant", ["resnet50", "inception_v3"])
def test_phase18_running_statistics_gate_catches_an_unbiased_variance(
        one_thread, variant):
    """18(a)'s statistics gate on the CPU: after one ``Trainer.step`` every
    norm's running mean and var sit within ``BN_STATS_TOL`` of flax's rule
    recomputed in f64 from the norms' inputs; with torch's ``batch_norm``
    planted (an unbiased running variance) the same gate reads above it,
    at a var buffer."""
    name, lib, config = _bn_case(variant)
    batch = lib.example_batch(config, 8, seed=3)
    worst, where, complete, sites = chip_smoke.bn_stats_case(
        name, config, batch, device="cpu")
    assert complete and sites > 0
    assert worst <= chip_smoke.BN_STATS_TOL, (worst, where)
    fault, at, _, _ = chip_smoke.bn_stats_case(name, config, batch,
                                               device="cpu", planted=True)
    assert fault > chip_smoke.BN_STATS_TOL and at.endswith(".var")


def test_phase18_gradient_gate_catches_detached_statistics(one_thread):
    """18(a)'s gradient gate on the CPU at the tiny config: the same f32
    step twice is the same gradients, and with the batch's statistics cut
    from autograd (``chip_smoke.detached_statistics``) the gradients read
    above ``BN_GRADS_F32_VS_HOST`` from the true ones."""
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import _common

    name, lib, config = _bn_case("resnet50")
    model = lib.make_model(config, seed=0)
    batch = {k: torch.from_numpy(v)
             for k, v in lib.example_batch(config, 8, seed=3).items()}
    loss_fn = lib.make_loss_fn(model, config)
    act = group_norm.group_norm_act_plain
    true = chip_smoke._grads(model, loss_fn, batch, act)[0]
    assert chip_smoke._rel_l2(chip_smoke._grads(model, loss_fn, batch,
                                                act)[0], true) == 0
    plain = _common.batch_norm
    with chip_smoke.swapped(_common, "batch_norm",
                            chip_smoke.detached_statistics):
        fault = chip_smoke._grads(model, loss_fn, batch, act)[0]
    assert _common.batch_norm is plain
    assert chip_smoke._rel_l2(fault, true) > chip_smoke.BN_GRADS_F32_VS_HOST


def test_phase18_bf16_gates_hold_and_catch_planted_faults(one_thread):
    """18(a)'s bf16 gates on the CPU at the tiny config: every BatchNorm
    site of the bf16 step, output and input gradient, sits within
    ``BN_BF16_SITE`` of f64 on its own inputs, and the loss within
    ``BN_BF16_LOSS_REL`` of the f32 twin's; the recorded dx halved or
    permuted, the statistics cut from autograd and a forward that lost
    ``train`` each read above the gate they must break, and a fault that
    reads below is reported."""
    import dataclasses

    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import _common

    name, lib, config = _bn_case("resnet50")
    state = lib.state_of(lib.make_model(config, seed=0))
    bf16 = lib.load_state(lib.make_model(dataclasses.replace(
        config, dtype="bfloat16")), state)
    f32 = lib.load_state(lib.make_model(config), state)
    batch = {k: torch.from_numpy(v)
             for k, v in lib.example_batch(config, 8, seed=3).items()}
    loss_fn = lib.make_loss_fn(f32, config)
    loss32 = chip_smoke._grads(f32, loss_fn, batch,
                               group_norm.group_norm_act_plain)[1]
    plain = _common.batch_norm
    good = chip_smoke.bn_site_gaps(bf16, loss_fn, batch)
    faults = {"detached statistics": chip_smoke.bn_site_gaps(
                  bf16, loss_fn, batch, chip_smoke.detached_statistics),
              "lost train": chip_smoke.bn_site_gaps(
                  bf16, loss_fn, batch, chip_smoke.lost_train)}
    assert _common.batch_norm is plain
    n_sites = sum(1 for k, _ in bf16.named_buffers() if k.endswith(".mean"))
    assert good["sites"] == n_sites == 9
    assert 0 < good["y"] <= chip_smoke.BN_BF16_SITE
    assert 0 < good["dx"] <= chip_smoke.BN_BF16_SITE
    assert chip_smoke.bf16_gate(loss32, good, faults) == []
    assert good["dx halved"] == pytest.approx(0.5, abs=0.01)
    assert good["dx uncorrelated"] > 1.0
    assert faults["detached statistics"]["dx"] > 0.1
    # the same f32 step through the gate reads rounding alone
    f32_sites = chip_smoke.bn_site_gaps(f32, loss_fn, batch)
    assert f32_sites["y"] < 1e-5 and f32_sites["dx"] < 1e-4
    missed = dict(faults, **{"detached statistics": good})
    assert chip_smoke.bf16_gate(loss32, good, missed) == [
        "planted detached statistics dx MISSED"]


def test_phase18_eval_bits_hold_and_catch_a_train_mode_forward(one_thread):
    """18(c) on the CPU: after steps, a row's logits are the same bits
    alone, in its batch and in another; a train-mode forward at eval
    (batch statistics) breaks that, and leaves the running statistics as
    they were."""
    from tensorflowonspark_torch.trainer import Trainer

    name, lib, config = _bn_case("resnet50")
    t = Trainer(name, config=config, device="cpu")
    for i in range(2):
        t.step(lib.example_batch(config, 8, seed=i))
    images = torch.from_numpy(lib.example_batch(config, 8, seed=5)["image"])
    got = chip_smoke.eval_bits(lambda x: t.predict({"image": x}), images, 3)
    assert got["same_bits"] and got["max_gap"] == 0
    stats = {k: v.clone() for k, v in t.model.named_buffers()}
    planted = chip_smoke.eval_bits(chip_smoke.train_mode_predict(t),
                                   images, 3)
    assert not planted["same_bits"] and planted["max_gap"] > 1e-3
    assert all(torch.equal(v, stats[k]) for k, v in t.model.named_buffers())


def test_phase18_families_attribute_the_batch_norm_ops(one_thread):
    """18(b)'s families on the CPU's op events (self times standing for
    kernels): the BatchNorm ranges' forward ops go to their families, every
    backward node of an op inside ``tfos::batch_norm`` to "BatchNorm apply
    and backward" (matched by autograd sequence number), convs, casts,
    pads and pools and AdamW by name, and nothing else into those."""
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_torch.trainer import Trainer

    name, lib, config = _bn_case("resnet50")
    t = Trainer(name, config=config, device="cpu")
    batch = lib.example_batch(config, 4)
    t.step(batch)
    with chip_smoke.bn_annotated(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        t.step(batch)
    events = list(prof.events())
    fams = chip_smoke.step_families(
        events, [(e, e.name, e.self_cpu_time_total / 1e3) for e in events])
    for fam in ("convs", "BatchNorm statistics",
                "BatchNorm apply and backward", "casts/pads/pool", "AdamW"):
        assert fams[fam] > 0, fam
    assert fams["GroupNorm kernels"] == 0
    seq = chip_smoke._bn_sequence_numbers(events)
    backward = [e for e in events if e.name.startswith(
        "autograd::engine::evaluate_function: ")]
    bn_nodes = {e.name.rsplit(" ", 1)[1] for e in backward
                if chip_smoke.event_family(e, e.name, seq)
                == "BatchNorm apply and backward"}
    assert {"NativeBatchNormBackward0", "ReluBackward0"} <= bn_nodes
    assert not {"ConvolutionBackward0", "NllLossBackward0",
                "AddmmBackward0"} & bn_nodes
    # the stock GroupNorm step has no BatchNorm family at all
    g = Trainer(name, config=lib.Config.tiny(), device="cpu")
    g.step(batch)
    with chip_smoke.bn_annotated(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        g.step(batch)
    events = list(prof.events())
    fams = chip_smoke.step_families(
        events, [(e, e.name, e.self_cpu_time_total / 1e3) for e in events])
    assert fams["BatchNorm statistics"] == 0
    assert fams["BatchNorm apply and backward"] == 0


def test_phase18_kernels_of_an_op_leave_out_annotation_spans():
    """A ``record_function`` range's device span comes attached to the
    range like a kernel; the families count only the kernels."""
    kernel = types.SimpleNamespace
    rng = types.SimpleNamespace(name="tfos::batch_norm", kernels=[
        kernel(name="tfos::batch_norm", duration=900.0)])
    op = types.SimpleNamespace(name="aten::mul", kernels=[
        kernel(name="vectorized_elementwise_kernel", duration=300.0)])
    step = types.SimpleNamespace(name="Optimizer.step#AdamW.step", kernels=[
        kernel(name="Optimizer.step#AdamW.step", duration=50.0),
        kernel(name="multi_tensor_apply_kernel", duration=20.0)])
    assert chip_smoke.launched_kernels(rng, 3) == []
    assert chip_smoke.launched_kernels(op, 3) == [
        ("vectorized_elementwise_kernel", 300.0 / 1e3 / 3)]
    assert chip_smoke.launched_kernels(step) == [
        ("multi_tensor_apply_kernel", 0.02)]


def test_phase18_a_kernel_counts_once_when_host_ids_collide():
    """The profiler attaches a kernel to every host event of its
    correlation id, and its bookkeeping events can share an op's id:
    ``kernels_by_op`` counts such a kernel once, on the op."""
    kernel = types.SimpleNamespace(name="elementwise_kernel", duration=10.0)
    parent = types.SimpleNamespace(name="tfos::batch_norm", cpu_parent=None,
                                   id=3, kernels=[], is_user_annotation=True)
    op = types.SimpleNamespace(name="aten::mul", cpu_parent=parent, id=7,
                               kernels=[kernel], is_user_annotation=False)
    book = types.SimpleNamespace(name="Activity Buffer Request",
                                 cpu_parent=None, id=7, kernels=[kernel],
                                 is_user_annotation=False)
    other = types.SimpleNamespace(name="aten::add", cpu_parent=None, id=8,
                                  kernels=[kernel], is_user_annotation=False)
    got = list(chip_smoke.kernels_by_op([book, parent, op, other], 2))
    assert got == [(op, "elementwise_kernel", 0.005),
                   (other, "elementwise_kernel", 0.005)]


def test_phase18_is_on_the_command_line_and_in_the_kernels_line():
    """``--phase 18`` parses; the kernels line gains ``launches_phase18``
    for every GroupNorm and table entry (phase 18 launches none)."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert "choices=(16, 17, 18)" in src
    assert src.count('"launches_phase18"') == 3
    assert chip_smoke.PHASE18_BUDGET_S == 60
