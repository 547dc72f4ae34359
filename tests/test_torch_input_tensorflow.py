"""``InputMode.TENSORFLOW`` on the port, on the CPU.

Each node of a ``TFCluster.run(InputMode.TENSORFLOW)`` cluster reads its
own shard of the part files and trains; there is no Spark feed.  Real
processes: two executors on the local substrate form a gloo group
(``TFOS_TORCH_DISTRIBUTED=1``), so the gradients are averaged across them.

- the port's ``resnet_spark`` example (tiny ResNet, TFRecords, one reader,
  a seeded shuffle) against one process stepping both ranks' batches;
- the port's ``criteo_pipeline --input parquet`` (tiny wide&deep, Parquet)
  end to end: every row scored;
- three steps of the tiny ResNet fed by ``tfrecord_batches`` from one
  shard, the port's ``Trainer`` against the JAX package's on carried-over
  weights.
"""

import os
import sys

import cloudpickle
import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import TFCluster, TFManager, readers
from tensorflowonspark_torch.examples import criteo_pipeline, resnet_spark
from tensorflowonspark_torch.models import resnet as port
from tensorflowonspark_torch.sparkapi import LocalSparkContext
from tensorflowonspark_torch.trainer import Trainer as PortTrainer
from tensorflowonspark_tpu import readers as ref_readers
from tensorflowonspark_tpu.models import resnet as ref
from tensorflowonspark_tpu.trainer import Trainer as JaxTrainer
from test_torch_train import F32_LOSS_REL, F32_PARAMS_ABS

# ship this test module by value so spawned executors don't need to import
# it by name
cloudpickle.register_pickle_by_value(sys.modules[__name__])

#: two ranks' f32 batches averaged by gloo against one process's whole
#: batch: the same sums in another order (as ``test_torch_cluster.py``)
REPLAY_REL = 1e-4


@pytest.fixture()
def cluster_env(monkeypatch):
    """Two executors on the CPU forming a gloo group (they inherit the
    environment at start)."""
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TFOS_TORCH_DISTRIBUTED", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _published(cluster, keys):
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    out = {}
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        out[meta["executor_id"]] = {k: mgr.get(k) for k in keys}
    return out


def test_resnet_spark_tensorflow_mode_equals_an_in_process_replay(
        tmp_path, cluster_env):
    data_dir = str(tmp_path / "tfr")
    port.write_synthetic_tfrecords(data_dir, 32, 4, 16, seed=0,
                                   num_classes=10)
    args = resnet_spark.parse_args([
        "--tiny", "--batch_size", "4", "--readers", "1",
        "--shuffle_buffer", "8", "--lr", "1e-2", "--data_dir", data_dir])
    sc = LocalSparkContext("local-cluster[2,1,1024]", "torch-tf-mode")
    try:
        cluster = TFCluster.run(sc, resnet_spark.map_fun, args,
                                num_executors=2,
                                input_mode=TFCluster.InputMode.TENSORFLOW,
                                master_node="chief")
        cluster.shutdown(grace_secs=60)
        nodes = _published(cluster, ("state", "losses", "device"))
        agg = cluster.metrics()
    finally:
        sc.stop()
    assert [n["state"] for n in nodes.values()] == ["finished"] * 2
    assert {n["device"] for n in nodes.values()} == {"cpu"}
    losses0, losses1 = nodes[0]["losses"], nodes[1]["losses"]
    assert len(losses0) == 4 and losses0 == losses1  # gloo averaged them
    assert all(np.isfinite(losses0))
    assert agg["total_examples_per_sec"] > 0

    # one process stepping rank 0's batch i and rank 1's together: each
    # rank's shard (strided by executor id) read with the same arguments
    # (under master_node="chief" both nodes have task_index 0)
    shards = [readers.shard_files(os.path.join(data_dir, "part-*"), r, 2)
              for r in (0, 1)]
    t = PortTrainer("resnet50", config=port.Config.tiny(), learning_rate=1e-2,
                    device="cpu")
    replay = []
    for b0, b1 in zip(*(resnet_spark.train_batches(args, s, 0, False)
                        for s in shards)):
        replay.append(float(t.step({k: np.concatenate([b0[k], b1[k]])
                                    for k in b0})))
    np.testing.assert_allclose(losses0, replay, rtol=REPLAY_REL)


def test_resnet_spark_restart_continues_the_uninterrupted_run(
        tmp_path, cluster_env, monkeypatch):
    """The example's recovery on 2 executors: a job checkpointing every 2
    steps (``TFOS_CKPT_EVERY_STEPS``) stops at step 3; a second job
    restores step 2, its readers drop the 2 trained batches unparsed,
    and its 4 steps (across the epoch's end) are steps 3-6 of one
    uninterrupted run."""
    monkeypatch.setenv("TFOS_CKPT_EVERY_STEPS", "2")
    data_dir = str(tmp_path / "tfr")
    port.write_synthetic_tfrecords(data_dir, 32, 4, 16, seed=0,
                                   num_classes=10)
    argv = ["--tiny", "--batch_size", "4", "--readers", "1",
            "--shuffle_buffer", "8", "--lr", "1e-2", "--epochs", "2",
            "--data_dir", data_dir, "--ckpt_dir", str(tmp_path / "ckpt")]
    jobs = []
    sc = LocalSparkContext("local-cluster[2,1,1024]", "torch-tf-restart")
    try:
        for max_steps in (3, 6):
            args = resnet_spark.parse_args(argv + ["--max_steps",
                                                   str(max_steps)])
            cluster = TFCluster.run(sc, resnet_spark.map_fun, args,
                                    num_executors=2,
                                    input_mode=TFCluster.InputMode.TENSORFLOW,
                                    master_node="chief")
            cluster.shutdown(grace_secs=60)
            jobs.append(_published(cluster, ("state", "losses",
                                             "restored_step")))
    finally:
        sc.stop()
    first, second = jobs
    assert [n["restored_step"] for n in first.values()] == [0, 0]
    assert [n["restored_step"] for n in second.values()] == [2, 2]
    assert [len(n["losses"]) for n in first.values()] == [3, 3]
    assert [len(n["losses"]) for n in second.values()] == [4, 4]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "4", "6"]

    shards = [readers.shard_files(os.path.join(data_dir, "part-*"), r, 2)
              for r in (0, 1)]
    t = PortTrainer("resnet50", config=port.Config.tiny(), learning_rate=1e-2,
                    device="cpu")
    replay = []
    for _, b0, b1 in zip(range(6), *(resnet_spark.train_batches(
            resnet_spark.parse_args(argv), s, 0, False) for s in shards)):
        replay.append(float(t.step({k: np.concatenate([b0[k], b1[k]])
                                    for k in b0})))
    np.testing.assert_allclose(first[0]["losses"], replay[:3],
                               rtol=REPLAY_REL)
    np.testing.assert_allclose(second[0]["losses"], replay[2:],
                               rtol=REPLAY_REL)


def test_criteo_pipeline_parquet_scores_every_row(tmp_path, cluster_env):
    rows = criteo_pipeline.main([
        "--cluster_size", "2", "--epochs", "2", "--num_samples", "512",
        "--batch_size", "64", "--input", "parquet",
        "--parquet_dir", str(tmp_path / "parquet"),
        "--export_dir", str(tmp_path / "export")])
    assert len(rows) == 512
    ctr = np.asarray([r.ctr for r in rows])
    assert np.all(np.isfinite(ctr)) and np.all((ctr > 0) & (ctr < 1))
    assert os.path.exists(tmp_path / "export")


@pytest.mark.parametrize("mode", ["tfrecords", "synthetic"])
def test_resnet_spark_main_trains_on_two_executors(tmp_path, cluster_env,
                                                  capsys, mode):
    """The example end to end: records synthesised on the first run (the
    tiny config's image size and classes) and read by two reader threads a
    node, or ``--synthetic``'s device-resident batch."""
    argv = ["--cluster_size", "2", "--tiny", "--batch_size", "4"]
    if mode == "synthetic":
        argv += ["--synthetic", "--steps", "3", "--warmup", "1"]
    else:
        argv += ["--num_samples", "32", "--readers", "2",
                 "--shuffle_buffer", "8", "--data_dir", str(tmp_path)]
    resnet_spark.main(argv)
    out = capsys.readouterr().out
    assert "cluster total:" in out and "no steps ran" not in out
    nodes = [line for line in out.splitlines() if line.startswith("node ")]
    assert len(nodes) == 2
    steps = 3 if mode == "synthetic" else 4
    assert all(f"@ step {steps})" in line for line in nodes), nodes
    if mode == "tfrecords":
        assert len(list((tmp_path / "side16").glob("part-*"))) == 4


def test_criteo_pipeline_estimator_scores_every_row(tmp_path, cluster_env):
    """``--input spark``: ``TFEstimator(train_fun).fit`` on two executors,
    then the export scored."""
    rows = criteo_pipeline.main([
        "--cluster_size", "2", "--epochs", "1", "--num_samples", "512",
        "--batch_size", "64", "--export_dir", str(tmp_path / "export")])
    assert len(rows) == 512
    ctr = np.asarray([r.ctr for r in rows])
    assert np.all(np.isfinite(ctr)) and np.all((ctr > 0) & (ctr < 1))


def test_three_tfrecord_fed_steps_match_the_jax_trainer(tmp_path,
                                                        monkeypatch):
    """The same shard through each package's ``tfrecord_batches`` (one
    reader, a seeded shuffle, staged by each trainer's ``shard``) into each
    package's ``Trainer``, from the same weights."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = ref.Config.tiny()
        [shard] = port.write_synthetic_tfrecords(
            str(tmp_path), 24, 1, config.image_size, seed=2,
            num_classes=config.num_classes)
        jax_t = JaxTrainer("resnet50", config=config, learning_rate=1e-3,
                           seed=0)
        port_t = PortTrainer("resnet50", config=port.Config.tiny(),
                             learning_rate=1e-3, device="cpu")
        port.load_state(port_t.model, port.params_from_flax(
            jax.device_get(jax_t.state.params)))
        kwargs = dict(num_epochs=1, readers=1, shuffle_buffer=8,
                      shuffle_files=True, seed=1, drop_remainder=True,
                      prefetch=2)
        port_batches = readers.tfrecord_batches(
            [shard], 8, parse_fn=port.tfrecord_parse_fn(config.image_size),
            device_put=port_t.shard, **kwargs)
        jax_batches = ref_readers.tfrecord_batches(
            [shard], 8, parse_fn=ref.tfrecord_parse_fn(config.image_size),
            device_put=jax_t.shard, **kwargs)
        losses = [(float(jax_t.step(jb)), float(port_t.step(pb)))
                  for jb, pb in zip(jax_batches, port_batches)]
    finally:
        torch.set_num_threads(threads)
    losses = np.array(losses)
    assert losses.shape == (3, 2)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=F32_LOSS_REL)
    want = port.params_from_flax(jax.device_get(jax_t.state.params))["params"]
    got = port.state_of(port_t.model)["params"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=F32_PARAMS_ABS, err_msg=k)
