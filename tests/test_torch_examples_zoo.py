"""The port's examples of the rest of the model zoo, on CPU executors.

- ``resnet_spark --arch inception_v3`` and ``--arch mobilenet_v1``
  (``InputMode.TENSORFLOW``, tiny configs, one reader a node) on two
  executors that average their gradients over gloo, against one process
  stepping both ranks' batches; the chief's export scored by
  ``TFModel.transform``;
- ``mnist_spark`` (``InputMode.SPARK``): its ``map_fun`` against the JAX
  example's on the same rows (a padded tail batch) from the same weights,
  both in process behind one stub feed; then ``main`` on two executors and
  its self-describing export scored row for row;
- ``cifar10_spark --readers 1`` against an in-process replay, its export
  scored.
"""

import importlib.util
import os
import sys
import types

import cloudpickle
import jax
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import (TFCluster, TFManager, ckpt, pipeline,
                                     readers, saved_model)
from tensorflowonspark_torch import models as model_zoo
from tensorflowonspark_torch.examples import (cifar10_spark, mnist_spark,
                                              resnet_spark)
from tensorflowonspark_torch.models import resnet
from tensorflowonspark_torch.sparkapi import (LocalSparkContext,
                                              LocalSparkSession)
from tensorflowonspark_torch.trainer import Trainer

cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: two ranks' f32 batches averaged by gloo against one process's whole
#: batch: the same sums in another order
REPLAY_REL = 1e-4
#: scores of the serialized forward against the zoo forward in process
SCORES_ABS = 1e-4
#: the MNIST example's final loss against the JAX example's: bf16
#: matmuls rounded the same way, f32 elsewhere
MNIST_LOSS_REL = 1e-3


@pytest.fixture()
def cluster_env(monkeypatch):
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TFOS_TORCH_DISTRIBUTED", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pipeline._MODEL_CACHE.clear()


def _published(cluster, keys):
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    out = {}
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        out[meta["executor_id"]] = {k: mgr.get(k) for k in keys}
    return out


def _run_tf_job(map_fun, args, name):
    sc = LocalSparkContext("local-cluster[2,1,1024]", name)
    try:
        cluster = TFCluster.run(sc, map_fun, args, num_executors=2,
                                input_mode=TFCluster.InputMode.TENSORFLOW,
                                master_node="chief")
        cluster.shutdown(grace_secs=60)
        return _published(cluster, ("state", "losses", "device"))
    finally:
        sc.stop()


def _replay(args, batches_of, arch, config):
    """One process stepping rank 0's batch i and rank 1's together: each
    rank's shard (strided by executor id) read with the same arguments
    (under master_node="chief" both nodes have task_index 0)."""
    shards = [readers.shard_files(os.path.join(args.data_dir, "part-*"), r, 2)
              for r in (0, 1)]
    t = Trainer(arch, config=config, learning_rate=args.lr, device="cpu")
    return [float(t.step({k: np.concatenate([b0[k], b1[k]]) for k in b0}))
            for b0, b1 in zip(*(batches_of(args, s, 0, False)
                                for s in shards))]


def _score(export_dir, images, in_col="image"):
    """``TFModel.transform`` of ``images`` (one row each, 3 partitions) on
    two executors from the export alone; the scores in row order (the
    local substrate collects partitions in order, rows in order)."""
    sc = LocalSparkContext("local-cluster[2,1,1024]", "zoo-serving")
    try:
        df = LocalSparkSession(sc).createDataFrame(
            [{"id": i, in_col: images[i]} for i in range(len(images))]
        ).repartition(3)
        model = (pipeline.TFModel(device="cpu").setExportDir(export_dir)
                 .setBatchSize(4).setInputMapping({in_col: in_col}))
        rows = model.transform(df).collect()
    finally:
        sc.stop()
    assert len(rows) == len(images)
    return np.asarray([r.prediction for r in rows])


def _check_nodes(nodes, steps):
    assert [n["state"] for n in nodes.values()] == ["finished"] * 2
    assert {n["device"] for n in nodes.values()} == {"cpu"}
    losses0, losses1 = nodes[0]["losses"], nodes[1]["losses"]
    assert len(losses0) == steps and losses0 == losses1  # gloo averaged
    assert all(np.isfinite(losses0))
    return losses0


@pytest.mark.parametrize("arch", ["inception_v3", "mobilenet_v1"])
def test_resnet_spark_arch_trains_like_a_replay_and_serves(tmp_path,
                                                          cluster_env, arch):
    lib = model_zoo.get_model(arch)
    config = lib.Config.tiny()
    data_dir = str(tmp_path / "tfr")
    resnet_spark.prep_tfrecords(data_dir, 32, 4, config)
    args = resnet_spark.parse_args([
        "--arch", arch, "--tiny", "--batch_size", "4", "--readers", "1",
        "--shuffle_buffer", "8", "--lr", "1e-2", "--data_dir", data_dir,
        "--model_dir", str(tmp_path / "export")])
    losses = _check_nodes(_run_tf_job(resnet_spark.map_fun, args,
                                      f"torch-{arch}"), 4)
    replay = _replay(args, resnet_spark.train_batches, arch, config)
    np.testing.assert_allclose(losses, replay, rtol=REPLAY_REL)

    # the chief's export (Trainer.export: the serialized forward) scores
    # every row as the zoo forward of its weights does
    images = np.random.RandomState(3).rand(
        10, config.image_size, config.image_size, 3).astype(np.float32)
    scores = _score(str(tmp_path / "export"), images)
    state = ckpt.load_pytree(str(tmp_path / "export" / "model"))
    model = lib.load_state(lib.make_model(lib.config_from_state(state)),
                           state)
    want = lib.make_forward_fn(model, config)(
        model, {"image": torch.from_numpy(images)}).numpy()
    assert scores.shape == (10, config.num_classes)
    np.testing.assert_allclose(scores, want, rtol=0, atol=SCORES_ABS)


def test_resnet_spark_synthetic_records_take_the_arch_image_size(
        tmp_path, cluster_env, capsys):
    """``main`` writes the records at the arch's size (32² for the tiny
    Inception), trains both nodes to the end of their shards."""
    resnet_spark.main(["--arch", "inception_v3", "--cluster_size", "2",
                       "--tiny", "--batch_size", "4", "--num_samples", "32",
                       "--readers", "2", "--shuffle_buffer", "8",
                       "--data_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "cluster total:" in out and "no steps ran" not in out
    assert len(list((tmp_path / "side32").glob("part-*"))) == 4
    assert len([line for line in out.splitlines()
                if line.startswith("node ") and "@ step 4)" in line]) == 2


def _load_reference_example():
    path = os.path.join(REPO, "examples", "mnist", "mnist_spark.py")
    spec = importlib.util.spec_from_file_location("ref_mnist_spark", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _StubFeed:
    """A node's ``DataFeed`` handing out ``batches`` in order: numpy
    columns (the JAX example stages them itself), or torch tensors on the
    CPU (what ``next_batch(device_put=True)`` gives the port's)."""

    def __init__(self, batches, as_tensors: bool):
        self.batches, self.as_tensors = list(batches), as_tensors

    def should_stop(self):
        return not self.batches

    def next_batch(self, batch_size, device_put=False):
        batch = self.batches.pop(0)
        assert len(batch["label"]) <= batch_size
        if self.as_tensors:
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return batch


def _stub_ctx(batches, as_tensors: bool):
    """A ``map_fun`` context around a :class:`_StubFeed` (executor 1: no
    export) and the dict its ``mgr.set`` publishes into."""
    published = {}
    feed = _StubFeed(batches, as_tensors)
    return types.SimpleNamespace(
        task_index=0, executor_id=1, get_data_feed=lambda **_: feed,
        mgr=types.SimpleNamespace(set=published.__setitem__),
        absolute_path=lambda p: p), published


def test_mnist_map_fun_equals_the_jax_example(monkeypatch):
    """200 rows in batches of 64 (the tail of 8 padded to 64, its zero
    rows in the loss, as the reference's) through each example's
    ``map_fun`` from the JAX example's initial weights (``PRNGKey(0)``,
    handed to the port's by its ``init_params``): the same final loss."""
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    ref = _load_reference_example()
    x, y = mnist_spark.synth_mnist(200, seed=4)
    assert np.array_equal(x, ref.synth_mnist(200, seed=4)[0])
    batches = [{"image": x[i:i + 64], "label": y[i:i + 64]}
               for i in range(0, 200, 64)]
    assert len(batches[-1]["label"]) == 8
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    init = {"w1": np.asarray(jax.random.normal(k1, (784, 32))) * 0.05,
            "b1": np.zeros(32, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (32, 10))) * 0.05,
            "b2": np.zeros(10, np.float32)}
    monkeypatch.setattr(mnist_spark, "init_params",
                        lambda hidden, seed: init)
    args = mnist_spark.parse_args(["--hidden", "32", "--batch_size", "64"])
    jax_ctx, jax_out = _stub_ctx(batches, as_tensors=False)
    ref.map_fun(args, jax_ctx)
    port_ctx, port_out = _stub_ctx(batches, as_tensors=True)
    mnist_spark.map_fun(args, port_ctx)
    assert port_out["examples_seen"] == jax_out["examples_seen"] == 200
    assert port_out["device"] == "cpu"
    assert abs(port_out["final_loss"] - jax_out["final_loss"]) \
        <= MNIST_LOSS_REL * jax_out["final_loss"]


def test_mnist_spark_trains_on_two_executors_and_serves(tmp_path,
                                                       cluster_env):
    export = str(tmp_path / "export")
    out = mnist_spark.main(["--cluster_size", "2", "--epochs", "2",
                            "--num_samples", "300", "--batch_size", "64",
                            "--model_dir", export])
    assert sorted(out) == ["chief:0", "worker:0"]
    assert sum(n["examples_seen"] for n in out.values()) == 600
    assert all(np.isfinite(n["final_loss"]) for n in out.values())
    # a program over whole batches, not one row at a time
    assert saved_model.read_signature(export)["batch"] == "polymorphic"
    x, _ = mnist_spark.synth_mnist(300)
    scores = _score(export, x[:13])
    state = ckpt.load_pytree(os.path.join(export, "model"))
    want = mnist_spark.serve(
        {k: torch.from_numpy(v) for k, v in state.items()},
        {"image": torch.from_numpy(x[:13])}).numpy()
    assert scores.shape == (13, 10)
    np.testing.assert_allclose(scores, want, rtol=0, atol=SCORES_ABS)


def test_cifar10_spark_trains_like_a_replay_and_serves(tmp_path,
                                                       cluster_env):
    data_dir = str(tmp_path / "tfr")
    args = cifar10_spark.parse_args([
        "--tiny", "--epochs", "1", "--batch_size", "8", "--readers", "1",
        "--shuffle_buffer", "16", "--lr", "1e-2", "--data_dir", data_dir,
        "--model_dir", str(tmp_path / "export")])
    sc = LocalSparkContext("local[1]", "cifar-records")
    try:
        cifar10_spark.prep_tfrecords(LocalSparkSession(sc), data_dir, 64, 4,
                                     8)
    finally:
        sc.stop()
    losses = _check_nodes(_run_tf_job(cifar10_spark.map_fun, args,
                                      "torch-cifar"), 4)
    from tensorflowonspark_torch.models import cifar

    config = cifar.Config.tiny()
    replay = _replay(args, cifar10_spark.train_batches, "cifar10_cnn",
                     config)
    np.testing.assert_allclose(losses, replay, rtol=REPLAY_REL)

    images = np.random.RandomState(5).rand(9, 8, 8, 3).astype(np.float32)
    scores = _score(str(tmp_path / "export"), images)
    state = ckpt.load_pytree(str(tmp_path / "export" / "model"))
    model = cifar.load_state(cifar.make_model(config), state)
    want = cifar.make_forward_fn(model, config)(
        model, {"image": torch.from_numpy(images)}).numpy()
    np.testing.assert_allclose(scores, want, rtol=0, atol=SCORES_ABS)


def test_cifar10_spark_main_shards_disjointly(tmp_path, cluster_env,
                                              capsys):
    """The example's defaults but sizes: 2 reader threads a node, records
    written on the first run, the two nodes' shards disjoint and covering
    every part file."""
    out = cifar10_spark.main(["--cluster_size", "2", "--epochs", "1",
                              "--tiny", "--num_samples", "128",
                              "--batch_size", "16",
                              "--data_dir", str(tmp_path / "tfr")])
    shards = [set(n["shard_files"]) for n in out.values()]
    assert not (shards[0] & shards[1])
    assert len(shards[0] | shards[1]) == len(list(
        (tmp_path / "tfr").glob("part-*"))) == 4
    assert all(n["steps"] == 4 and np.isfinite(n["final_loss"])
               for n in out.values())
    assert "examples/sec" in capsys.readouterr().out


def test_write_synthetic_tfrecords_keeps_labels_in_range(tmp_path):
    """The records' labels fit the config they are written for (10 classes
    tiny, 1000 full): the port's ``write_synthetic_tfrecords`` takes
    ``num_classes``."""
    from tensorflowonspark_torch import tfrecord

    for classes in (10, 1000):
        [path] = resnet.write_synthetic_tfrecords(
            str(tmp_path / str(classes)), 64, 1, 4, seed=1,
            num_classes=classes)
        labels = [tfrecord.decode_example(r)["label"][1][0]
                  for r in tfrecord.read_records(path)]
        assert len(labels) == 64 and 0 <= min(labels) \
            and max(labels) < classes
