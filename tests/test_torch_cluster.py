"""The port's training slice on the local Spark substrate, on the CPU.

``TFCluster.run(InputMode.SPARK)`` with two executors trains the tiny
ResNet: each node's ``map_fun`` reads its partition through
``DataFeed.next_batch(device_put=trainer.shard)`` (prefetching) and takes
``Trainer.step``s; the nodes form a gloo group
(``TFOS_TORCH_DISTRIBUTED=1``), so the gradients are averaged across them.
Real processes: executors, their managers and the spawned trainers.
"""

import os
import sys
import time

import cloudpickle
import numpy as np
import pytest
import torch

from tensorflowonspark_torch import TFCluster, TFManager
from tensorflowonspark_torch.sparkapi import LocalSparkContext

# ship this test module by value so spawned executors/trainers don't need to
# import it by name
cloudpickle.register_pickle_by_value(sys.modules[__name__])

ROWS = 32  # 16 a partition
BATCH = 4
LR = 1e-2


@pytest.fixture()
def sc(monkeypatch):
    """Two executors on the CPU (they inherit the environment at start)."""
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TFOS_TORCH_DISTRIBUTED", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = LocalSparkContext("local-cluster[2,1,1024]", "torch-cluster-test")
    yield ctx
    ctx.stop()


@pytest.fixture()
def sc_pickled_feed(monkeypatch):
    """As ``sc``, with the feed's pickled transport (``TFOS_FEED_SHM=0``):
    chunks a failed node never consumes then leave nothing in /dev/shm,
    where other tests check for segments."""
    monkeypatch.setenv("TFOS_FEED_SHM", "0")
    monkeypatch.setenv("TFOS_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = LocalSparkContext("local-cluster[2,1,1024]", "torch-cluster-test")
    yield ctx
    ctx.stop()


def _rows(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(ROWS, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=ROWS)
    return [(images[i], int(labels[i])) for i in range(ROWS)]


def resnet_train_fun(args, ctx):
    """Train the tiny ResNet from the Spark feed; publish the losses and a
    checksum of the params."""
    import torch

    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    torch.set_num_threads(1)
    trainer = Trainer("resnet50", config=resnet.Config.tiny(),
                      learning_rate=args["lr"], seed=0)
    trainer.add_step_callback(metrics.MetricsReporter(ctx, interval=1))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["image", "label"], prefetch=2)
    ctx.mgr.set("ready", True)
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args["batch"], device_put=trainer.shard)
        if not batch or batch["image"].shape[0] == 0:
            continue
        losses.append(float(trainer.step(batch)))
    ctx.mgr.set("losses", losses)
    ctx.mgr.set("param_sum", float(sum(
        p.detach().double().sum() for p in trainer.params.values())))


def failing_fun(args, ctx):
    raise ValueError("synthetic map_fun failure")


def _feed_segments(sc):
    """``/dev/shm`` feed segments created by this context's executors."""
    from tensorflowonspark_torch import shm

    prefixes = tuple(f"{shm.SEG_PREFIX}_{p.pid}_" for p in sc._procs)
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefixes)]


def _await_ready(cluster, timeout=120.0):
    """Wait until every node's trainer is ready to read its feed, so fed
    chunks spend no time waiting in /dev/shm."""
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    mgrs = [TFManager.connect(tuple(m["addr"]), authkey)
            for m in cluster.cluster_info]
    deadline = time.monotonic() + timeout
    while not all(m.get("ready") for m in mgrs):
        assert time.monotonic() < deadline, "trainers not ready"
        time.sleep(0.1)


def _replay(rows):
    """One process stepping what the two ranks stepped: batch i is rank 0's
    i-th batch then rank 1's (partition r feeds rank r)."""
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    t = Trainer("resnet50", config=resnet.Config.tiny(), learning_rate=LR,
                seed=0, device="cpu")
    half = ROWS // 2
    losses = []
    for lo in range(0, half, BATCH):
        part = rows[lo:lo + BATCH] + rows[half + lo:half + lo + BATCH]
        batch = {"image": np.stack([r[0] for r in part]),
                 "label": np.array([r[1] for r in part])}
        losses.append(float(t.step(batch)))
    return losses


def test_spark_mode_trains_the_tiny_resnet_data_parallel(sc):
    torch.set_num_threads(1)
    rows = _rows()
    cluster = TFCluster.run(sc, resnet_train_fun,
                            {"batch": BATCH, "lr": LR}, num_executors=2,
                            input_mode=TFCluster.InputMode.SPARK)
    _await_ready(cluster)
    cluster.train(sc.parallelize(rows, 2), feed_timeout=120)
    cluster.shutdown(grace_secs=60)  # joins: the trainers finish first
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    published = []
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        assert mgr.get("state") == "finished"
        published.append((mgr.get("losses"), mgr.get("param_sum")))
    agg = cluster.metrics()
    (losses0, sum0), (losses1, sum1) = published
    assert len(losses0) == ROWS // 2 // BATCH
    assert losses0 == losses1 and sum0 == sum1  # the all-reduce kept them
    assert all(np.isfinite(losses0))
    np.testing.assert_allclose(losses0, _replay(rows), rtol=1e-4)
    assert agg["total_examples_per_sec"] > 0
    assert not _feed_segments(sc)


def test_map_fun_error_surfaces_at_the_driver(sc_pickled_feed):
    sc = sc_pickled_feed
    cluster = TFCluster.run(sc, failing_fun, tf_args=None, num_executors=2)
    rdd = sc.parallelize(_rows(), 2)
    with pytest.raises(RuntimeError, match="synthetic map_fun failure"):
        # the error surfaces on feed (trainer already dead) or at shutdown
        cluster.train(rdd, feed_timeout=30)
        cluster.shutdown(grace_secs=10)
    cluster.server.stop()
