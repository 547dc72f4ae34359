"""CIFAR-10 CNN in ``InputMode.TENSORFLOW`` from TFRecords.

A port of ``examples/cifar10/cifar10_spark.py`` (acceptance config #2).
The driver writes CIFAR-shaped synthetic rows as TFRecord part files
(``dfutil.saveAsTFRecords``, the image a float list); each node joins the
``torch.distributed`` group, builds a ``Trainer("cifar10_cnn")`` on its
device and trains from its own strided shard of the part files, read by
:mod:`tensorflowonspark_torch.readers` (``--readers`` threads, a seeded
shuffle, prefetch staging the next batch onto the device).  With
``--model_dir`` the chief writes the self-describing export.

    python -m tensorflowonspark_torch.examples.cifar10_spark --cluster_size 2 --epochs 2

Without a card set ``TFOS_TORCH_DEVICE=cpu`` (and, for a gloo group
between the executors, ``TFOS_TORCH_DISTRIBUTED=1``).
"""

from __future__ import annotations

import argparse
import glob
import os
import tempfile

import numpy as np


def parse_fn(side: int):
    """Decode a record of :func:`prep_tfrecords` into ``{"image": f32
    (side, side, 3) in [0, 1], "label": i32}``."""
    from tensorflowonspark_torch import tfrecord

    def parse(payload: bytes):
        ex = tfrecord.decode_example(payload)
        return {"image": np.asarray(ex["image"][1], np.float32)
                .reshape(side, side, 3) / 255.0,
                "label": np.int32(ex["label"][1][0])}

    return parse


def config_of(args):
    from tensorflowonspark_torch.models import cifar

    return cifar.Config.tiny() if args.tiny else cifar.Config()


def train_batches(args, files, seed: int, device_put):
    """The batches ``map_fun`` trains on: ``files`` through
    :func:`readers.tfrecord_batches` with the script's arguments, shuffled
    from ``seed``, staged by ``device_put``.  Replays call it too."""
    from tensorflowonspark_torch import readers

    return readers.tfrecord_batches(
        files, args.batch_size, parse_fn=parse_fn(config_of(args).image_size),
        num_epochs=args.epochs, readers=args.readers,
        shuffle_buffer=args.shuffle_buffer, shuffle_files=True, seed=seed,
        drop_remainder=True, prefetch=2, device_put=device_put)


def map_fun(args, ctx):
    """TENSORFLOW-mode trainer: read the node's TFRecord shard, train,
    export."""
    from tensorflowonspark_torch import metrics, readers
    from tensorflowonspark_torch.parallel import distributed
    from tensorflowonspark_torch.trainer import Trainer

    distributed.maybe_initialize(ctx)
    trainer = Trainer("cifar10_cnn", config=config_of(args),
                      learning_rate=args.lr)
    reporter = metrics.MetricsReporter(ctx, interval=5)
    trainer.add_step_callback(reporter)
    # strided by executor_id, NOT task_index: under master_node="chief"
    # the chief and worker:0 share task_index 0
    shard = readers.shard_files(os.path.join(args.data_dir, "part-*"),
                                ctx.executor_id, ctx.num_workers)
    losses = [trainer.step(batch) for batch in train_batches(
        args, shard, ctx.task_index, trainer.shard)]
    snap = reporter.publish()
    losses = [float(v) for v in losses]  # one sync, after the last step
    ctx.mgr.set("final_loss", losses[-1] if losses else None)
    ctx.mgr.set("losses", losses)
    ctx.mgr.set("steps", len(losses))
    ctx.mgr.set("shard_files", [os.path.basename(f) for f in shard])
    ctx.mgr.set("examples_per_sec", snap["examples_per_sec"])
    ctx.mgr.set("device", str(trainer.device))
    if args.model_dir and ctx.executor_id == 0:
        trainer.export(ctx.absolute_path(args.model_dir))


def synth_cifar(n: int, side: int, seed: int = 0):
    """CIFAR-shaped synthetic images (0-255 floats, flat) with learnable
    class structure, and their labels: the reference's draw."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, side * side * 3)) * 40 + 128
    labels = rng.integers(0, 10, size=n)
    images = np.clip(protos[labels] + rng.normal(size=(n, side * side * 3))
                     * 25, 0, 255)
    return images, labels


def prep_tfrecords(spark, data_dir: str, n: int, parts: int, side: int,
                   seed: int = 0) -> None:
    """Write :func:`synth_cifar`'s rows as TFRecord part files."""
    from tensorflowonspark_torch import dfutil

    images, labels = synth_cifar(n, side, seed)
    rows = [(images[i].astype(np.float64).tolist(), int(labels[i]))
            for i in range(n)]
    df = spark.createDataFrame(rows, ["image", "label"]).repartition(parts)
    dfutil.saveAsTFRecords(df, data_dir)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num_samples", type=int, default=2048)
    p.add_argument("--readers", type=int, default=2,
                   help="parallel reader threads per node (HasReaders parity)")
    p.add_argument("--shuffle_buffer", type=int, default=512)
    p.add_argument("--data_dir",
                   default=os.path.join(tempfile.gettempdir(), "cifar10_tfr"))
    p.add_argument("--model_dir", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model + 8x8 images (CI-sized)")
    p.add_argument("--master", default=None)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the records (on the first run), train; print and return each
    node's published results by ``job:task``."""
    args = parse_args(argv)

    from tensorflowonspark_torch import TFCluster, TFManager
    from tensorflowonspark_torch.sparkapi import get_spark_context
    from tensorflowonspark_torch.sparkapi.sql import LocalSparkSession

    sc = get_spark_context(
        args.master or f"local-cluster[{args.cluster_size},1,1024]",
        "cifar10-spark")
    if not glob.glob(os.path.join(args.data_dir, "part-*")):
        prep_tfrecords(LocalSparkSession(sc), args.data_dir,
                       args.num_samples, args.cluster_size * 2,
                       config_of(args).image_size)
    cluster = TFCluster.run(
        sc, map_fun, args, num_executors=args.cluster_size,
        input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
    )
    cluster.shutdown(grace_secs=120)

    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    out = {}
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        node = f"{meta['job_name']}:{meta['task_index']}"
        out[node] = {k: mgr.get(k) for k in ("final_loss", "losses", "steps",
                                              "shard_files", "device")}
        loss = out[node]["final_loss"]
        print(f"node {node} loss={'none' if loss is None else f'{loss:.4f}'}"
              f" steps={out[node]['steps']} "
              f"shard={out[node]['shard_files']}")
    agg = cluster.metrics()
    print(f"cluster: {agg['total_examples_per_sec']} examples/sec "
          f"({agg['num_reporting']} nodes reporting)")
    sc.stop()
    return out


if __name__ == "__main__":
    main()
