"""Criteo wide-and-deep via the Spark ML pipeline or ``InputMode.TENSORFLOW``.

A port of ``examples/criteo/criteo_pipeline.py`` (``train_fun``,
``parquet_train_fun``, ``synth_criteo`` and ``main``):

- ``--input spark``: ``TFEstimator(train_fun).fit(df)`` trains from the
  DataFrame feed (``DataFeed.next_batch``);
- ``--input parquet``: the DataFrame is saved as Parquet part files
  (``dfutil.saveAsParquet``, written from the executors) and each node of
  an ``InputMode.TENSORFLOW`` cluster reads its file shard through
  ``readers.parquet_batches`` — row groups to column buffers to the device,
  no Spark feed.

Either way the chief writes the self-describing export (weights and the
serialized forward, ``Trainer.export``) and ``TFModel.transform`` scores
the DataFrame back (``ctr``) from the serialized forward.

    python -m tensorflowonspark_torch.examples.criteo_pipeline --cluster_size 2 --input parquet

Without a card set ``TFOS_TORCH_DEVICE=cpu`` (and, for a gloo group
between the executors, ``TFOS_TORCH_DISTRIBUTED=1``).
"""

from __future__ import annotations

import argparse
import os
import tempfile


def make_trainer(args, device=None):
    """The wide&deep ``Trainer`` of both train functions, on ``device``
    (default: the node's, :func:`util.select_device`): ``--lr`` drives both
    towers of the CTR recipe, AdaGrad on the tables at 10x (the classic
    wide-vs-deep rate split), AdamW on the MLP through the Trainer's
    default optimizer."""
    import dataclasses

    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    config = widedeep.Config.tiny() if args.tiny else widedeep.Config()
    config = dataclasses.replace(config, table_lr=args.lr * 10.0)
    return Trainer("wide_deep", config=config, learning_rate=args.lr,
                   device=device)


def _node_trainer(args, ctx):
    """Join the process group, build the node's trainer and attach the
    step-metrics hook (``TFCluster.metrics()``)."""
    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.parallel import distributed

    distributed.maybe_initialize(ctx)
    trainer = make_trainer(args)
    reporter = metrics.MetricsReporter(ctx, interval=5)
    trainer.add_step_callback(reporter)
    return trainer, reporter


def stage_fn(trainer):
    """The stager of both train functions: the step's dtypes (f32 dense,
    i32 ids and labels), then ``trainer.shard`` onto the node's device, in
    the feed's pipeline thread."""
    import numpy as np

    def stage(batch):
        return trainer.shard({
            "dense": batch["dense"].astype(np.float32),
            "cat": batch["cat"].astype(np.int32),
            "label": batch["label"].astype(np.int32),
        })

    return stage


def train_fun(args, ctx):
    """Per-node wide&deep trainer fed by the DataFrame partitions."""
    trainer, reporter = _node_trainer(args, ctx)
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["dense", "cat", "label"],
                             prefetch=2)
    stage_full = stage_fn(trainer)

    def stage(batch):
        # short tail batches (partition end) stay on the host: the train
        # loop drops them
        if batch["dense"].shape[0] != args.batch_size:
            return batch
        return stage_full(batch)

    loss, steps = None, 0
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size, device_put=stage)
        if not batch or batch["dense"].shape[0] != args.batch_size:
            continue
        loss = trainer.step(batch)
        steps += 1
    reporter.publish()
    ctx.mgr.set("final_loss", float(loss) if loss is not None else None)
    ctx.mgr.set("steps", steps)
    if ctx.job_name == "chief":
        # weights + serving collections + the serialized forward;
        # Trainer.export strips the tables' _opt accumulators
        trainer.export(ctx.absolute_path(args.export_dir))


def parquet_shard(args, executor_id: int, num_workers: int) -> list:
    """A node's Parquet part files: the same (unresolved) path ``main``
    saved to, strided by executor_id, NOT task_index (chief and worker:0
    share task_index 0 under master_node="chief")."""
    from tensorflowonspark_torch import readers

    return readers.shard_files(args.parquet_dir + "/part-*.parquet",
                               executor_id, num_workers)


def parquet_batches(args, files, device_put):
    """The Parquet batches ``parquet_train_fun`` trains on (whole batches
    only), staged by ``device_put``.  Replays call it too."""
    from tensorflowonspark_torch import readers

    return readers.parquet_batches(
        files, args.batch_size, num_epochs=args.epochs, drop_remainder=True,
        prefetch=2, device_put=device_put)


def parquet_train_fun(args, ctx):
    """InputMode.TENSORFLOW trainer: each node reads its shard of the
    Parquet part files through the columnar path
    (``readers.parquet_batches`` — row groups → column buffers →
    double-buffered copies to the device), no Spark feed anywhere."""
    trainer, reporter = _node_trainer(args, ctx)
    shard = parquet_shard(args, ctx.executor_id, ctx.num_workers)
    losses = []
    for batch in parquet_batches(args, shard, stage_fn(trainer)):
        losses.append(trainer.step(batch))
    reporter.publish()
    losses = [float(v) for v in losses]  # one sync, after the last step
    ctx.mgr.set("final_loss", losses[-1] if losses else None)
    ctx.mgr.set("steps", len(losses))
    ctx.mgr.set("losses", losses)
    ctx.mgr.set("device", str(trainer.device))
    ctx.mgr.set("shard_files", len(shard))
    if ctx.job_name == "chief":
        trainer.export(ctx.absolute_path(args.export_dir))


def synth_criteo(n: int, buckets: int, seed: int = 0):
    """Criteo-shaped rows with a learnable click signal."""
    import numpy as np

    from tensorflowonspark_torch.models.widedeep import NUM_CAT, NUM_DENSE

    rng = np.random.RandomState(seed)
    dense = rng.rand(n, NUM_DENSE)
    cat = rng.randint(0, buckets, size=(n, NUM_CAT))
    # clicks driven by dense[0] and one categorical bucket parity
    logit = 3.0 * (dense[:, 0] - 0.5) + (cat[:, 0] % 2) - 0.5
    label = (1 / (1 + np.exp(-logit)) > rng.rand(n)).astype(int)
    return [
        (dense[i].tolist(), cat[i].tolist(), int(label[i])) for i in range(n)
    ]


def parse_args(argv=None) -> argparse.Namespace:
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--num_samples", type=int, default=4096)
    p.add_argument("--export_dir", default=os.path.join(tmp, "criteo_export"))
    p.add_argument("--tiny", action="store_true", default=True)
    p.add_argument("--full", dest="tiny", action="store_false")
    p.add_argument("--master", default=None)
    p.add_argument("--input", choices=["spark", "parquet"], default="spark",
                   help="spark: estimator feed through the cluster queues; "
                        "parquet: save the DataFrame as Parquet and train "
                        "InputMode.TENSORFLOW over the columnar path")
    p.add_argument("--parquet_dir", default=os.path.join(tmp, "criteo_parquet"))
    return p.parse_args(argv)


def main(argv=None):
    """Train, then score the DataFrame; returns the scored rows."""
    args = parse_args(argv)

    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.pipeline import TFEstimator
    from tensorflowonspark_torch.sparkapi import get_spark_context
    from tensorflowonspark_torch.sparkapi.sql import LocalSparkSession

    sc = get_spark_context(
        args.master or f"local-cluster[{args.cluster_size},1,1024]",
        "criteo-pipeline")
    spark = LocalSparkSession(sc)

    buckets = (widedeep.Config.tiny() if args.tiny
               else widedeep.Config()).hash_buckets
    df = spark.createDataFrame(
        synth_criteo(args.num_samples, buckets), ["dense", "cat", "label"]
    ).repartition(args.cluster_size)

    if args.input == "parquet":
        # columnar path: DataFrame → Parquet part files (written from the
        # executors) → InputMode.TENSORFLOW nodes reading their file shards
        # through readers.parquet_batches → same export
        import shutil

        from tensorflowonspark_torch import TFCluster, dfutil, fs
        from tensorflowonspark_torch.pipeline import TFModel

        if "://" in args.parquet_dir:
            # remote dirs can't be rmtree'd from here; stale part files
            # would silently mix with (or schema-clash against) this run's
            stale = fs.glob(args.parquet_dir + "/part-*.parquet")
            if stale:
                raise SystemExit(
                    f"--parquet_dir {args.parquet_dir} already holds "
                    f"{len(stale)} part files; remove them first")
        else:
            shutil.rmtree(args.parquet_dir, ignore_errors=True)
        dfutil.saveAsParquet(df, args.parquet_dir)
        cluster = TFCluster.run(
            sc, parquet_train_fun, args, num_executors=args.cluster_size,
            input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief")
        cluster.shutdown(grace_secs=120)
        model = (TFModel(tf_args=args)
                 .setExportDir(args.export_dir)
                 .setModelName("wide_deep"))
    else:
        est = (TFEstimator(train_fun, tf_args=args)
               .setClusterSize(args.cluster_size)
               .setBatchSize(args.batch_size)
               .setEpochs(args.epochs)
               .setExportDir(args.export_dir)
               .setModelName("wide_deep"))
        model = est.fit(df)

    scored = (model
              .setBatchSize(256)
              .setInputMapping({"dense": "dense", "cat": "cat"})
              .setOutputMapping({"prediction": "ctr"})
              .transform(df.select("dense", "cat")))
    rows = scored.collect()
    import numpy as np

    ctrs = np.asarray([r.ctr for r in rows])
    print(f"scored {len(rows)} rows; ctr mean={ctrs.mean():.3f} "
          f"min={ctrs.min():.3f} max={ctrs.max():.3f}")
    sc.stop()
    return rows


if __name__ == "__main__":
    main()
