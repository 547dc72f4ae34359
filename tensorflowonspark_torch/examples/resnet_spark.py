"""ImageNet ResNet-50 / Inception-v3 / MobileNet-v1 data-parallel training
in ``InputMode.TENSORFLOW``.

A port of ``examples/imagenet/resnet_spark.py`` (``map_fun`` and
``main``).  Each executor runs ``map_fun`` inline: it joins the
``torch.distributed`` group (NCCL on the cards, gloo on the CPU), builds a
``Trainer`` on its device and trains from its own shard of the TFRecord
part files, read by :mod:`tensorflowonspark_torch.readers` — strided by
executor id, ``--readers`` reader threads, a seeded shuffle, and prefetch
staging the next batch onto the device (``trainer.shard``) while the
current one trains.  ``--synthetic`` trains on one device-resident batch
instead: the step's ceiling without the input pipeline.

``--ckpt_dir`` makes the job restartable, TFoS's recovery model: the
chief checkpoints every ``TFOS_CKPT_EVERY_STEPS`` steps (asynchronously),
and every node first restores the newest committed checkpoint and has its
reader drop the batches it already trained on unparsed, so a job run
again after a lost executor continues where the checkpoint left it
(``--max_steps`` bounds the run).  With
``--model_dir`` the chief writes the self-describing export
(``Trainer.export``), which ``TFModel`` serves with no model code.

Throughput is reported through the step-metrics hook
(``metrics.MetricsReporter`` → ``TFCluster.metrics()``).  ``--arch``
picks the zoo model, as the reference's does: ``resnet50``,
``inception_v3`` (the default SAME variant, 299² records) or
``mobilenet_v1``; the synthetic records take the model's image size and
classes.

    python -m tensorflowonspark_torch.examples.resnet_spark --cluster_size 2 --tiny
    python -m tensorflowonspark_torch.examples.resnet_spark --arch inception_v3 --tiny

Without a card set ``TFOS_TORCH_DEVICE=cpu`` (and, for a gloo group
between the executors, ``TFOS_TORCH_DISTRIBUTED=1``).
"""

from __future__ import annotations

import argparse
import os
import tempfile


def train_batches(args, files, seed: int, device_put, skip: int = 0):
    """The TFRecord batches ``map_fun`` trains on: ``files`` read through
    :func:`readers.tfrecord_batches` with the script's arguments, shuffled
    from ``seed``, staged by ``device_put``, the first ``skip`` (a
    restart's trained batches) dropped unparsed.  Replays call it too."""
    from tensorflowonspark_torch import models as model_zoo
    from tensorflowonspark_torch import readers
    from tensorflowonspark_torch.models import resnet

    lib = model_zoo.get_model(args.arch)
    side = (lib.Config.tiny() if args.tiny else lib.Config()).image_size
    return readers.tfrecord_batches(
        files,
        args.batch_size,
        parse_fn=resnet.tfrecord_parse_fn(side),
        num_epochs=args.epochs,
        readers=args.readers,
        shuffle_buffer=args.shuffle_buffer,
        shuffle_files=True,
        seed=seed,
        drop_remainder=True,
        prefetch=2,
        device_put=device_put,
        skip_batches=skip,
    )


def steps_of(args, batches, start: int = 0):
    """The batches a run trains on: ``batches`` (the stream after the
    restored step ``start``) up to ``--max_steps`` (0: to the end)."""
    import itertools

    return itertools.islice(
        batches, max(0, args.max_steps - start) if args.max_steps else None)


def map_fun(args, ctx):
    from tensorflowonspark_torch import metrics, readers
    from tensorflowonspark_torch import models as model_zoo
    from tensorflowonspark_torch.parallel import distributed
    from tensorflowonspark_torch.trainer import Trainer

    distributed.maybe_initialize(ctx)
    arch_lib = model_zoo.get_model(args.arch)
    config = arch_lib.Config.tiny() if args.tiny else arch_lib.Config()
    trainer = Trainer(args.arch, config=config, learning_rate=args.lr)
    start = 0
    if args.ckpt_dir:
        # every node restores; only the chief writes
        trainer.checkpoint(ctx.absolute_path(args.ckpt_dir),
                           every_steps=None if ctx.executor_id == 0 else 0)
        start = trainer.restore_latest() or 0
        ctx.mgr.set("restored_step", start)
    reporter = metrics.MetricsReporter(ctx, interval=5)
    trainer.add_step_callback(reporter)

    losses = []
    if args.synthetic:
        # pure-compute ceiling: one device-resident batch, no input pipeline
        batch = arch_lib.example_batch(config, batch_size=args.batch_size,
                                       seed=ctx.task_index)
        device_batch = trainer.shard(batch)
        state = trainer.state
        for _ in range(args.warmup):
            state, _ = trainer.train_step(state, device_batch)
        trainer.state = state
        for _ in range(args.steps):
            losses.append(trainer.step(device_batch))
    else:
        # stride by executor_id, NOT task_index: under master_node="chief"
        # the chief and worker:0 both have task_index 0 and would read the
        # same shard while another went unread
        shard = readers.shard_files(os.path.join(args.data_dir, "part-*"),
                                    ctx.executor_id, ctx.num_workers)
        for batch in steps_of(args, train_batches(
                args, shard, ctx.task_index, trainer.shard, start), start):
            losses.append(trainer.step(batch))
    # the loop's numbers, before the last checkpoint write is waited for
    snap = reporter.publish()
    trainer.finish_checkpoints()
    losses = [float(v) for v in losses]  # one sync, after the last step
    ctx.mgr.set("images_per_sec", snap["examples_per_sec"])
    ctx.mgr.set("final_loss", losses[-1] if losses else None)
    ctx.mgr.set("losses", losses)
    ctx.mgr.set("device", str(trainer.device))
    if args.model_dir and ctx.executor_id == 0:
        trainer.export(ctx.absolute_path(args.model_dir))


def prep_tfrecords(data_dir: str, n: int, parts: int, config,
                   seed: int = 0) -> None:
    """Synthesise ImageNet-shaped TFRecords for ``config`` (its image
    size, labels within its classes)."""
    from tensorflowonspark_torch.models import resnet

    resnet.write_synthetic_tfrecords(data_dir, n, parts, config.image_size,
                                     seed, num_classes=config.num_classes)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="resnet50",
                   choices=["resnet50", "inception_v3", "mobilenet_v1"],
                   help="acceptance config #3 names resnet50/inception_v3; "
                        "mobilenet_v1 covers the reference's slim family")
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=10,
                   help="steps for --synthetic mode")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--num_samples", type=int, default=512)
    p.add_argument("--readers", type=int, default=2,
                   help="parallel reader threads per node (HasReaders parity)")
    p.add_argument("--shuffle_buffer", type=int, default=256)
    p.add_argument("--data_dir",
                   default=os.path.join(tempfile.gettempdir(), "imagenet_tfr"),
                   help="TFRecord dir (synthesised on first run)")
    p.add_argument("--synthetic", action="store_true",
                   help="skip the input pipeline; device-resident batch")
    p.add_argument("--model_dir", default=None,
                   help="the chief's self-describing export")
    p.add_argument("--ckpt_dir", default=None,
                   help="checkpoint here every TFOS_CKPT_EVERY_STEPS "
                        "steps; resume from the newest step")
    p.add_argument("--max_steps", type=int, default=0,
                   help="stop at this step (0: at the data's end)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--master", default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from tensorflowonspark_torch import TFCluster
    from tensorflowonspark_torch.sparkapi import get_spark_context

    if not args.synthetic:
        import glob

        from tensorflowonspark_torch import models as model_zoo

        lib = model_zoo.get_model(args.arch)
        config = lib.Config.tiny() if args.tiny else lib.Config()
        # records are side-specific: key the synthetic dir on the image size
        # so --tiny switches never reuse incompatible records
        args.data_dir = os.path.join(args.data_dir,
                                     f"side{config.image_size}")
        if not glob.glob(os.path.join(args.data_dir, "part-*")):
            prep_tfrecords(args.data_dir, args.num_samples,
                           args.cluster_size * 2, config)

    sc = get_spark_context(
        args.master or f"local-cluster[{args.cluster_size},1,1024]",
        "resnet-spark")
    cluster = TFCluster.run(
        sc, map_fun, args, num_executors=args.cluster_size,
        input_mode=TFCluster.InputMode.TENSORFLOW, master_node="chief",
    )
    cluster.shutdown(grace_secs=600)

    agg = cluster.metrics()
    for name, snap in agg["nodes"].items():
        loss = snap["loss"]
        print(f"node {name}: {snap['examples_per_sec']} images/sec "
              f"(loss {loss:.3f} @ step {snap['step']})" if loss is not None
              else f"node {name}: no steps ran (empty shard?)")
    print(f"cluster total: {agg['total_examples_per_sec']} images/sec")
    sc.stop()


if __name__ == "__main__":
    main()
