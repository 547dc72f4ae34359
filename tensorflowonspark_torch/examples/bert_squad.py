"""BERT SQuAD fine-tune streamed from a Spark DataFrame, ``InputMode.SPARK``.

A port of ``examples/bert/bert_squad.py`` (acceptance config #5), data
parallel: each executor's ``map_fun`` joins the ``torch.distributed``
group (NCCL on the cards, gloo on the CPU), builds a ``Trainer("bert")``
(``Config(remat=True)``, BERT-base; ``--tiny`` for the test config) with
AdamW (lr ``--lr``, weight decay 0.01) and trains on the batches its
``DataFeed`` hands it from the DataFrame's rows, staged onto the device
(int32) in the feed's prefetch thread; a short tail batch is dropped.
Each node publishes ``final_loss``, ``steps`` and its ``losses``; with
``--model_dir`` the chief writes the self-describing export
(``Trainer.export``), which ``TFModel.transform`` serves with no model
code: two output columns, ``output_0`` (start logits) and ``output_1``
(end logits).  The export's sequence length is ``example_batch``'s
(``min(max_len, 384)``), as the reference's.

The reference's mesh flags are accepted for parity, but only data
parallelism is ported: ``--fsdp``, ``--sp``, ``--tp``, ``--pp`` or
``--ep`` above 1 and ``--moe_experts`` above 0 raise (ROADMAP Queue 1
item 6).

    python -m tensorflowonspark_torch.examples.bert_squad --cluster_size 2 --tiny

Without a card set ``TFOS_TORCH_DEVICE=cpu`` (and, for a gloo group
between the executors, ``TFOS_TORCH_DISTRIBUTED=1``).
"""

from __future__ import annotations

import argparse

#: the DataFrame's columns, in ``synth_squad``'s row order
COLUMNS = ["input_ids", "token_type_ids", "attention_mask",
           "start_positions", "end_positions"]
WEIGHT_DECAY = 0.01


def check_parallelism(args) -> None:
    """Raise for the reference's mesh axes beyond data parallelism."""
    beyond = {f"--{k}": getattr(args, k) for k in ("fsdp", "sp", "tp", "pp",
                                                   "ep")
              if getattr(args, k) > 1}
    if args.moe_experts > 0:
        beyond["--moe_experts"] = args.moe_experts
    if beyond:
        raise NotImplementedError(
            f"{beyond}: only data parallelism (--dp) is ported; fsdp, sp, "
            "tp, pp, ep and MoE wait for ROADMAP Queue 1 item 6")


def make_optimizer(lr: float):
    """The example's AdamW (``optax.adamw(lr, weight_decay=0.01)``),
    capturable and fused on a card (``trainer.card_adamw``)."""
    import torch

    from tensorflowonspark_torch.trainer import card_adamw

    def optimizer(params):
        params = list(params)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=WEIGHT_DECAY,
                                 **card_adamw(params))

    return optimizer


def make_trainer(args, device=None):
    """The node's ``Trainer``: ``--tiny``'s config or BERT-base with
    remat, the example's AdamW, seed 0 on every node."""
    from tensorflowonspark_torch.models import bert
    from tensorflowonspark_torch.trainer import Trainer

    config = bert.Config.tiny() if args.tiny else bert.Config(remat=True)
    return Trainer("bert", config=config, device=device,
                   optimizer=make_optimizer(args.lr))


def map_fun(args, ctx):
    import numpy as np

    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.parallel import distributed

    check_parallelism(args)
    distributed.maybe_initialize(ctx)
    trainer = make_trainer(args)
    reporter = metrics.MetricsReporter(ctx, interval=5)
    trainer.add_step_callback(reporter)
    feed = ctx.get_data_feed(train_mode=True, input_mapping=COLUMNS,
                             prefetch=2)

    def stage(batch):
        # int32 ids and the copy to the device, in the feed's prefetch
        # thread; a short tail batch stays on the host and is dropped
        if len(batch["input_ids"]) != args.batch_size:
            return batch
        return trainer.shard({k: np.asarray(v, np.int32)
                              for k, v in batch.items()})

    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size, device_put=stage)
        if not batch or len(batch["input_ids"]) != args.batch_size:
            continue
        losses.append(trainer.step(batch))
    snap = reporter.publish()  # the loop's rate, every step in it
    losses = [float(v) for v in losses]  # one sync, after the last step
    ctx.mgr.set("sequences_per_sec", snap["examples_per_sec"])
    ctx.mgr.set("final_loss", losses[-1] if losses else None)
    ctx.mgr.set("steps", len(losses))
    ctx.mgr.set("losses", losses)
    ctx.mgr.set("device", str(trainer.device))
    if args.model_dir and ctx.executor_id == 0:
        trainer.export(ctx.absolute_path(args.model_dir))


def synth_squad(n: int, vocab: int, seq_len: int, seed: int = 0):
    """Tokenised SQuAD-shaped rows (a real run plugs a tokenizer in here)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        length = rng.randint(seq_len // 2, seq_len + 1)
        ids = np.zeros(seq_len, np.int64)
        ids[:length] = rng.randint(5, vocab, size=length)
        mask = (ids != 0).astype(np.int64)
        types = np.zeros(seq_len, np.int64)
        types[length // 2:length] = 1  # question | context halves
        s = rng.randint(length // 2, length)
        e = rng.randint(s, length)
        rows.append((ids.tolist(), types.tolist(), mask.tolist(), int(s), int(e)))
    return rows


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--dp", type=int, default=-1,
                   help="data parallelism: every executor (the default)")
    for axis in ("fsdp", "sp", "tp", "pp", "ep"):
        p.add_argument(f"--{axis}", type=int, default=1,
                       help="not ported: > 1 raises")
    p.add_argument("--pp_microbatches", type=int, default=4)
    p.add_argument("--moe_experts", type=int, default=0,
                   help="not ported: > 0 raises")
    p.add_argument("--num_samples", type=int, default=512)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--master", default=None, help="Spark master override")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; print and return each node's ``final_loss`` and ``steps`` by
    ``job:task``."""
    args = parse_args(argv)
    check_parallelism(args)

    from tensorflowonspark_torch import TFCluster, TFManager
    from tensorflowonspark_torch.models import bert
    from tensorflowonspark_torch.sparkapi import get_spark_context
    from tensorflowonspark_torch.sparkapi.sql import LocalSparkSession

    sc = get_spark_context(
        args.master or f"local-cluster[{args.cluster_size},1,1024]",
        "bert-squad")
    spark = LocalSparkSession(sc)

    vocab = (bert.Config.tiny() if args.tiny else bert.Config()).vocab_size
    df = spark.createDataFrame(
        synth_squad(args.num_samples, vocab, args.seq_len), COLUMNS,
    ).repartition(args.cluster_size)

    cluster = TFCluster.run(
        sc, map_fun, args, num_executors=args.cluster_size,
        input_mode=TFCluster.InputMode.SPARK, master_node="chief",
    )
    cluster.train(df.rdd.map(list), num_epochs=args.epochs)
    cluster.shutdown(grace_secs=120)

    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    out = {}
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        node = f"{meta['job_name']}:{meta['task_index']}"
        out[node] = {"final_loss": mgr.get("final_loss"),
                     "steps": mgr.get("steps")}
        loss = out[node]["final_loss"]
        print(f"node {node} loss="
              f"{'none' if loss is None else f'{loss:.4f}'} "
              f"steps={out[node]['steps']}")
    sc.stop()
    return out


if __name__ == "__main__":
    main()
