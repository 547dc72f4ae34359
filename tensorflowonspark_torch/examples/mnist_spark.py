"""MNIST dense classifier, ``InputMode.SPARK`` end to end.

A port of ``examples/mnist/mnist_spark.py`` (acceptance config #1): feed
an RDD of ``(image, label)`` rows through the cluster; each node trains
the example's own 784 → hidden → 10 MLP on the batches its ``DataFeed``
hands it (bf16 matmuls, f32 bias and activations, SGD with momentum 0.9)
and publishes ``final_loss`` and ``examples_seen``.  As in the reference,
each node trains its own copy: there is no gradient exchange.  With
``--model_dir`` the chief writes a self-describing export of the
``serve`` closure, which ``TFModel`` serves with no access to this
script.

    python -m tensorflowonspark_torch.examples.mnist_spark --cluster_size 2 --epochs 3

Without a card set ``TFOS_TORCH_DEVICE=cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def init_params(hidden: int, seed: int) -> dict:
    """The reference's initial weights, drawn by numpy from ``seed``:
    normal × 0.05 matrices, zero biases."""
    rng = np.random.RandomState(seed)
    return {"w1": (rng.randn(784, hidden) * 0.05).astype(np.float32),
            "b1": np.zeros(hidden, np.float32),
            "w2": (rng.randn(hidden, 10) * 0.05).astype(np.float32),
            "b2": np.zeros(10, np.float32)}


def apply(params, x):
    """Logits of f32 images ``x`` (rows of 784 in [0, 1]): bfloat16 matmuls
    rounded to bf16, then the f32 bias and ReLU, as the reference's."""
    import torch

    h = torch.relu((x.bfloat16() @ params["w1"].bfloat16()).float()
                   + params["b1"])
    return (h.bfloat16() @ params["w2"].bfloat16()).float() + params["b2"]


def serve(state, batch):
    """The exported forward: 0-255 images → logits (serialized with the
    export, so a consumer needs no access to this script)."""
    return apply(state, batch["image"].float() / 255.0)


def train_batch(params, mom, batch, batch_size: int, lr: float):
    """One SGD-with-momentum step on ``batch`` (``image`` 0-255, ``label``),
    in place; returns the loss, a device scalar.  A short tail batch is
    padded with zero rows of label 0, which enter the mean loss: the
    reference pads to keep one compiled shape, and its loss counts them."""
    import torch
    import torch.nn.functional as F

    x = batch["image"].float() / 255.0
    y = batch["label"].long()
    pad = batch_size - x.shape[0]
    if pad > 0:
        x = F.pad(x, (0, 0, 0, pad))
        y = F.pad(y, (0, pad))
    loss = F.cross_entropy(apply(params, x), y)
    grads = torch.autograd.grad(loss, list(params.values()))
    with torch.no_grad():
        for (k, p), g in zip(params.items(), grads):
            mom[k].mul_(0.9).add_(g)
            p.sub_(lr * mom[k])
    return loss.detach()


def map_fun(args, ctx):
    """Per-node trainer: the MLP, fed by the node's ``DataFeed``."""
    import torch

    from tensorflowonspark_torch import util

    device = util.select_device()
    feed = ctx.get_data_feed(train_mode=True, input_mapping=["image", "label"],
                             prefetch=2)
    params = {k: torch.tensor(v, device=device, requires_grad=True)
              for k, v in init_params(args.hidden, ctx.task_index).items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    loss, seen = None, 0
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size, device_put=True)
        if not batch or batch["image"].shape[0] == 0:
            continue
        loss = train_batch(params, mom, batch, args.batch_size, args.lr)
        seen += int(batch["image"].shape[0])
    ctx.mgr.set("final_loss", float(loss) if loss is not None else None)
    ctx.mgr.set("examples_seen", seen)
    ctx.mgr.set("device", str(device))
    if args.model_dir and ctx.executor_id == 0:  # exactly one exporter
        from tensorflowonspark_torch import compat

        state = {k: v.detach().cpu().numpy() for k, v in params.items()}
        compat.export_saved_model(
            state, ctx.absolute_path(args.model_dir), forward_fn=serve,
            example_batch={"image": np.zeros((1, 784), np.float32)})


def synth_mnist(n: int, seed: int = 0):
    """MNIST-shaped synthetic data with learnable class structure (the
    reference's draw: the same rows for the same seed)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 784)) * 40 + 128
    labels = rng.integers(0, 10, size=n)
    imgs = protos[labels] + rng.normal(size=(n, 784)) * 25
    return np.clip(imgs, 0, 255).astype(np.float32), labels.astype(np.int32)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--cluster_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--num_samples", type=int, default=4096)
    p.add_argument("--data", default=None, help="optional mnist.npz path")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--master", default=None, help="Spark master override")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train; print and return each node's ``final_loss`` and
    ``examples_seen`` by ``job:task``."""
    args = parse_args(argv)

    from tensorflowonspark_torch import TFCluster, TFManager
    from tensorflowonspark_torch.sparkapi import get_spark_context

    sc = get_spark_context(
        args.master or f"local-cluster[{args.cluster_size},1,1024]",
        "mnist-spark")
    if args.data:
        with np.load(args.data) as z:
            x, y = z["x_train"].reshape(-1, 784), z["y_train"]
    else:
        x, y = synth_mnist(args.num_samples)
    rows = [(x[i], int(y[i])) for i in range(len(y))]

    cluster = TFCluster.run(
        sc, map_fun, args, num_executors=args.cluster_size,
        input_mode=TFCluster.InputMode.SPARK, master_node="chief",
    )
    cluster.train(sc.parallelize(rows, args.cluster_size),
                  num_epochs=args.epochs)
    cluster.shutdown(grace_secs=60)

    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    out = {}
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        node = f"{meta['job_name']}:{meta['task_index']}"
        out[node] = {"final_loss": mgr.get("final_loss"),
                     "examples_seen": mgr.get("examples_seen")}
        loss = out[node]["final_loss"]
        print(f"node {node} final_loss="
              f"{'none' if loss is None else f'{loss:.4f}'} "
              f"seen={out[node]['examples_seen']}")
    sc.stop()
    return out


if __name__ == "__main__":
    main()
