"""Multi-process ``torch.distributed`` initialisation, seeded by the
rendezvous barrier.

Reference anchor: ``tensorflowonspark_tpu/parallel/distributed.py``, which
calls ``jax.distributed.initialize`` so XLA collectives span every host.
Here the same rule forms a ``torch.distributed`` process group — NCCL on
the card, gloo on the CPU — so the train step can average gradients with
``all_reduce`` (:func:`tensorflowonspark_torch.parallel.train.make_train_step`).

Executor 0 publishes its reserved ``host:port`` on the rendezvous kv under
:data:`MASTER_KEY` before it registers (``TFSparkNode._MapFn``), so every
node reads it after the barrier and hands it to ``init_process_group`` as
``tcp://host:port``.
"""

from __future__ import annotations

import datetime
import logging
import os

logger = logging.getLogger(__name__)

# Set TFOS_TORCH_DISTRIBUTED=0 to keep every node a process of its own even
# in a multi-node cluster, =1 to form the group on card-less hosts too
# (gloo on the CPU: the tests do).  Default: form it when the cluster has
# more than one node and cards are present.
DISTRIBUTED_ENV = "TFOS_TORCH_DISTRIBUTED"
#: rendezvous kv key of the process group's ``host:port``
MASTER_KEY = "torch_master"

_initialized = False


def master_address(ctx, timeout: float = 60.0) -> str:
    """The ``host:port`` executor 0 published on the rendezvous kv."""
    from tensorflowonspark_torch import reservation

    try:
        return reservation.Client(ctx.server_addr, ctx.auth_token).get(
            MASTER_KEY, timeout=timeout)
    except KeyError:
        raise RuntimeError(f"no {MASTER_KEY!r} on the rendezvous kv after "
                           f"{timeout}s: executor 0 publishes it before it "
                           "registers") from None


def maybe_initialize(ctx) -> bool:
    """Form the process group for this node if appropriate.

    Returns True when the group was (already) formed.  No-op for
    single-node clusters, when ``TFOS_TORCH_DISTRIBUTED=0``, or when no
    cards are present unless ``TFOS_TORCH_DISTRIBUTED=1``.  The rank is
    the node's position among the sorted executor ids (so ranks stay
    contiguous when ids have holes), as the reference's process id.
    """
    global _initialized
    if _initialized:
        return True
    flag = os.environ.get(DISTRIBUTED_ENV, "auto")
    if flag == "0":
        return False
    num_nodes = ctx.num_workers
    if num_nodes <= 1:
        return False
    from tensorflowonspark_torch import chip_info, util

    if flag != "1" and chip_info.get_num_host_chips() == 0:
        logger.info(
            "multi-node cluster on card-less hosts: skipping "
            "torch.distributed (set %s=1 to force)", DISTRIBUTED_ENV)
        return False

    import torch
    import torch.distributed as dist

    device = util.select_device()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ids = sorted(m["executor_id"] for m in ctx.cluster_info)
    rank = ids.index(ctx.executor_id)
    addr = master_address(ctx)
    timeout_s = int(os.environ.get("TFOS_TORCH_DISTRIBUTED_TIMEOUT", "300"))
    logger.info("torch.distributed.init_process_group(%s, tcp://%s, "
                "world_size=%d, rank=%d)", backend, addr, num_nodes, rank)
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num_nodes, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    return True

