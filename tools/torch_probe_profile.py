#!/usr/bin/env python3
"""Where the serving health probe's seconds go, on one card.

Run from the repository root on a machine with an NVIDIA card:
``python3 tools/torch_probe_profile.py [--rounds N]``.  It prints the
card's name and power limit, then, ``N`` rounds in turns, the wall of:

- ``spawn``: a spawned child that runs nothing (interpreter start and the
  re-import of this script as the child's main module);
- ``import``: a child that imports ``torch``;
- ``context``: a child that imports ``torch`` and makes the card's context;
- ``matmul``: a child that checks the card through ``torch`` (a 128² bf16
  matmul on the card, synchronised, its sum on the host), each step
  stamped inside the child (import, context, first matmul, ``.item()``);
- ``probe``: ``health.probe_chip_health()`` itself, from this process
  (a fresh interpreter that imports no ``torch`` and runs the probe's
  kernel through the CUDA driver API);
- ``probe_busy``: the same after this process made its own context and
  holds 8 GiB of the card, as a serving executor does once its model is
  loaded.

The medians go on the last line as JSON; ``--out`` writes every sample
there too.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
torch.cuda.init()
torch.zeros(1, device="cuda")
t2 = time.perf_counter()
if MODE == "matmul":
    x = torch.ones((128, 128), dtype=torch.bfloat16, device="cuda")
    y = (x @ x).float().sum()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    assert y.item() == 128.0 ** 3
    t4 = time.perf_counter()
    print(f"{t1 - t0} {t2 - t1} {t3 - t2} {t4 - t3}")
else:
    print(f"{t1 - t0} {t2 - t1}")
"""


def _nothing() -> None:
    pass


def timed_child(mode: str) -> tuple[float, list[float]]:
    """Wall of a fresh interpreter running :data:`_CHILD` in ``mode``
    (``import`` stops after ``import torch``), and its own stamps."""
    code = ("import torch" if mode == "import"
            else f"MODE = {mode!r}\n" + _CHILD)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    wall = time.perf_counter() - t0
    return wall, [float(v) for v in out.split()]


def timed_spawn() -> float:
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    p = ctx.Process(target=_nothing)
    p.start()
    p.join()
    return time.perf_counter() - t0


def timed_probe() -> float:
    from tensorflowonspark_torch import health

    t0 = time.perf_counter()
    reason = health.probe_chip_health()
    if reason:
        raise SystemExit(f"probe failed: {reason}")
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    samples: dict[str, list] = {k: [] for k in (
        "spawn", "import", "context", "matmul", "probe", "probe_busy")}
    stamps: list = []
    for r in range(args.rounds):
        samples["spawn"].append(timed_spawn())
        samples["import"].append(timed_child("import")[0])
        samples["context"].append(timed_child("context")[0])
        wall, inside = timed_child("matmul")
        samples["matmul"].append(wall)
        stamps.append(inside)
        samples["probe"].append(timed_probe())
        print(f"round {r}: " + ", ".join(
            f"{k} {v[-1]:.3f} s" for k, v in samples.items() if v)
            + " (inside the matmul child: import, context, matmul, item "
            + ", ".join(f"{v:.3f}" for v in inside) + " s)", flush=True)
    import torch

    held = torch.empty(8 << 30, dtype=torch.uint8, device="cuda")
    for r in range(args.rounds):
        samples["probe_busy"].append(timed_probe())
    del held
    print("probe with 8 GiB held here: " + ", ".join(
        f"{v:.3f}" for v in samples["probe_busy"]) + " s", flush=True)
    medians = {k: statistics.median(v) for k, v in samples.items() if v}
    medians["inside_matmul_child"] = [statistics.median(c) for c in
                                      zip(*stamps)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "samples": samples, "stamps": stamps,
                       "medians": medians}, f, indent=1)
    print(json.dumps({"card": card, "medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
