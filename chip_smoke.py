#!/usr/bin/env python3
"""Drive the PyTorch port (``tensorflowonspark_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card (built for ``sm_90a``: an H100), the CUDA toolkit
(``nvcc``) and nothing of JAX.  Phases, each of which fails the run:

1. Print the card's name and power limit; build every kernel from
   ``tensorflowonspark_torch/csrc`` (timed).
2. Kernel phase: ``group_norm_act`` against its plain PyTorch twin at every
   (shape, mode) the ResNet-50 forward gives it, in bf16, at batch 32 (the
   serving slice's), 64 (the training slice's) and 256 (where the device
   is the limit), on the one-pass cluster path; then one oversize case
   (a 224² sample of 64 channels) on the two-pass path.  Each case: the
   path it took, max abs error against the stated tolerance, the same bits
   from two runs, then the kernel's, the plain twin's (batches 32 and 64)
   and one PyTorch call's (``F.group_norm`` → add →
   ReLU, a yardstick the port never calls) times with CUDA events, beside
   the least time the card could take (``bound_ms``); and the wrapper's
   host time per call.
3. Model phase: full ``Config()`` ResNet-50 at 224², bf16, seeded weights.
   Kernel path against the plain path and against an f32 forward (TF32
   off), exactly 53 one-pass and no two-pass launches per forward,
   images/s at batch 256 and its device time by kernel family.
4. Serving slice, the first slice's main path: export the weights, then
   ``TFModel.transform`` on a local-substrate DataFrame (127 rows, 3 ragged
   partitions, ``local[1]``) on the card, checking the scores against an
   in-process forward, the executor's kernel launches and the shape
   signatures it saw.  rows/s.
5. Backward-kernel phase: the backward of ``group_norm_act`` against its
   plain twin (``group_norm_act_backward_plain``) at every (shape, mode)
   of the forward, at batches 32, 64 and 256, on the one-pass cluster
   path (its cluster and whether x stays in shared memory printed per
   case); then the oversize case on the four-launch path.  Each case: the
   training forward's output and (mean, rstd) against the plain twin's;
   dx and d_residual within 2 bf16 ulps, dγ and dβ within a relative L2,
   the same bits twice, one wrapper call counted on its planned path a
   call; the kernel's, the plain twin's (batches 32 and 64) and one
   PyTorch call's times (autograd of bf16 ``F.group_norm`` → add → ReLU,
   a yardstick the port never calls) beside ``bound_ms``; the four-launch
   kernels forced at the same shape, checked the same way and timed in
   turns with the one pass; and the backward wrapper's host time per call.
6. Training-model phase: full ``Config()`` ResNet-50 at 224².  One step's
   gradients on the kernel path against the plain path (both bf16) and an
   f32 plain model (TF32 off); the backward alone (kernel forward under
   the kernel and under the plain backward), with two planted faults that
   its gate must catch; every gradient finite and nonzero; exactly 53
   forward and 53 backward launches a step; 8 AdamW steps on one batch,
   kernel against plain, with a falling loss; train-step images/s at batch
   256 (CUDA events), peak memory, and the step's device time by family.
7. Training slice, the ResNet main path: ``TFCluster.run`` (one
   executor, ``InputMode.SPARK``) → ``cluster.train`` over 256 rows of 224²
   images in 4 partitions → ``DataFeed.next_batch(device_put=
   trainer.shard)`` → 4 ``Trainer.step``s at batch 64 → ``shutdown``.  The
   final loss against an in-process ``Trainer`` on the same batches, the
   executor's forward and backward launches, and the cluster's images/s.
8. Table-kernel phase: the table path of ``embedding`` on the full
   ``widedeep.Config()`` tables (2.6 M rows; deep rows of 32 f32, wide rows
   scalar) at batch 1024 (26,624 ids), both modes, every case from the same
   seeded tables: the step's deep and wide pair in one launch
   (``sparse_adagrad_update_tables``) for uniform, Zipf(1.1), int64,
   8-rank all-gathered Zipf (212,992 ids) and all-equal ids, and deep and
   wide alone (``sparse_adagrad_update``) for uniform and Zipf ids.  Each
   case: the grouping kernel against ``sort_ids`` bit for bit; the update
   bit for bit the plain version run on the CPU (on the touched rows, ids
   remapped onto them) and within ``TABLE_TOL_REL`` of the plain version
   on the card (its atomic order printed, not gated, where one row takes
   every occurrence); untouched rows bit-identical, the same bits twice,
   one grouping and one update launch a call.  Times: the grouping's,
   ``torch.sort``'s (the library call) and the plain grouping's, the
   update's, the whole path's (CUDA events) and each kernel's device time
   (CUPTI), the plain version's and the literal dense path's, beside
   ``bound_ms``; the path's host time a call.
9. Training-model phase, wide&deep: ``Trainer("wide_deep", Config())`` at
   batch 1024 on a device-resident batch, both ``table_update`` modes.  One
   step's MLP gradients and tables bit for bit the same step with the
   plain table update run on the CPU (which adds each row's occurrences in
   batch order, as the kernel does); 20 steps on ``synth_criteo`` rows
   with a falling loss and one grouping and one update launch a step;
   steps/s (CUDA events), peak memory and the step's device time by family
   (the grouping, the update and any sort named apart).
10. Wide&deep slice, this slice's main path, once per mode: ``TFEstimator(
   criteo_train_fn).fit(df)`` (a port of ``examples/criteo/
   criteo_pipeline.py::train_fun``; one executor on the card, 8,192 rows in
   4 partitions, batch 1024) → ``TFCluster.run`` → ``cluster.train`` →
   ``DataFeed.next_batch(device_put=...)`` → 8 ``Trainer.step``s →
   ``trainer.export``; then ``TFModel.transform`` of the export.  The
   executor's table launches (one grouping and one update a step), its
   losses against an in-process replay, the scores against an in-process
   forward of the exported weights, and steps/s by ``cluster.metrics()``.

The last lines are the card line, one JSON line listing each kernel (the
one-pass and two-pass forwards of ``group_norm_act`` and its one-pass and
four-launch backwards, times at the training slice's batch and under
``_b32``/``_b256`` at the others; the table path's id grouping, and its
update in each mode, times of a training step's pair on Zipf ids, the
other cases suffixed), and ``{"ok": true, "device": {...}}``.
Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50e6
KERNEL_BATCH = 32
MODEL_BATCH = 256
SLICE_ROWS = 127
SLICE_BATCH = 32
OVERSIZE_SHAPE = (2, 64, 224, 224)  # 6.4 MB a sample: beyond 8 blocks

# stated tolerances
KERNEL_TOL_ULPS = 2  # |kernel - plain| <= 2 bf16 ulps of max(1, max|plain|)
LOGITS_KERNEL_VS_PLAIN = 1e-2  # rel L2, bf16 both: rounding flips only
LOGITS_BF16_VS_F32 = 3e-2  # rel L2, bf16 vs f32 forward (CPU measured 7e-3)
SLICE_VS_IN_PROCESS = 1e-3  # rel L2, same kernels, weights and batches
BWD_PARAM_REL_L2 = 1e-3  # dγ, dβ: f32 sums over N·H·W in another order
# the training forward's (mean, rstd) against the plain twin's, abs, of
# max(1, |plain|): f32 sums over H·W·C/G in another order
STATS_TOL = 1e-4
# one step's gradients, rel L2 over all parameters.  Measured on the CPU at
# full width, 64², batch 4 (tests/test_torch_train.py, the full-width
# test): bf16 vs f32 0.46, the rounding of 53 bf16 layers amplified
# through a random-init network.  On the card (224², batch 8) the kernel
# path and the plain path, both bf16, differ by 0.146 and each from f32 by
# about 0.2: two bf16 paths are held to each other, and the kernel path to
# f32, as closely as the plain bf16 path is to f32
GRADS_BF16_VS_F32 = 0.75
GRADS_VS_F32_OVER_PLAIN = 1.25  # <= this x plain-vs-f32 + 0.02
# the backward alone: one step's gradients with the kernel forward and the
# kernel backward against the kernel forward and the plain backward.  The
# ReLU masks and statistics are the same, so the gap is the bf16 rounding
# of dx at 53 sites carried linearly down the net, and cuDNN's
# nondeterministic weight gradients: predicted ~1e-2 before the first
# card run.  Each planted fault (a centering term of dx dropped at every
# site) must read above it.
GRADS_SAME_FORWARD = 5e-2
# 8 AdamW steps (lr 1e-4) on one batch: |kernel - plain| <= this x the
# first loss at every step (CPU, 64², batch 4, the same test: 7.0e-4), and
# the last loss below half the first
TRAJECTORY_TOL = 0.02
TRAIN_STEPS = 8
TRAIN_LR = 1e-4
TRAIN_GRAD_BATCH = 8
SLICE_TRAIN_ROWS = 256
SLICE_TRAIN_PARTITIONS = 4
SLICE_TRAIN_BATCH = 64
SLICE_TRAIN_VS_IN_PROCESS = 1e-2  # rel, final loss: cuDNN weight grads
# (batch, (kernel, plain, library) timed calls): the serving slice's batch,
# the training slice's (the main path: the JSON line's unsuffixed numbers)
# and the rate's
FWD_BATCH_CALLS = ((KERNEL_BATCH, (50, 20, 20)),
                   (SLICE_TRAIN_BATCH, (30, 10, 10)),
                   (MODEL_BATCH, (20, 0, 5)))
BWD_BATCH_CALLS = ((KERNEL_BATCH, (30, 10, 10)),
                   (SLICE_TRAIN_BATCH, (20, 5, 5)),
                   (MODEL_BATCH, (10, 0, 3)))

# wide&deep (phases 8-10)
WD_BATCH = 1024
WD_ZIPF = 1.1  # Criteo's categorical features are heavy-tailed
WD_LR = 1e-3  # AdamW on the MLP; the tables take 10x (Config's table_lr)
WD_STEPS = 20
WD_SLICE_ROWS = 8192
WD_SLICE_PARTITIONS = 4
WD_MODES = (("dense", "combine"), ("sparse", "sparse"))  # table_update, path
# |kernel - plain| <= this x max|plain| over the touched rows, table and
# accumulator: f32, and only the order of the duplicates' sums differs
# (the plain version's index_add_ adds them with atomics) besides
# torch.rsqrt's <= 2 ulps against the kernel's rn(1/rn(sqrt)).  The plain
# version run on the CPU adds in batch order, as the kernels do: against
# it every case is held bit for bit.  Where one row takes all 26,624
# occurrences, an f32 sum in any order sits about sqrt(n) * 2^-24 = 1e-5
# of the sum from the exact one (2e-5 of its square, the accumulator), so
# there the atomic order's distance is printed, not gated
TABLE_TOL_REL = 1e-5
# the design the table path replaced (a stable torch.sort of the ids, then
# one launch a table walking the sorted ids): device ms on an H100 80GB
# HBM3 at 700 W, from this script's phase 8 before the redesign
REPLACED_MS = {"sort": 0.044, "deep_uniform": 0.0078,
               "wide_uniform": 0.0029, "deep_zipf": 0.0296,
               "wide_zipf": 0.0237}
# one step's MLP gradients and params, kernel path against plain table
# update, rel L2: the table update does not reach them in the step, so
# only cuBLAS could differ
WD_MLP_REL = 1e-6
# the 20-step mean of the last 5 losses against the first loss
WD_FALL = 0.97
WD_SLICE_VS_REPLAY = 1e-5  # rel, every loss: same kernels and batches
WD_SCORES_VS_FORWARD = 1e-5  # max abs, probabilities


def launch_counts(**counts) -> dict:
    """A full ``launches_by_path`` dictionary: ``counts``, 0 elsewhere."""
    from tensorflowonspark_torch.kernels import group_norm

    return {**dict.fromkeys(group_norm.launches_by_path, 0), **counts}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, calls: int) -> float:
    """Mean ms of ``fn()`` over ``calls`` launches, CUDA events, warmed."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def rel_err(a, b) -> float:
    import torch

    return float(torch.linalg.norm((a - b).float())
                 / torch.linalg.norm(b.float()))


def record_sites(model, image_size: int) -> list[tuple]:
    """(C, H, W, groups, residual?, relu) of every norm call of one forward,
    in order, from the real model (run with the plain twin)."""
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    sites = []

    def recorder(x, gamma, beta, groups, eps, residual=None, relu=True):
        sites.append((*x.shape[1:], groups, residual is not None, relu))
        return group_norm.group_norm_act_plain(x, gamma, beta, groups, eps,
                                               residual, relu)

    model.norm_act = recorder
    try:
        with torch.inference_mode():
            model(torch.zeros(1, image_size, image_size, 3, device="cuda"))
    finally:
        model.norm_act = group_norm.group_norm_act
    return sites


def draw_case(shape, res: bool, seed: int, copies: int):
    """Seeded bf16 ``channels_last`` inputs: ``copies`` x (and residual)
    tensors, and f32 gamma/beta."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]

    def draw():
        return (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
                ).to(torch.bfloat16).contiguous(
                    memory_format=torch.channels_last)

    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    xs = [draw() for _ in range(copies)]
    rs = [draw() if res else None for _ in range(copies)]
    return xs, rs, gamma, beta


def measure_case(shape, groups: int, res: bool, relu: bool, seed: int,
                 path: str, kernel_calls: int, plain_calls: int,
                 library_calls: int) -> dict:
    """One (shape, mode) of ``group_norm_act``: checks it took ``path``,
    agrees with its plain twin within ``KERNEL_TOL_ULPS`` and gives the same
    bits twice, then times kernel, plain twin (if ``plain_calls``) and
    library call with CUDA events beside the bound."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.kernels import group_norm

    n, c, h, w = shape
    act_bytes = n * c * h * w * 2
    call_bytes = act_bytes * (3 if res else 2) + 2 * c * 4
    # rotate over copies so the working set is 4x L2: each launch
    # reads its inputs from device memory, as after a large conv
    copies = min(64, max(2, math.ceil(4 * L2_BYTES / call_bytes)))
    xs, rs, gamma, beta = draw_case(shape, res, seed, copies)
    ref = group_norm.group_norm_act_plain(xs[0], gamma, beta, groups, 1e-6,
                                          rs[0], relu)
    before = dict(group_norm.launches_by_path)
    out = group_norm.group_norm_act(xs[0], gamma, beta, groups, 1e-6, rs[0],
                                    relu)
    again = group_norm.group_norm_act(xs[0], gamma, beta, groups, 1e-6,
                                      rs[0], relu)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in group_norm.launches_by_path.items()}
    err = float((out.float() - ref.float()).abs().max())
    tol = KERNEL_TOL_ULPS * 2.0 ** -7 * max(1.0, float(ref.abs().max()))
    identical = bool(torch.equal(out, again))
    ok = (err <= tol and identical and took[path] == 2
          and sum(took.values()) == 2
          and out.is_contiguous(memory_format=torch.channels_last))
    del ref, again

    turn = [0]

    def cycle(fn):
        def call():
            k = turn[0] = (turn[0] + 1) % copies
            return fn(xs[k], rs[k])
        return call

    kernel_ms = time_ms(cycle(lambda x, r: group_norm.group_norm_act(
        x, gamma, beta, groups, 1e-6, r, relu)), kernel_calls)
    plain_ms = time_ms(cycle(lambda x, r: group_norm.group_norm_act_plain(
        x, gamma, beta, groups, 1e-6, r, relu)), plain_calls) if plain_calls \
        else None
    g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

    def library(x, r):
        y = F.group_norm(x, groups, g16, b16, 1e-6)
        if r is not None:
            y = y + r
        return torch.relu(y) if relu else y

    library_ms = time_ms(cycle(library), library_calls)
    ops = n * c * h * w * (6 + int(res) + int(relu))
    bytes_ms = call_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    mode = "GN" + ("+add" if res else "") + ("+ReLU" if relu else "")
    case = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    plain = "-" if plain_ms is None else f"{plain_ms:.4f}"
    print(f"kernel group_norm_act {n}x{h}x{w}x{c} G={groups} {mode:11s} "
          f"{path} took={took} max_abs_err={err:.3e} (tol {tol:.3e}) "
          f"same_bits_twice={identical} kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain} library_ms={library_ms:.4f} "
          f"bound_ms={case['bound_ms']:.4f} "
          f"kernel/bound={kernel_ms / case['bound_ms']:.2f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"group_norm_act at {shape} {mode}: path {took} "
                         f"(want 2 on {path}), error {err} (tol {tol}), "
                         f"same bits twice {identical}")
    return case


def host_us(call, calls: int = 400) -> float:
    """Host time per ``call()`` (a wrapper's checks, plan, allocation and
    launch), from the host clock around ``calls`` calls, without waiting
    for the device."""
    import torch

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def wrapper_host_us(shape, groups: int) -> float:
    """Host µs per ``group_norm_act`` call at a small shape."""
    from tensorflowonspark_torch.kernels import group_norm

    xs, _, gamma, beta = draw_case(shape, False, 0, 1)
    return host_us(lambda: group_norm.group_norm_act(xs[0], gamma, beta,
                                                     groups, 1e-6))


def _by_batch(totals: dict) -> dict:
    """The totals at the main path's batch, and the others under keys
    suffixed ``_b<batch>``."""
    return {**totals[SLICE_TRAIN_BATCH],
            **{f"{k}_b{b}": v for b, tot in totals.items()
               if b != SLICE_TRAIN_BATCH for k, v in tot.items()}}


def kernel_phase(sites: list[tuple]) -> dict:
    """Every (shape, mode) of the forward at the batches of the serving
    slice, the training slice and the rate (one-pass path), then the
    oversize two-pass case."""
    counts = collections.Counter(sites)
    totals = {b: collections.Counter() for b, _ in FWD_BATCH_CALLS}
    cases = []
    for i, ((c, h, w, groups, res, relu), per_fwd) in enumerate(
            counts.items()):
        for batch, calls in FWD_BATCH_CALLS:
            case = measure_case((batch, c, h, w), groups, res, relu, i,
                                "one_pass", *calls)
            case["per_fwd"] = per_fwd
            cases.append(case)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                if case[key] is not None:
                    totals[batch][key] += per_fwd * case[key]
    for batch, tot in totals.items():
        print(f"kernel group_norm_act one_pass per ResNet-50 forward at batch "
              f"{batch} ({len(sites)} calls, {len(counts)} shapes): "
              + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
              + f" kernel/bound={tot['ms'] / tot['bound_ms']:.2f}",
              flush=True)
    host_us = wrapper_host_us((KERNEL_BATCH, 512, 7, 7), 32)
    print(f"kernel group_norm_act wrapper host time per call "
          f"({KERNEL_BATCH}x7x7x512): {host_us:.1f} us", flush=True)
    oversize = measure_case(OVERSIZE_SHAPE, 32, True, True, 99, "two_pass",
                            20, 5, 5)
    bound_by = collections.Counter(c["bound_by"] for c in cases)
    return {"one_pass": {
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **_by_batch(totals), "bound_by": bound_by.most_common(1)[0][0],
        "wrapper_host_us": host_us},
        "two_pass": oversize}


def model_phase(model, f32_model) -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    images = torch.from_numpy(np.random.RandomState(0).rand(
        8, 224, 224, 3).astype(np.float32)).cuda()
    with torch.inference_mode():
        group_norm.reset_launches()
        kernel_logits = model(images)
        torch.cuda.synchronize()
        per_forward = dict(group_norm.launches_by_path)
        model.norm_act = group_norm.group_norm_act_plain
        try:
            plain_logits = model(images)
        finally:
            model.norm_act = group_norm.group_norm_act
        f32_logits = f32_model(images)
    vs_plain = rel_err(kernel_logits, plain_logits)
    vs_f32 = rel_err(kernel_logits, f32_logits)
    finite = bool(torch.isfinite(kernel_logits).all())
    top1 = float((kernel_logits.argmax(1) == f32_logits.argmax(1))
                 .float().mean())
    print(f"model resnet50 224x224 bf16 GroupNorm: logits "
          f"{tuple(kernel_logits.shape)} {kernel_logits.dtype} finite={finite}"
          f" rel_err kernel-vs-plain={vs_plain:.3e} (tol "
          f"{LOGITS_KERNEL_VS_PLAIN}) kernel-vs-f32={vs_f32:.3e} (tol "
          f"{LOGITS_BF16_VS_F32}) top1_agree_f32={top1:.3f} "
          f"launches/forward={per_forward}", flush=True)
    if (kernel_logits.shape != (8, 1000) or kernel_logits.dtype != torch.float32
            or not finite or vs_plain > LOGITS_KERNEL_VS_PLAIN
            or vs_f32 > LOGITS_BF16_VS_F32
            or per_forward != launch_counts(one_pass=53)):
        raise SystemExit("model phase failed")

    batch = torch.rand(MODEL_BATCH, 224, 224, 3, device="cuda")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(batch), 10)
    ips = MODEL_BATCH / fwd_ms * 1e3
    print(f"model resnet50 forward batch {MODEL_BATCH}: {fwd_ms:.3f} ms, "
          f"{ips:.1f} images/s", flush=True)
    profile_forward(model, batch, fwd_ms)
    return {"images_per_s": ips, "forward_ms": fwd_ms}


#: a ``record_function`` name (``Optimizer.step#AdamW.step``); kernel names
#: hold ``#`` only inside C++ lambdas (``{lambda(int)#1}``), with spaces
_ANNOTATION = re.compile(r"^[\w.]+#[\w.]+$")


def device_kernels(prof, calls: int):
    """``(name, ms per call)`` of every kernel ``prof`` (a torch.profiler
    run over ``calls`` calls) saw on the card.  The GPU spans of user
    annotations (``Optimizer.step#AdamW.step``) are CUDA events too, but
    cover kernels already counted: they are left out."""
    import torch

    for e in prof.events():
        if (getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or _ANNOTATION.match(e.name)):
            continue  # a host-side op, or an annotation's span
        yield e.name, e.time_range.elapsed_us() / 1e3 / calls


def profile_forward(model, batch, fwd_ms: float, forwards: int = 3) -> None:
    """Device time per forward by kernel family (torch.profiler, CUPTI):
    the fused norm's kernels, convolutions, everything else, and the
    device's idle share against the event-timed forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            model(batch)
        torch.cuda.synchronize()
    fams, others = collections.Counter(), collections.Counter()
    for kernel, ms in device_kernels(prof, forwards):
        name = kernel.lower()
        fam = next((k for k in ("gn_one_pass", "gn_stats", "gn_finalize",
                                "gn_apply")
                    if k in name), None)
        if fam is None:
            fam = "conv" if any(k in name for k in (
                "conv", "fprop", "xmma", "gemm", "cudnn", "implicit",
                "cutlass")) else "other"
        fams[fam] += ms
        if fam == "other":
            others[kernel[:60]] += ms
    busy = sum(fams.values())
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    parts = " ".join(f"{k}={v:.3f}ms({v / busy:.1%})"
                     for k, v in fams.most_common())
    print(f"profile resnet50 forward batch {MODEL_BATCH}, device ms per "
          f"forward: busy={busy:.3f} of {fwd_ms:.3f} "
          f"(idle share {max(0.0, 1 - busy / fwd_ms):.1%}); {parts}",
          flush=True)
    print("profile largest 'other' kernels: " + "; ".join(
        f"{name}={ms:.3f}ms" for name, ms in others.most_common(6)),
        flush=True)


def _reset_launches(_):
    from tensorflowonspark_torch.kernels import group_norm

    group_norm.reset_launches()
    return [0]


def _executor_state(_):
    from tensorflowonspark_torch import serving
    from tensorflowonspark_torch.kernels import group_norm

    return [(dict(group_norm.launches_by_path),
             {k: sorted(v) for k, v in serving._SEEN_SHAPES.items()})]


def slice_phase(model) -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch import compat, pipeline, shapes, sparkapi
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet

    export_dir = tempfile.mkdtemp(prefix="tfos_torch_smoke_")
    compat.export_saved_model(resnet.state_of(model), export_dir)
    images = np.random.RandomState(1).rand(
        SLICE_ROWS, 224, 224, 3).astype(np.float32)
    sc = sparkapi.LocalSparkContext("local[1]")
    try:
        spark = sparkapi.LocalSparkSession(sc)
        df = spark.createDataFrame(
            [{"id": i, "image": images[i]} for i in range(SLICE_ROWS)]
        ).repartition(3)
        sizes = [len(p) for p in df.rdd._partitions]
        tfmodel = (pipeline.TFModel(device="cuda").setModelName("resnet50")
                   .setExportDir(export_dir).setBatchSize(SLICE_BATCH)
                   .setBucketSizes([SLICE_BATCH])
                   .setInputMapping({"image": "image"}))
        sc.parallelize([0], 1).mapPartitions(_reset_launches).collect()
        group_norm.reset_launches()
        t0 = time.perf_counter()
        out = tfmodel.transform(df).collect()
        seconds = time.perf_counter() - t0
        driver_launches = dict(group_norm.launches_by_path)
        [(exec_launches, seen)] = sc.parallelize([0], 1).mapPartitions(
            _executor_state).collect()
        # again, with the model loaded and the kernel built on both sides
        t0 = time.perf_counter()
        warm_rows = len(tfmodel.transform(df).collect())
        warm_seconds = time.perf_counter() - t0
    finally:
        sc.stop()
        shutil.rmtree(export_dir, ignore_errors=True)

    # collect() returns rows in partition order on the local substrate, so
    # row i scores image id i; the reference forward batches like the
    # executor (32-row chunks of each partition, padded to the bucket)
    scores = torch.tensor([r.prediction for r in out])
    ref, start = [], 0
    with torch.inference_mode():
        for size in sizes:
            for lo in range(start, start + size, SLICE_BATCH):
                n = min(SLICE_BATCH, start + size - lo)
                chunk = np.zeros((SLICE_BATCH, 224, 224, 3), np.float32)
                chunk[:n] = images[lo:lo + n]
                ref.append(model(torch.from_numpy(chunk).cuda())[:n].cpu())
            start += size
    ref = torch.cat(ref)
    err = rel_err(scores, ref)
    want = {tuple(shapes.enumerate_signatures(
        {"image": ((224, 224, 3), np.float32)}, [SLICE_BATCH]))}
    got = {tuple(v) for v in seen.values()}
    rows_per_s = SLICE_ROWS / seconds
    warm_rows_per_s = SLICE_ROWS / warm_seconds
    print(f"slice TFModel.transform resnet50 on cuda: {len(out)} rows in "
          f"partitions {sizes}, {seconds:.3f} s, {rows_per_s:.2f} rows/s "
          f"(first, with the executor's load); again {warm_seconds:.3f} s, "
          f"{warm_rows_per_s:.2f} rows/s; "
          f"scores rel_err vs in-process={err:.3e} (tol {SLICE_VS_IN_PROCESS})"
          f"; executor launches={exec_launches} driver launches="
          f"{driver_launches}; executor signatures={len(seen)} model(s), "
          f"{[len(v) for v in seen.values()]} signature(s)", flush=True)
    if (len(out) != SLICE_ROWS or warm_rows != SLICE_ROWS
            or scores.shape != (SLICE_ROWS, 1000)
            or err > SLICE_VS_IN_PROCESS or exec_launches["one_pass"] <= 0
            or exec_launches["two_pass"] or driver_launches["two_pass"]
            or got != want or len(seen) != 1):
        raise SystemExit("slice phase failed")
    return {"launches": {k: exec_launches[k] + driver_launches[k]
                         for k in exec_launches},
            "rows_per_s": rows_per_s}


def measure_backward_case(shape, groups: int, res: bool, relu: bool,
                          seed: int, path: str, kernel_calls: int,
                          plain_calls: int, library_calls: int) -> dict:
    """The backward of one (shape, mode) of ``group_norm_act``: the
    training forward's output and ``(mean, rstd)`` against the plain twin's
    (within ``KERNEL_TOL_ULPS`` and ``STATS_TOL``); the plan takes
    ``path`` and each wrapper call counts once on it, dx and d_residual
    within ``KERNEL_TOL_ULPS`` of the plain twin, dγ and dβ within
    ``BWD_PARAM_REL_L2``, the same bits twice; then the kernel's, the plain
    twin's (if ``plain_calls``) and the library backward's times beside the
    bound.  On the one-pass path the four launches, forced at the same
    shape, pass the same checks against the plain twin and are timed in
    turns with it (one pass, four, four, one pass)."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.kernels import group_norm

    n, c, h, w = shape
    act_bytes = n * c * h * w * 2
    # read x, dy (and y, the ReLU mask); write dx (and d_residual)
    call_bytes = act_bytes * (2 + int(relu) + 1 + int(res)) + 4 * c * 4
    copies = min(64, max(2, math.ceil(4 * L2_BYTES / call_bytes)))
    xs, rs, gamma, beta = draw_case(shape, res, seed, copies)
    dys = draw_case(shape, False, seed + 1000, copies)[0]
    fwd = [group_norm._launch(xs[k], gamma, beta, groups, 1e-6, rs[k], relu,
                              keep_stats=True) for k in range(copies)]
    ys, stats = [f[0] for f in fwd], [f[1] for f in fwd]
    del fwd
    y_ref, stats_ref = group_norm._plain_forward(xs[0], gamma, beta, groups,
                                                 1e-6, rs[0], relu)
    y_err = float((ys[0].float() - y_ref.float()).abs().max())
    y_tol = KERNEL_TOL_ULPS * 2.0 ** -7 * max(1.0, float(y_ref.abs().max()))
    stats_err = float(((stats[0] - stats_ref).abs()
                       / stats_ref.abs().clamp(min=1.0)).max())
    del y_ref, stats_ref
    ref = group_norm.group_norm_act_backward_plain(
        dys[0], xs[0], ys[0], gamma, stats[0], groups, res, relu)
    plan = group_norm._plan_backward(n, h, w, c, groups)
    before = dict(group_norm.launches_by_path)
    out = group_norm._launch_backward(dys[0], xs[0], ys[0], gamma, stats[0],
                                      groups, res, relu)
    again = group_norm._launch_backward(dys[0], xs[0], ys[0], gamma,
                                        stats[0], groups, res, relu)
    torch.cuda.synchronize()
    took = {k: v - before[k] for k, v in group_norm.launches_by_path.items()}
    errs, tols, param_rels = [], [], []

    def check(got):
        for g, want in zip(got[:2], ref[:2]):
            if want is not None:
                errs.append(float((g.float() - want.float()).abs().max()))
                tols.append(KERNEL_TOL_ULPS * 2.0 ** -7
                            * max(1.0, float(want.float().abs().max())))
        param_rels.extend(
            float(torch.linalg.norm(g - w_) / torch.linalg.norm(w_))
            for g, w_ in zip(got[2:], ref[2:]))

    check(out)
    kernel_err = max(errs)
    identical = all(torch.equal(a, b) for a, b in zip(out, again)
                    if a is not None)
    four = None
    if path == "one_pass":  # the four launches' twin at the same shape
        four = group_norm._four_launch_plan(n, h, w, c)
        check(group_norm._launch_backward(dys[0], xs[0], ys[0], gamma,
                                          stats[0], groups, res, relu, four))
    param_rel = max(param_rels)
    ok = (all(e <= t for e, t in zip(errs, tols))
          and y_err <= y_tol and stats_err <= STATS_TOL
          and param_rel <= BWD_PARAM_REL_L2 and identical
          and (out[1] is not None) == res
          and plan.path == path
          and took == launch_counts(**{"backward_" + path: 2})
          and out[0].is_contiguous(memory_format=torch.channels_last))
    del ref, out, again

    turn = [0]

    def cycle(fn):
        def call():
            k = turn[0] = (turn[0] + 1) % copies
            return fn(k)
        return call

    def timed(plan_):
        return time_ms(cycle(lambda k: group_norm._launch_backward(
            dys[k], xs[k], ys[k], gamma, stats[k], groups, res, relu,
            plan_)), kernel_calls)

    kernel_ms = timed(None)
    four_ms = None
    if four is not None:
        four_ms = (timed(four) + timed(four)) / 2
        kernel_ms = (kernel_ms + timed(None)) / 2
    plain_ms = time_ms(cycle(lambda k: group_norm.group_norm_act_backward_plain(
        dys[k], xs[k], ys[k], gamma, stats[k], groups, res, relu)),
        plain_calls) if plain_calls else None

    # the yardstick: autograd of bf16 F.group_norm -> add -> ReLU, one
    # retained graph a copy
    graphs = []
    for k in range(copies):
        x = xs[k].detach().requires_grad_()
        r = rs[k].detach().requires_grad_() if res else None
        g16 = gamma.to(torch.bfloat16).requires_grad_()
        b16 = beta.to(torch.bfloat16).requires_grad_()
        y = F.group_norm(x, groups, g16, b16, 1e-6)
        if res:
            y = y + r
        if relu:
            y = torch.relu(y)
        graphs.append((y, [t for t in (x, r, g16, b16) if t is not None]))
    library_ms = time_ms(cycle(lambda k: torch.autograd.grad(
        graphs[k][0], graphs[k][1], dys[k], retain_graph=True)),
        library_calls)
    del graphs
    bytes_ms = call_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * c * h * w * (14 + 2 * int(res) + int(relu)) \
        / F32_OPS_PER_S * 1e3
    mode = "GN" + ("+add" if res else "") + ("+ReLU" if relu else "")
    case = {"max_abs_err": kernel_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    if four_ms is not None:
        case["four_launch_ms"] = four_ms
    plain = "-" if plain_ms is None else f"{plain_ms:.4f}"
    four_s = "" if four_ms is None else f"four_launch_ms={four_ms:.4f} "
    print(f"backward group_norm_act {n}x{h}x{w}x{c} G={groups} {mode:11s} "
          f"path={plan.path} cluster={plan.cluster} "
          f"x_resident={plan.x_resident} forward y_err={y_err:.3e} "
          f"(tol {y_tol:.3e}) stats_err={stats_err:.2e} (tol {STATS_TOL}) "
          f"took={took} max_abs_err={kernel_err:.3e} (tol {min(tols):.3e}) "
          f"dgamma/dbeta rel_l2={param_rel:.2e} (tol {BWD_PARAM_REL_L2}) "
          f"same_bits_twice={identical} kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain} library_ms={library_ms:.4f} {four_s}"
          f"bound_ms={case['bound_ms']:.4f} "
          f"kernel/bound={kernel_ms / case['bound_ms']:.2f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"group_norm_act backward at {shape} {mode}: "
                         f"forward y {y_err} (tol {y_tol}), stats "
                         f"{stats_err}, "
                         f"launches {took}, errors {errs} (tol {tols}), "
                         f"dgamma/dbeta {param_rel}, same bits {identical}")
    return case


def backward_wrapper_host_us(shape, groups: int) -> float:
    """Host µs per backward wrapper call at a small shape, GN+add+ReLU."""
    from tensorflowonspark_torch.kernels import group_norm

    xs, rs, gamma, beta = draw_case(shape, True, 0, 1)
    dy = draw_case(shape, False, 1, 1)[0][0]
    y, stats = group_norm._launch(xs[0], gamma, beta, groups, 1e-6, rs[0],
                                  True, keep_stats=True)
    return host_us(lambda: group_norm._launch_backward(
        dy, xs[0], y, gamma, stats, groups, True, True))


def backward_phase(sites: list[tuple]) -> dict:
    """The backward at every (shape, mode) of the forward, at the batches
    of the kernel phase (one-pass path); totals per training step; the
    wrapper's host time; then the oversize four-launch case."""
    counts = collections.Counter(sites)
    totals = {b: collections.Counter() for b, _ in BWD_BATCH_CALLS}
    errs = []
    for i, ((c, h, w, groups, res, relu), per_step) in enumerate(
            counts.items()):
        for batch, calls in BWD_BATCH_CALLS:
            case = measure_backward_case((batch, c, h, w), groups, res, relu,
                                         i, "one_pass", *calls)
            errs.append(case["max_abs_err"])
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "four_launch_ms"):
                if case.get(key) is not None:
                    totals[batch][key] += per_step * case[key]
    for batch, tot in totals.items():
        print(f"backward group_norm_act one_pass per ResNet-50 training step "
              f"at batch {batch} ({len(sites)} calls, {len(counts)} shapes): "
              + " ".join(f"{k}={v:.4f}" for k, v in tot.items())
              + f" kernel/bound={tot['ms'] / tot['bound_ms']:.2f}",
              flush=True)
    host_us = backward_wrapper_host_us((KERNEL_BATCH, 512, 7, 7), 32)
    print(f"backward group_norm_act wrapper host time per call "
          f"({KERNEL_BATCH}x7x7x512): {host_us:.1f} us", flush=True)
    oversize = measure_backward_case(OVERSIZE_SHAPE, 32, True, True, 99,
                                     "four_launch", 20, 5, 5)
    return {"backward_one_pass": {
        "max_abs_err": max(errs), **_by_batch(totals), "bound_by": "bytes",
        "wrapper_host_us": host_us},
        "backward_four_launch": oversize}


def _grads(model, loss_fn, batch, norm_act, backward=None):
    """One backward's gradients (f32 copies), the loss and the kernel
    launches it made.  ``backward``, if given, stands in for the backward
    kernel's wrapper for this one step."""
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    model.norm_act = norm_act
    model.zero_grad(set_to_none=True)
    kernel_backward = group_norm._launch_backward
    group_norm._launch_backward = backward or kernel_backward
    try:
        group_norm.reset_launches()
        loss = loss_fn(model, batch)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        group_norm._launch_backward = kernel_backward
    launches = dict(group_norm.launches_by_path)
    grads = {k: p.grad.detach().float().clone()
             for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    model.norm_act = group_norm.group_norm_act
    return grads, float(loss.detach()), launches


def _planted_fault(drop: str):
    """The backward kernel's wrapper with a fault planted in its dx: the
    centering term ``x̂·mean_M(dz·γ·x̂)`` (``drop="projection"``) or both
    centering terms (``drop="centering"``, as if the per-group
    coefficients were zero) of ``dx = rstd·(dz·γ − mean_M(dz·γ) −
    x̂·mean_M(dz·γ·x̂))`` added back, in f32, at every site."""
    from tensorflowonspark_torch.kernels import group_norm

    kernel_backward = group_norm._launch_backward

    def backward(dy, x, y, gamma, stats, groups, residual, relu):
        dx, *rest = kernel_backward(dy, x, y, gamma, stats, groups,
                                    residual, relu)
        n, c, h, w = x.shape
        dz = dy.permute(0, 2, 3, 1).float()
        if relu:
            dz = dz * (y.permute(0, 2, 3, 1) > 0)
        dz = dz.reshape(n, h * w, groups, c // groups)
        mean = stats[..., 0].reshape(n, 1, groups, 1)
        rstd = stats[..., 1].reshape(n, 1, groups, 1)
        xh = (x.permute(0, 2, 3, 1).float().reshape(dz.shape) - mean) * rstd
        dxh = dz * gamma.float().reshape(1, 1, groups, -1)
        add = rstd * xh * (dxh * xh).mean(dim=(1, 3), keepdim=True)
        if drop == "centering":
            add = add + rstd * dxh.mean(dim=(1, 3), keepdim=True)
        dx = (dx.permute(0, 2, 3, 1).float() + add.reshape(n, h, w, c))
        return (dx.to(x.dtype).permute(0, 3, 1, 2), *rest)

    return backward


def _rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return math.sqrt(num / den)


def train_model_phase() -> dict:
    import dataclasses

    import numpy as np
    import torch

    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    config = resnet.Config()
    rng = np.random.RandomState(3)

    def device_batch(n):
        return {"image": torch.from_numpy(rng.rand(
                    n, 224, 224, 3).astype(np.float32)).cuda(),
                "label": torch.from_numpy(rng.randint(
                    0, 1000, size=n)).cuda()}

    # one step's gradients: kernel path, plain path, f32 plain model
    model = resnet.make_model(config, seed=0).cuda()
    f32_model = resnet.load_state(
        resnet.make_model(dataclasses.replace(config, dtype="float32")),
        resnet.state_of(model)).cuda()
    batch = device_batch(TRAIN_GRAD_BATCH)
    loss_fn = resnet.make_loss_fn(model, config)
    g_kernel, loss_kernel, launches = _grads(model, loss_fn, batch,
                                             group_norm.group_norm_act)
    g_plain, loss_plain, plain_launches = _grads(
        model, loss_fn, batch, group_norm.group_norm_act_plain)
    g_f32, loss_f32, _ = _grads(f32_model, loss_fn, batch,
                                group_norm.group_norm_act_plain)
    # the backward alone: the kernel forward under the plain backward, and
    # under the kernel backward with a fault planted
    g_same, _, same_launches = _grads(
        model, loss_fn, batch, group_norm.group_norm_act,
        group_norm.group_norm_act_backward_plain)
    g_faults = {drop: _grads(model, loss_fn, batch, group_norm.group_norm_act,
                             _planted_fault(drop))[0]
                for drop in ("projection", "centering")}
    names = [k for k, _ in model.named_parameters()]
    del model, f32_model
    complete = sorted(g_kernel) == sorted(names)
    finite = all(bool(torch.isfinite(g).all()) for g in g_kernel.values())
    nonzero = [k for k, g in g_kernel.items() if float(g.abs().max()) > 0]
    vs_plain = _rel_l2(g_kernel, g_plain)
    vs_f32 = _rel_l2(g_kernel, g_f32)
    plain_vs_f32 = _rel_l2(g_plain, g_f32)
    loose_tol = GRADS_VS_F32_OVER_PLAIN * plain_vs_f32 + 0.02
    same_forward = _rel_l2(g_kernel, g_same)
    faults = {drop: (_rel_l2(g, g_same),
                     max(_rel_l2(g, g_plain), _rel_l2(g, g_f32)))
              for drop, g in g_faults.items()}
    print(f"train resnet50 224x224 bf16 one step at batch {TRAIN_GRAD_BATCH}:"
          f" loss kernel={loss_kernel:.5f} plain={loss_plain:.5f} "
          f"f32={loss_f32:.5f}; grads of {len(g_kernel)}/{len(names)} params,"
          f" finite={finite}, nonzero={len(nonzero)}; rel_l2 kernel-vs-plain="
          f"{vs_plain:.3e} kernel-vs-f32={vs_f32:.3e} plain-vs-f32="
          f"{plain_vs_f32:.3e} (tol: both <= {GRADS_VS_F32_OVER_PLAIN} x "
          f"plain-vs-f32 + 0.02, kernel-vs-f32 <= {GRADS_BF16_VS_F32}); "
          f"launches a step={launches} (plain path {plain_launches})",
          flush=True)
    print(f"train resnet50 backward alone: rel_l2 kernel-bwd-vs-plain-bwd "
          f"(kernel forward both)={same_forward:.3e} (tol "
          f"{GRADS_SAME_FORWARD}); launches {same_launches}; planted faults "
          + "; ".join(f"{drop} term dropped: vs plain-bwd={a:.3e} "
                      f"({'caught' if a > GRADS_SAME_FORWARD else 'MISSED'}),"
                      f" vs plain/f32={b:.3e} against the gate above "
                      f"{loose_tol:.3e} "
                      f"({'caught' if b > loose_tol else 'missed'})"
                      for drop, (a, b) in faults.items()), flush=True)
    del g_kernel, g_plain, g_f32, g_same, g_faults
    if (not complete or not finite or len(nonzero) != len(names)
            or vs_f32 > GRADS_BF16_VS_F32
            or max(vs_plain, vs_f32) > loose_tol
            or launches != launch_counts(one_pass=53, backward_one_pass=53)
            or sum(plain_launches.values())
            or same_forward > GRADS_SAME_FORWARD
            or same_launches != launch_counts(one_pass=53)
            or min(a for a, _ in faults.values()) <= GRADS_SAME_FORWARD):
        raise SystemExit("training-model phase failed (gradients)")

    # 8 AdamW steps on one batch, kernel path against plain path
    batch = device_batch(TRAIN_GRAD_BATCH)
    traj = {}
    for name, norm_act in (("kernel", group_norm.group_norm_act),
                           ("plain", group_norm.group_norm_act_plain)):
        t = Trainer("resnet50", config=config, learning_rate=TRAIN_LR,
                    seed=0, device="cuda")
        t.model.norm_act = norm_act
        traj[name] = [float(t.step(batch)) for _ in range(TRAIN_STEPS)]
        del t
    gap = max(abs(a - b) for a, b in zip(traj["kernel"], traj["plain"]))
    falls = traj["kernel"][-1] < 0.5 * traj["kernel"][0]
    print(f"train resnet50 {TRAIN_STEPS} AdamW steps (lr {TRAIN_LR}) on one "
          f"batch: kernel losses {[round(v, 5) for v in traj['kernel']]}; "
          f"plain {[round(v, 5) for v in traj['plain']]}; max gap "
          f"{gap:.3e} (tol {TRAJECTORY_TOL} x {traj['plain'][0]:.4f}); "
          f"falls={falls}", flush=True)
    if gap > TRAJECTORY_TOL * traj["plain"][0] or not falls:
        raise SystemExit("training-model phase failed (trajectory)")

    # train-step rate at batch 256, device-resident batch
    torch.cuda.empty_cache()
    t = Trainer("resnet50", config=config, learning_rate=TRAIN_LR, seed=0,
                device="cuda")
    batch = device_batch(MODEL_BATCH)
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: t.step(batch), 10)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ips = MODEL_BATCH / step_ms * 1e3
    print(f"train resnet50 step batch {MODEL_BATCH}: {step_ms:.3f} ms, "
          f"{ips:.1f} images/s, peak memory {peak_gb:.2f} GB", flush=True)
    profile_train_step(t, batch, step_ms)
    del t, batch
    torch.cuda.empty_cache()
    return {"images_per_s": ips, "step_ms": step_ms}


def profile_train_step(trainer, batch, step_ms: float, steps: int = 3):
    """Device time per training step by family (torch.profiler, CUPTI):
    forward norm, backward norm, convolutions (forward and backward), the
    optimizer, everything else, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
    fams, others = collections.Counter(), collections.Counter()
    for kernel, ms in device_kernels(prof, steps):
        name = kernel.lower()
        if "gn_bwd" in name:
            fam = "norm backward"
        elif name.startswith("gn_") or "gn_one_pass" in name or any(
                k in name for k in ("gn_stats", "gn_apply", "gn_finalize")):
            fam = "norm forward"
        elif any(k in name for k in ("conv", "fprop", "dgrad", "wgrad",
                                     "xmma", "gemm", "cudnn", "implicit",
                                     "cutlass", "nvjet", "sm90_")):
            fam = "conv fwd+bwd"
        elif any(k in name for k in ("adam", "multi_tensor", "foreach")):
            fam = "optimizer"
        else:
            fam = "other"
        fams[fam] += ms
        if fam == "other":
            others[kernel[:60]] += ms
    busy = sum(fams.values())
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    parts = " ".join(f"{k}={v:.3f}ms({v / busy:.1%})"
                     for k, v in fams.most_common())
    print(f"profile resnet50 train step batch {MODEL_BATCH}, device ms per "
          f"step: busy={busy:.3f} of {step_ms:.3f} (idle share "
          f"{max(0.0, 1 - busy / step_ms):.1%}); {parts}", flush=True)
    print("profile largest 'other' kernels of the step: " + "; ".join(
        f"{name}={ms:.3f}ms" for name, ms in others.most_common(6)),
        flush=True)


def train_map_fun(args, ctx):
    """The training slice's ``map_fun``: a ``Trainer`` on the node's card
    fed by ``DataFeed`` (prefetching, staged by ``trainer.shard``),
    publishing its metrics every step; then the losses and the kernel
    launches of its steps on the node's kv blackboard."""
    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.kernels import group_norm
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    trainer = Trainer("resnet50", config=resnet.Config(),
                      learning_rate=args["lr"], seed=args["seed"])
    trainer.add_step_callback(metrics.MetricsReporter(ctx, interval=1))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["image", "label"], prefetch=2)
    ctx.mgr.set("ready", True)
    group_norm.reset_launches()
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args["batch"], device_put=trainer.shard)
        if not batch or batch["image"].shape[0] == 0:
            continue
        losses.append(trainer.step(batch))
    ctx.mgr.set("launches", dict(group_norm.launches_by_path))
    ctx.mgr.set("losses", [float(v) for v in losses])
    ctx.mgr.set("device", str(trainer.device))


def train_slice_phase() -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch import TFCluster, TFManager, sparkapi
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.trainer import Trainer

    rng = np.random.RandomState(2)
    images = rng.rand(SLICE_TRAIN_ROWS, 224, 224, 3).astype(np.float32)
    labels = rng.randint(0, 1000, size=SLICE_TRAIN_ROWS)
    rows = [(images[i], int(labels[i])) for i in range(SLICE_TRAIN_ROWS)]
    args = {"batch": SLICE_TRAIN_BATCH, "lr": TRAIN_LR, "seed": 0}
    sc = sparkapi.LocalSparkContext("local[1]")
    try:
        t0 = time.perf_counter()
        cluster = TFCluster.run(sc, train_map_fun, args, num_executors=1,
                                input_mode=TFCluster.InputMode.SPARK)
        authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
        [meta] = cluster.cluster_info
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        deadline = time.monotonic() + 600
        while not mgr.get("ready") and time.monotonic() < deadline:
            if mgr.get("state") == "failed":
                break  # train() below raises the trainer's error
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        rdd = sc.parallelize(rows, SLICE_TRAIN_PARTITIONS)
        t1 = time.perf_counter()
        cluster.train(rdd, feed_timeout=600)
        train_s = time.perf_counter() - t1
        cluster.shutdown(grace_secs=120)
        state = mgr.get("state")
        losses = mgr.get("losses") or []
        launches = mgr.get("launches") or {}
        device = mgr.get("device")
        agg = cluster.metrics()
    finally:
        sc.stop()

    # the same 4 batches, in partition order, in this process
    t = Trainer("resnet50", config=resnet.Config(), learning_rate=TRAIN_LR,
                seed=0, device="cuda")
    replay = []
    for lo in range(0, SLICE_TRAIN_ROWS, SLICE_TRAIN_BATCH):
        replay.append(float(t.step({
            "image": images[lo:lo + SLICE_TRAIN_BATCH],
            "label": labels[lo:lo + SLICE_TRAIN_BATCH]})))
    del t
    torch.cuda.empty_cache()
    steps = SLICE_TRAIN_ROWS // SLICE_TRAIN_BATCH
    rel = (abs(losses[-1] - replay[-1]) / abs(replay[-1]) if losses
           else float("inf"))
    ips = agg.get("total_examples_per_sec")
    wall_ips = SLICE_TRAIN_ROWS / train_s
    print(f"train slice TFCluster.run -> cluster.train -> DataFeed -> "
          f"Trainer.step, resnet50 on {device}: state {state}, "
          f"{len(losses)} steps, losses {[round(v, 5) for v in losses]}; "
          f"in-process replay {[round(v, 5) for v in replay]}; final loss "
          f"rel={rel:.3e} (tol {SLICE_TRAIN_VS_IN_PROCESS}); executor "
          f"launches={launches}; cluster.metrics() images/s={ips}; "
          f"cluster.train {train_s:.3f} s for {SLICE_TRAIN_ROWS} rows = "
          f"{wall_ips:.2f} images/s (after {ready_s:.1f} s to a ready "
          f"trainer)", flush=True)
    if (state != "finished" or len(losses) != steps
            or not all(math.isfinite(v) for v in losses)
            or rel > SLICE_TRAIN_VS_IN_PROCESS or not str(device).startswith(
                "cuda")
            or launches != launch_counts(one_pass=53 * steps,
                                         backward_one_pass=53 * steps)
            or not ips):
        raise SystemExit("training slice phase failed")
    return {"launches": launches, "images_per_s": ips,
            "wall_images_per_s": wall_ips}


# ---------------------------------------------------------------------------
# Wide&deep: the table kernel, the training model, the estimator slice
# ---------------------------------------------------------------------------


def synth_criteo(n: int, buckets: int, seed: int = 0, zipf: float = 0.0):
    """Criteo-shaped rows ``(dense[13], cat[26], label)`` with a learnable
    click signal (``examples/criteo/criteo_pipeline.py::synth_criteo``);
    with ``zipf`` the bucket ids are Zipf-distributed, else uniform."""
    import numpy as np

    from tensorflowonspark_torch.models.widedeep import NUM_CAT, NUM_DENSE

    rng = np.random.RandomState(seed)
    dense = rng.rand(n, NUM_DENSE)
    cat = (criteo_ids(rng, n, buckets, zipf) if zipf
           else rng.randint(0, buckets, size=(n, NUM_CAT)))
    # clicks driven by dense[0] and one categorical bucket parity
    logit = 3.0 * (dense[:, 0] - 0.5) + (cat[:, 0] % 2) - 0.5
    label = (1 / (1 + np.exp(-logit)) > rng.rand(n)).astype(int)
    return [(dense[i].tolist(), cat[i].tolist(), int(label[i]))
            for i in range(n)]


def criteo_ids(rng, n: int, buckets: int, zipf: float = 0.0):
    """(n, 26) per-feature bucket ids: uniform, or Zipf(``zipf``) folded
    into the buckets (the most frequent value is bucket 0)."""
    from tensorflowonspark_torch.models.widedeep import NUM_CAT

    if not zipf:
        return rng.randint(0, buckets, size=(n, NUM_CAT))
    return (rng.zipf(zipf, size=(n, NUM_CAT)) - 1) % buckets


def rows_to_batch(rows) -> dict:
    """Rows of :func:`synth_criteo` as the train step's batch, with the
    casts ``criteo_train_fn``'s stager applies."""
    import numpy as np

    return {"dense": np.asarray([r[0] for r in rows], np.float32),
            "cat": np.asarray([r[1] for r in rows], np.int32),
            "label": np.asarray([r[2] for r in rows], np.int32)}


def table_bound_ms(n: int, id_bytes: int, dim: int, unique: int) -> dict:
    """The least time of one table update on the card: the ids and the row
    gradients read once, each touched row of the table and the
    accumulator read and written once (bytes), against a few f32
    operations an element (operations)."""
    nbytes = n * id_bytes + n * dim * 4 + unique * dim * 4 * 4
    ops = n * dim * 6 + unique * dim * 4
    return _bound(nbytes / HBM_BYTES_PER_S * 1e3,
                  ops / F32_OPS_PER_S * 1e3, bytes=nbytes)


def step_bound_ms(n: int, id_bytes: int, dims, unique: int) -> dict:
    """The least time of a step's table path: :func:`table_bound_ms` of
    each table whose ids are the same ``n`` ids, bytes and operations each
    summed, the ids counted once.  The grouping lives inside it."""
    parts = [table_bound_ms(n, id_bytes if i == 0 else 0, d, unique)
             for i, d in enumerate(dims)]
    return _bound(sum(b["bytes_ms"] for b in parts),
                  sum(b["ops_ms"] for b in parts),
                  bytes=sum(b["bytes"] for b in parts))


def group_bound_ms(n: int, id_bytes: int, segments: int) -> dict:
    """The least time of the id grouping: the ids read once, the grouped
    keys and positions (int32), the segment starts and the two counts
    written once (bytes), against a digit extraction and a count an id a
    radix pass at the f32 rate (operations; int32 runs no faster)."""
    nbytes = n * id_bytes + n * 8 + (segments + 1) * 4 + 8
    return _bound(nbytes / HBM_BYTES_PER_S * 1e3,
                  n * 3 * 2 / F32_OPS_PER_S * 1e3, bytes=nbytes)


def _bound(bytes_ms: float, ops_ms: float, **extra) -> dict:
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **extra}


def _table_diff(got, want, touched) -> tuple[float, float, bool]:
    """(max |got - want| over touched rows, max |want| there, whether any
    untouched row of ``got`` differs from ``want``) for (vocab, ...)
    tensors."""
    import torch

    rows = got.shape[0]
    diff = (got - want).abs().reshape(rows, -1)[touched]
    scale = want.abs().reshape(rows, -1)[touched]
    moved = (got != want).reshape(rows, -1).any(dim=1) & ~touched
    return float(diff.max()), float(scale.max()), bool(moved.any())


def grouping_matches(grouping, ids, vocab: int) -> bool:
    """The grouping kernel's outputs against ``embedding.group_ids_plain``
    (``sort_ids`` of the same ids on the same device), bit for bit: the
    in-range occurrences' wrapped ids and positions, the dropped tail, the
    segment starts and rows, and the two counts."""
    import torch

    from tensorflowonspark_torch import embedding

    want = embedding.group_ids_plain(ids, vocab)
    count = int(want.meta[0])
    return (grouping.n == want.n and grouping.vocab == vocab
            and grouping.keys.dtype == torch.int32
            and torch.equal(grouping.keys, want.keys)
            and torch.equal(grouping.pos, want.pos)
            and torch.equal(grouping.meta, want.meta)
            and torch.equal(grouping.seg_start, want.seg_start)
            and torch.equal(grouping.seg_row[:count], want.seg_row[:count]))


def plain_on_cpu_rows(tables, ids, grads, lr: float, combine: bool):
    """The plain update run on the CPU, whose ``index_add_`` adds a row's
    occurrences in batch order, on copies of the touched rows only, the ids
    remapped onto them (rows are independent, so the bits are those of the
    whole tables).  Returns ``(touched rows, [(table rows, acc rows)])``."""
    import torch

    from tensorflowonspark_torch import embedding

    vocab = tables[0][0].shape[0]
    flat = embedding.wrap_ids(ids.reshape(-1).long(), vocab)
    keep = (flat >= 0) & (flat < vocab)
    rows, inverse = torch.unique(flat[keep], return_inverse=True)
    out = []
    for (table, acc), g in zip(tables, grads):
        g = g.reshape(flat.shape[0], *table.shape[1:])[keep].cpu()
        t, a = table[rows].cpu(), acc[rows].cpu()
        embedding.sparse_adagrad_update_plain(t, a, inverse.cpu(), g, lr,
                                              combine=combine)
        out.append((t, a))
    return rows, out


def f64_rows(tables, ids, grads, lr: float, combine: bool, eps=1e-10):
    """The update evaluated in float64 on the card, on the touched rows (as
    :func:`plain_on_cpu_rows`): an f32 result's distance from it is its
    rounding.  Returns ``(touched rows, [(table rows, acc rows)])``."""
    import torch

    from tensorflowonspark_torch import embedding

    vocab = tables[0][0].shape[0]
    flat = embedding.wrap_ids(ids.reshape(-1).long(), vocab)
    keep = (flat >= 0) & (flat < vocab)
    rows, inverse = torch.unique(flat[keep], return_inverse=True)
    out = []
    for (table, acc), g in zip(tables, grads):
        g = g.reshape(flat.shape[0], *table.shape[1:])[keep].double()
        t, a = table[rows].double(), acc[rows].double()
        if combine:
            s = torch.zeros_like(a).index_add_(0, inverse, g)
            a += s * s
            t += -lr * s * torch.rsqrt(a + eps)
        else:
            a.index_add_(0, inverse, g * g)
            t.index_add_(0, inverse, -lr * g * torch.rsqrt(a[inverse] + eps))
        out.append((t, a))
    return rows, out


def table_family(kernel: str) -> str | None:
    """The table path's family of a profiled kernel name: the grouping
    kernel, the update kernel, or ``None`` (the sort's kernels are CUB's,
    named apart by the callers)."""
    if "tfos_id_grouping" in kernel:
        return "id grouping"
    if "tfos_adagrad_segment_walk" in kernel:
        return "table update"
    return None


def table_device_ms(call, calls: int = 20) -> dict:
    """Device ms per ``call()`` (torch.profiler, CUPTI) by family: the
    grouping kernel, the update kernel, everything else."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    fams = dict.fromkeys(("id grouping", "table update", "other"), 0.0)
    for name, ms in device_kernels(prof, calls):
        fams[table_family(name) or "other"] += ms
    return fams


def measure_table_case(tables, ids, grads, combine: bool, label: str,
                       atomic_gate: bool = True,
                       replaced_ms: float | None = None) -> dict:
    """One case of phase 8: ``tables`` (one or two ``(table, acc)`` pairs
    sharing ``ids``; the deep and wide pair is a training step's) in one
    mode.  Gates and times (see the module docstring); the tables are left
    as they were: every call works on clones.  ``atomic_gate=False`` prints
    the distance to the card's plain version without gating it: where one
    row takes every occurrence, the atomic sum's own order moves it past
    ``TABLE_TOL_REL`` (see :data:`TABLE_TOL_REL`).  ``replaced_ms``: the
    replaced design's update time for the case, printed beside."""
    import torch

    from tensorflowonspark_torch import embedding
    from tensorflowonspark_torch.kernels import sparse_adagrad

    lr = 0.01
    path = "combine" if combine else "sparse"
    vocab = tables[0][0].shape[0]
    flat = ids.reshape(-1)
    wrapped = embedding.wrap_ids(flat, vocab)
    inside = wrapped[(wrapped >= 0) & (wrapped < vocab)].long()
    touched = torch.zeros(vocab, dtype=torch.bool, device="cuda")
    touched[inside] = True
    unique = int(touched.sum())

    def entry(pairs):
        if len(pairs) == 1:
            embedding.sparse_adagrad_update(*pairs[0], ids, grads[0], lr,
                                            combine=combine)
        else:
            embedding.sparse_adagrad_update_tables(pairs, ids, grads, lr,
                                                   combine=combine)

    groupings = [embedding.group_ids(flat, vocab) for _ in range(2)]
    torch.cuda.synchronize()
    grouped = all(grouping_matches(g, flat, vocab) for g in groupings)
    segments = int(groupings[0].meta[0])
    outs = []
    for _ in range(2):  # the path twice on fresh copies
        pairs = [(t.clone(), a.clone()) for t, a in tables]
        before = dict(sparse_adagrad.launches_by_path)
        entry(pairs)
        torch.cuda.synchronize()
        outs.append((pairs, {k: v - before[k] for k, v in
                             sparse_adagrad.launches_by_path.items()}))
    (got, took1), (again, took2) = outs
    same = all(torch.equal(x, y) for p, q in zip(got, again)
               for x, y in zip(p, q))
    launches_ok = all(took == {**dict.fromkeys(took, 0), "group": 1, path: 1}
                      for took in (took1, took2))
    rows, cpu = plain_on_cpu_rows(tables, ids, grads, lr, combine)
    bit_identical = all(torch.equal(x[rows].cpu(), y)
                        for p, q in zip(got, cpu) for x, y in zip(p, q))
    err, worst, moved = 0.0, 0.0, False
    f64 = {"kernel": 0.0, "card plain": 0.0}  # worst |x - f64| / max|f64|
    _, exact = f64_rows(tables, ids, grads, lr, combine)
    for (t, a), (t0, a0), g, pair64 in zip(got, tables, grads, exact):
        tp, ap = t0.clone(), a0.clone()
        embedding.sparse_adagrad_update_plain(tp, ap, ids, g, lr,
                                              combine=combine)
        for x, want, orig, x64 in ((t, tp, t0, pair64[0]),
                                   (a, ap, a0, pair64[1])):
            e, scale, _ = _table_diff(x, want, touched)
            err, worst = max(err, e), max(worst, e / max(scale, 1e-30))
            moved |= _table_diff(x, orig, touched)[2]
            for k, y in (("kernel", x), ("card plain", want)):
                d = (y[rows].double() - x64).abs().max()
                f64[k] = max(f64[k], float(d / x64.abs().max().clamp_min(
                    1e-300)))
        del tp, ap
    del exact
    tol_ok = worst <= TABLE_TOL_REL or not atomic_gate
    ok = (grouped and same and launches_ok and bit_identical and tol_ok
          and not moved)
    del outs, got, again, cpu

    work = [(t.clone(), a.clone()) for t, a in tables]  # timed calls update
    grouping = groupings[0]
    rows3 = [(t, a, g.reshape(flat.numel(), *t.shape[1:]))
             for (t, a), g in zip(work, grads)]
    ms = time_ms(lambda: entry(work), 200)
    group_ms = time_ms(lambda: sparse_adagrad.group(flat, vocab), 200)
    sort_ms = time_ms(lambda: torch.sort(wrapped, stable=True), 200)
    group_plain_ms = time_ms(lambda: embedding.group_ids_plain(flat, vocab),
                             20)
    update_ms = time_ms(lambda: sparse_adagrad.update(
        rows3, grouping, lr, 1e-10, combine), 200)
    plain_ms = time_ms(lambda: [embedding.sparse_adagrad_update_plain(
        t, a, ids, g, lr, combine=combine)
        for (t, a), g in zip(work, grads)], 50)
    dense_ms = plain_ms if combine else time_ms(lambda: [
        embedding.sparse_adagrad_update_plain(t, a, ids, g, lr, combine=True)
        for (t, a), g in zip(work, grads)], 20)
    host = host_us(lambda: entry(work))
    # one profiler session for the path and the library sort, told apart by
    # name: the path launches no kernel but its two (its other ops are
    # views, no-op casts and an empty allocation), so "other" is the sort's
    device = table_device_ms(lambda: (entry(work),
                                      torch.sort(wrapped, stable=True)))
    sort_device = device["other"]
    del work, rows3
    dims = [t[0].numel() for t, _ in tables]
    bound = step_bound_ms(ids.numel(), ids.element_size(), dims, unique)
    gbound = group_bound_ms(ids.numel(), ids.element_size(), segments)
    case = {"max_abs_err": err, "ms": update_ms, "path_ms": ms,
            "device_ms": device["table update"],
            "group_ms": group_ms, "group_device_ms": device["id grouping"],
            "sort_ms": sort_ms, "sort_device_ms": sort_device,
            "group_plain_ms": group_plain_ms, "plain_ms": plain_ms,
            "dense_path_ms": dense_ms, "host_us": host, "unique": unique,
            "segments": segments, "group_bound_ms": gbound["bound_ms"],
            **bound}
    print(f"table {label} {path}: {ids.numel()} {ids.dtype} ids, {unique} "
          f"rows touched, rows {dims} f32; grouping = sort_ids bit for bit "
          f"{grouped}, update = plain on the CPU bit for bit "
          f"{bit_identical}, vs plain on the card err {err:.3e}, worst "
          f"err/max {worst:.3e} (tol {TABLE_TOL_REL}"
          f"{'' if atomic_gate else ', not gated'}) {tol_ok}, vs float64 "
          f"worst err/max: kernel {f64['kernel']:.3e} card plain "
          f"{f64['card plain']:.3e}, untouched moved {moved}, "
          f"same bits twice {same}, launches {took1} {took2}; device ms: "
          f"grouping={device['id grouping']:.4f} update="
          f"{device['table update']:.4f} torch.sort={sort_device:.4f} "
          f"(replaced design: sort {REPLACED_MS['sort']}, update "
          f"{replaced_ms if replaced_ms is not None else '-'}); "
          f"event ms: path={ms:.4f} "
          f"grouping={group_ms:.4f} torch.sort={sort_ms:.4f} "
          f"grouping_plain={group_plain_ms:.4f} update={update_ms:.4f} "
          f"plain={plain_ms:.4f} dense_path="
          f"{'plain' if combine else f'{dense_ms:.4f}'}; bound_ms="
          f"{bound['bound_ms']:.5f} ({bound['bytes']} B), grouping bound "
          f"{gbound['bound_ms']:.5f}; host_us={host:.1f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"table kernels {label} {path} failed")
    return case


def table_kernel_phase() -> dict:
    """Phase 8: both modes, on the full tables at batch 1024: the step's
    deep and wide pair in one launch for uniform, Zipf, int64, 8-rank
    all-gathered Zipf and all-equal ids; deep and wide alone for uniform
    and Zipf ids.  Returns, per mode, the pair's Zipf case (the slice's
    ids) with the others beside it."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.models import widedeep

    config = widedeep.Config()
    gen = torch.Generator(device="cuda").manual_seed(5)
    vocab, dim = config.total_buckets, config.embed_dim
    tables = {
        "deep": (0.01 * torch.randn(vocab, dim, generator=gen,
                                    device="cuda"),
                 1e-6 * torch.rand(vocab, dim, generator=gen, device="cuda")),
        "wide": (0.01 * torch.randn(vocab, generator=gen, device="cuda"),
                 1e-6 * torch.rand(vocab, generator=gen, device="cuda"))}
    rng = np.random.RandomState(6)

    def draw(n, zipf):
        cat = torch.from_numpy(criteo_ids(rng, n, config.hash_buckets,
                                          zipf).astype(np.int32)).cuda()
        return widedeep.fold_ids(cat, config)

    draws = {"uniform": draw(WD_BATCH, 0.0), "zipf": draw(WD_BATCH, WD_ZIPF)}
    draws["int64"] = draws["uniform"].long()
    draws["ranks8_zipf"] = draw(8 * WD_BATCH, WD_ZIPF)
    draws["same_id"] = torch.full_like(draws["uniform"], 7 * 100_000 + 3)
    result = {}
    for combine in (True, False):
        path = "combine" if combine else "sparse"
        cases = {}
        for name, ids in draws.items():
            grads = [1e-4 * torch.randn(*ids.shape, *t.shape[1:],
                                        generator=gen, device="cuda")
                     for t, _ in tables.values()]
            replaced = {k: REPLACED_MS.get(f"{k}_{name}") for k in tables}
            cases[f"pair_{name}"] = measure_table_case(
                list(tables.values()), ids, grads, combine, f"pair {name}",
                atomic_gate=name != "same_id",
                replaced_ms=(sum(replaced.values())
                             if None not in replaced.values() else None))
            if name in ("uniform", "zipf"):
                for i, label in enumerate(tables):
                    cases[f"{label}_{name}"] = measure_table_case(
                        [tables[label]], ids, grads[i:i + 1], combine,
                        f"{label} {name}", replaced_ms=replaced[label])
        main = cases["pair_zipf"]
        print(f"table {path} per training step (deep + wide in one launch, "
              f"Zipf ids): " + " ".join(
                  f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                  for k, v in main.items()), flush=True)
        result[path] = {
            **{k: main[k] for k in (
                "ms", "path_ms", "device_ms", "plain_ms", "bound_ms",
                "bytes_ms", "ops_ms", "bound_by", "host_us", "group_ms",
                "group_device_ms", "sort_ms", "sort_device_ms",
                "group_plain_ms", "group_bound_ms", "segments")},
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "library_ms": main["plain_ms"] if combine else None,
            **({} if combine else {"dense_path_ms": main["dense_path_ms"]}),
            **{f"{k}_{m}": c[m] for k, c in cases.items() if k != "pair_zipf"
               for m in ("ms", "device_ms", "group_device_ms", "bound_ms")}}
    del tables
    torch.cuda.empty_cache()
    return result


def _wd_trainer(table_update: str, seed: int = 0):
    import dataclasses

    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    config = dataclasses.replace(widedeep.Config(), table_update=table_update)
    return Trainer("wide_deep", config=config, learning_rate=WD_LR, seed=seed,
                   device="cuda")


def _plain_tables_update(tables, ids, grads, lr, eps=1e-10, combine=False):
    """``embedding.sparse_adagrad_update_tables`` with the plain version,
    run on the CPU, whose ``index_add_`` adds a row's occurrences in batch
    order as the kernel does (on the card it adds them with atomics, in no
    fixed order): the step's twin the kernel path is held against."""
    from tensorflowonspark_torch import embedding

    for (table, acc), g in zip(tables, grads):
        t, a = table.cpu(), acc.cpu()
        embedding.sparse_adagrad_update_plain(t, a, ids.cpu(), g.cpu(), lr,
                                              eps, combine)
        table.copy_(t)
        acc.copy_(a)
    return tables


def wd_train_model_phase() -> dict:
    """Phase 9 (see the module docstring)."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import embedding
    from tensorflowonspark_torch.kernels import sparse_adagrad
    from tensorflowonspark_torch.models import widedeep

    buckets = widedeep.Config().hash_buckets

    def device_batch(rows):
        return {k: torch.from_numpy(v).cuda()
                for k, v in rows_to_batch(rows).items()}

    out = {}
    for table_update, path in WD_MODES:
        # one step, kernel path against the plain table update
        batch = device_batch(synth_criteo(WD_BATCH, buckets, seed=7,
                                          zipf=WD_ZIPF))
        kernel_t, plain_t = _wd_trainer(table_update), _wd_trainer(
            table_update)
        before = {k: v.clone() for k, v in
                  kernel_t.model.collections()["embedding"].items()}
        sparse_adagrad.reset_launches()
        loss_k = float(kernel_t.step(batch))
        torch.cuda.synchronize()
        step_launches = dict(sparse_adagrad.launches_by_path)
        kernel_update = embedding.sparse_adagrad_update_tables
        embedding.sparse_adagrad_update_tables = _plain_tables_update
        try:
            loss_p = float(plain_t.step(batch))
        finally:
            embedding.sparse_adagrad_update_tables = kernel_update
        plain_launches = sparse_adagrad.launches - sum(step_launches.values())

        def mlp(t, grad):
            return {k: (p.grad if grad else p).detach()
                    for k, p in t.model.named_parameters()}

        grads = _rel_l2(mlp(kernel_t, True), mlp(plain_t, True))
        params = _rel_l2(mlp(kernel_t, False), mlp(plain_t, False))
        ids = widedeep.fold_ids(batch["cat"], kernel_t.config).reshape(-1)
        touched = torch.zeros(kernel_t.config.total_buckets, dtype=torch.bool,
                              device="cuda")
        touched[ids.long()] = True
        table_ok, worst, identical = True, 0.0, True
        for group, leaves in kernel_t.model.collections().items():
            for k, got in leaves.items():
                want = plain_t.model.collections()[group][k]
                err, scale, _ = _table_diff(got, want, touched)
                worst = max(worst, err / max(scale, 1e-30))
                identical &= torch.equal(got, want)
                table_ok &= err <= TABLE_TOL_REL * scale and identical
                if k in before:
                    table_ok &= not _table_diff(got, before[k], touched)[2]
        del plain_t, before
        print(f"train wide_deep {table_update} one step at batch {WD_BATCH} "
              f"(Zipf ids): loss kernel={loss_k:.6f} plain-table={loss_p:.6f}"
              f"; MLP grads rel_l2={grads:.3e} params after={params:.3e} "
              f"(tol {WD_MLP_REL}); tables+accumulators against the plain "
              f"update on the CPU: worst err/max={worst:.3e} (tol "
              f"{TABLE_TOL_REL}), bit-identical={identical}, untouched rows "
              f"kept; "
              f"table launches {step_launches} (plain path {plain_launches})",
              flush=True)
        if (grads > WD_MLP_REL or params > WD_MLP_REL or not table_ok
                or loss_k != loss_p or plain_launches
                or step_launches != {**dict.fromkeys(step_launches, 0),
                                     "group": 1, path: 1}):
            raise SystemExit(f"wide&deep training-model phase failed "
                             f"({table_update}, one step)")

        # 20 steps on synth_criteo rows: the loss falls, a grouping and an
        # update launch a step
        rows = synth_criteo(WD_BATCH * WD_STEPS, buckets, seed=8)
        sparse_adagrad.reset_launches()
        losses = [kernel_t.step(device_batch(
            rows[i * WD_BATCH:(i + 1) * WD_BATCH])) for i in range(WD_STEPS)]
        losses = [float(v) for v in losses]
        launches = dict(sparse_adagrad.launches_by_path)
        falls = np.mean(losses[-5:]) < WD_FALL * losses[0]
        print(f"train wide_deep {table_update} {WD_STEPS} steps: losses "
              f"{[round(v, 5) for v in losses]}; last-5 mean / first = "
              f"{np.mean(losses[-5:]) / losses[0]:.4f} (falls below "
              f"{WD_FALL}: {falls}); table launches {launches}", flush=True)
        if (not falls or not all(math.isfinite(v) for v in losses)
                or launches != {**dict.fromkeys(launches, 0),
                                "group": WD_STEPS, path: WD_STEPS}):
            raise SystemExit(f"wide&deep training-model phase failed "
                             f"({table_update}, trajectory)")

        # steps/s on one device-resident batch
        del kernel_t
        torch.cuda.empty_cache()
        t = _wd_trainer(table_update)
        torch.cuda.reset_peak_memory_stats()
        step_ms = time_ms(lambda: t.step(batch), 50)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"train wide_deep {table_update} step batch {WD_BATCH}: "
              f"{step_ms:.4f} ms, {1e3 / step_ms:.1f} steps/s, "
              f"{WD_BATCH * 1e3 / step_ms:.0f} examples/s, peak memory "
              f"{peak_gb:.2f} GB", flush=True)
        profile_wd_step(t, batch, step_ms, table_update)
        del t
        torch.cuda.empty_cache()
        out[table_update] = {"steps_per_s": 1e3 / step_ms,
                             "step_ms": step_ms, "peak_gb": peak_gb}
    return out


def wd_step_family(kernel: str) -> str:
    """The family of a kernel of the wide&deep step, by name: the table
    path's two kernels by theirs (:func:`table_family`), then GEMMs, the
    gather, any id sort (CUB's radix sort), AdamW, other."""
    name = kernel.lower()
    fam = table_family(kernel)
    if fam is not None:
        return fam
    for fam, keys in (("GEMMs", ("gemm", "cutlass", "nvjet", "sm90_", "xmma",
                                 "cublas")),
                      ("gather", ("index", "gather")),
                      ("id sort", ("sort", "radix", "cub::")),
                      ("AdamW", ("adam", "multi_tensor", "foreach"))):
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_wd_step(trainer, batch, step_ms: float, label: str,
                    steps: int = 5) -> None:
    """Device time per wide&deep step by family (torch.profiler, CUPTI):
    GEMMs, the gather, the id grouping kernel, the table update kernel, any
    id sort, AdamW, other."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
    fams, kernels = collections.Counter(), collections.Counter()
    for kernel, ms in device_kernels(prof, steps):
        fam = wd_step_family(kernel)
        fams[fam] += ms
        kernels[f"[{fam}] {kernel[:50]}"] += ms
    busy = sum(fams.values())
    if busy == 0:
        print("profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    parts = " ".join(f"{k}={v:.4f}ms({v / busy:.1%})"
                     for k, v in fams.most_common())
    print(f"profile wide_deep {label} step batch {WD_BATCH}, device ms per "
          f"step: busy={busy:.4f} of {step_ms:.4f} (idle share "
          f"{max(0.0, 1 - busy / step_ms):.1%}); {parts}", flush=True)
    print(f"profile wide_deep {label} largest kernels of the step: "
          + "; ".join(f"{name}={ms:.4f}ms"
                      for name, ms in kernels.most_common(8)), flush=True)


def criteo_train_fn(args, ctx):
    """Port of ``examples/criteo/criteo_pipeline.py::train_fun``: a
    wide&deep ``Trainer`` on the node's device fed by the DataFrame's
    partitions (``DataFeed``, prefetching, staged by ``trainer.shard`` with
    the reference's dtype casts), publishing its metrics every step; the
    chief exports.  Then the losses and the table launches of its steps on
    the node's kv blackboard."""
    import dataclasses

    import numpy as np

    from tensorflowonspark_torch import metrics
    from tensorflowonspark_torch.kernels import sparse_adagrad
    from tensorflowonspark_torch.models import widedeep
    from tensorflowonspark_torch.trainer import Trainer

    config = widedeep.Config.tiny() if args.tiny else widedeep.Config()
    # --lr drives both towers of the CTR recipe: AdaGrad on the tables at
    # 10x, AdamW on the MLP through the Trainer's default optimizer
    config = dataclasses.replace(config, table_lr=args.lr * 10.0,
                                 table_update=args.table_update)
    trainer = Trainer("wide_deep", config=config, learning_rate=args.lr)
    trainer.add_step_callback(metrics.MetricsReporter(ctx, interval=1))
    feed = ctx.get_data_feed(train_mode=True,
                             input_mapping=["dense", "cat", "label"],
                             prefetch=2)

    def stage(batch):
        # short tail batches stay on the host: the loop drops them
        if batch["dense"].shape[0] != args.batch_size:
            return batch
        return trainer.shard({
            "dense": batch["dense"].astype(np.float32),
            "cat": batch["cat"].astype(np.int32),
            "label": batch["label"].astype(np.int32),
        })

    sparse_adagrad.reset_launches()
    losses = []
    while not feed.should_stop():
        batch = feed.next_batch(args.batch_size, device_put=stage)
        if not batch or batch["dense"].shape[0] != args.batch_size:
            continue
        losses.append(trainer.step(batch))
    ctx.mgr.set("launches", dict(sparse_adagrad.launches_by_path))
    ctx.mgr.set("losses", [float(v) for v in losses])
    ctx.mgr.set("device", str(trainer.device))
    if ctx.job_name == "chief":
        trainer.export(ctx.absolute_path(args.export_dir))


def fit_and_score(sc, df, args: dict, batch_size: int, cluster_size: int,
                  export_dir: str):
    """``TFEstimator(criteo_train_fn).fit(df)`` then ``TFModel.transform``
    of the export (scores named ``ctr``).  Returns ``(the cluster, what each
    node published, the scored rows)``; the cluster is the one
    ``TFEstimator.fit`` ran, caught on its way through ``TFCluster.run``,
    so its managers can be read after the fit."""
    from tensorflowonspark_torch import TFCluster, TFManager, pipeline

    clusters = []
    run = TFCluster.run

    def catching_run(*a, **k):
        clusters.append(run(*a, **k))
        return clusters[-1]

    TFCluster.run = catching_run
    try:
        est = (pipeline.TFEstimator(criteo_train_fn, tf_args=args)
               .setClusterSize(cluster_size).setBatchSize(batch_size)
               .setEpochs(1).setExportDir(export_dir)
               .setModelName("wide_deep").setGraceSecs(120))
        model = est.fit(df)
    finally:
        TFCluster.run = run
    [cluster] = clusters
    authkey = bytes.fromhex(cluster.cluster_meta["authkey_hex"])
    published = []
    for meta in cluster.cluster_info:
        mgr = TFManager.connect(tuple(meta["addr"]), authkey)
        published.append({k: mgr.get(k) for k in ("state", "losses",
                                                  "launches", "device")})
    scored = (model.setBatchSize(batch_size)
              .setInputMapping({"dense": "dense", "cat": "cat"})
              .setOutputMapping({"prediction": "ctr"})
              .transform(df.select("dense", "cat"))).collect()
    return cluster, published, scored


def wd_slice_phase() -> dict:
    """Phase 10 (see the module docstring), once per ``table_update``."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import ckpt, sparkapi
    from tensorflowonspark_torch.models import widedeep

    buckets = widedeep.Config().hash_buckets
    rows = synth_criteo(WD_SLICE_ROWS, buckets, seed=9, zipf=WD_ZIPF)
    steps = WD_SLICE_ROWS // WD_BATCH
    out = {}
    for table_update, path in WD_MODES:
        export_dir = tempfile.mkdtemp(prefix="tfos_torch_wd_")
        sc = sparkapi.LocalSparkContext("local[1]")
        try:
            df = sparkapi.LocalSparkSession(sc).createDataFrame(
                rows, ["dense", "cat", "label"]).repartition(
                    WD_SLICE_PARTITIONS)
            t0 = time.perf_counter()
            cluster, [node], scored = fit_and_score(
                sc, df, {"lr": WD_LR, "tiny": False,
                         "table_update": table_update},
                WD_BATCH, 1, export_dir)
            seconds = time.perf_counter() - t0
            agg = cluster.metrics()
            state = ckpt.load_pytree(os.path.join(export_dir, "model"))
        finally:
            sc.stop()
            shutil.rmtree(export_dir, ignore_errors=True)
        # the same batches, in partition order, in this process
        t = _wd_trainer(table_update)
        replay = [float(t.step(rows_to_batch(
            rows[i * WD_BATCH:(i + 1) * WD_BATCH]))) for i in range(steps)]
        del t
        served = widedeep.load_state(widedeep.make_model(
            widedeep.config_from_state(state)), state).cuda().eval()
        forward = widedeep.make_forward_fn(served, served.config)
        want = torch.cat([forward(served, {
            k: torch.from_numpy(v).cuda() for k, v in rows_to_batch(
                rows[i * WD_BATCH:(i + 1) * WD_BATCH]).items()}).cpu()
            for i in range(steps)])
        del served
        torch.cuda.empty_cache()
        got = torch.tensor([r.ctr for r in scored])
        losses = node["losses"] or []
        rel = max((abs(a - b) / abs(b) for a, b in zip(losses, replay)),
                  default=float("inf"))
        score_err = (float((got - want).abs().max())
                     if got.shape == want.shape else float("inf"))
        ex_per_s = agg.get("total_examples_per_sec")
        steps_per_s = ex_per_s / WD_BATCH if ex_per_s else None
        launches = node["launches"] or {}
        print(f"slice wide_deep {table_update}: TFEstimator.fit -> "
              f"TFCluster.run -> DataFeed -> Trainer.step on {node['device']}"
              f": state {node['state']}, {len(losses)} steps, losses "
              f"{[round(v, 6) for v in losses]}; in-process replay "
              f"{[round(v, 6) for v in replay]}; max rel {rel:.3e} (tol "
              f"{WD_SLICE_VS_REPLAY}); executor table launches {launches}; "
              f"TFModel.transform {len(scored)} rows, max |score - "
              f"in-process forward| {score_err:.3e} (tol "
              f"{WD_SCORES_VS_FORWARD}); cluster.metrics() steps/s="
              f"{steps_per_s} ({ex_per_s} examples/s); fit + transform "
              f"{seconds:.1f} s", flush=True)
        if (node["state"] != "finished" or len(losses) != steps
                or not all(math.isfinite(v) for v in losses)
                or rel > WD_SLICE_VS_REPLAY
                or not str(node["device"]).startswith("cuda")
                or launches != {**dict.fromkeys(launches, 0),
                                "group": steps, path: steps}
                or len(scored) != WD_SLICE_ROWS
                or score_err > WD_SCORES_VS_FORWARD or not steps_per_s):
            raise SystemExit(f"wide&deep slice phase failed ({table_update})")
        out[path] = {"launches": launches[path],
                     "group_launches": launches["group"],
                     "steps_per_s": steps_per_s}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dataclasses

    from tensorflowonspark_torch.kernels import _build, group_norm
    from tensorflowonspark_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {time.perf_counter() - t0:.1f} s", flush=True)

    config = resnet.Config()
    model = resnet.make_model(config, seed=0).cuda().eval()
    f32_model = resnet.load_state(
        resnet.make_model(dataclasses.replace(config, dtype="float32")),
        resnet.state_of(model)).cuda().eval()
    f32_model.norm_act = group_norm.group_norm_act_plain  # bf16-only kernel
    sites = record_sites(model, config.image_size)
    if len(sites) != 53:
        raise SystemExit(f"expected 53 norm calls per forward, got "
                         f"{len(sites)}")
    kern = kernel_phase(sites)
    model_phase(model, f32_model)
    del f32_model
    serving = slice_phase(model)
    del model
    torch.cuda.empty_cache()
    kern.update(backward_phase(sites))
    train_model_phase()
    main_path = train_slice_phase()
    tables = table_kernel_phase()
    wd_train = wd_train_model_phase()
    wd_slice = wd_slice_phase()
    print("wide_deep steps/s at batch 1024: " + "; ".join(
        f"{mode}: Trainer.step {wd_train[mode]['steps_per_s']:.1f}, slice "
        f"{wd_slice[path]['steps_per_s']}" for mode, path in WD_MODES),
        flush=True)

    print(card)  # as nvidia-smi gives it: name, power limit
    names = {"one_pass": "group_norm_act (one_pass)",
             "two_pass": "group_norm_act (two_pass)",
             "backward_one_pass": "group_norm_act backward (one_pass)",
             "backward_four_launch": "group_norm_act backward (four_launch)"}
    kernels = [{
        "name": names[path], "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/group_norm"
                  + ("_bwd.cu" if path.startswith("backward") else ".cu"),
        "replaces": ("tensorflowonspark_tpu/parallel/train.py:416"
                     if path.startswith("backward")
                     else "tensorflowonspark_tpu/models/resnet.py:59"),
        "launches": main_path["launches"][path],
        "launches_serving": serving["launches"].get(path, 0), **kern[path]}
        for path in names]
    grouping = tables["combine"]
    kernels.append({
        "name": "sparse_adagrad id grouping", "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/sparse_adagrad.cu",
        "replaces": "tensorflowonspark_tpu/embedding.py:54",
        "launches": sum(wd_slice[p]["group_launches"] for _, p in WD_MODES),
        "max_abs_err": 0.0, "ms": grouping["group_ms"],
        "device_ms": grouping["group_device_ms"],
        "plain_ms": grouping["group_plain_ms"],
        **group_bound_ms(WD_BATCH * 26, 4, grouping["segments"]),
        "library_ms": grouping["sort_ms"],
        "library_device_ms": grouping["sort_device_ms"]})
    kernels += [{
        "name": f"sparse_adagrad ({path})", "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/sparse_adagrad.cu",
        "replaces": ("tensorflowonspark_tpu/models/widedeep.py:283"
                     if path == "combine"
                     else "tensorflowonspark_tpu/embedding.py:36"),
        "launches": wd_slice[path]["launches"], **tables[path]}
        for _, path in WD_MODES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
