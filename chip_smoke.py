#!/usr/bin/env python3
"""Drive the PyTorch port (``tensorflowonspark_torch``) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one NVIDIA card (built for ``sm_90a``: an H100), the CUDA toolkit
(``nvcc``) and nothing of JAX.  Phases, each of which fails the run:

1. Print the card's name and power limit; build every kernel from
   ``tensorflowonspark_torch/csrc`` (timed).
2. Kernel phase: ``group_norm_act`` against its plain PyTorch twin at every
   (shape, mode) the ResNet-50 forward gives it, at batch 32 in bf16: max
   abs error against the stated tolerance, then the kernel's, the plain
   twin's and one PyTorch call's (``F.group_norm`` → add → ReLU, a
   yardstick the port never calls) times with CUDA events, beside the
   least time the card could take (``bound_ms``).
3. Model phase: full ``Config()`` ResNet-50 at 224², bf16, seeded weights.
   Kernel path against the plain path and against an f32 forward (TF32
   off), exactly 53 kernel launches per forward, images/s at batch 256.
4. Slice phase, the port's main path: export the weights, then
   ``TFModel.transform`` on a local-substrate DataFrame (127 rows, 3 ragged
   partitions, ``local[1]``) on the card, checking the scores against an
   in-process forward, the executor's kernel launches and the shape
   signatures it saw.  rows/s.

The last lines are the card line, one JSON line listing each kernel, and
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints no
result.
"""

from __future__ import annotations

import collections
import json
import math
import os
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

# stated tolerances
KERNEL_TOL_ULPS = 2  # |kernel - plain| <= 2 bf16 ulps of max(1, max|plain|)
LOGITS_KERNEL_VS_PLAIN = 1e-2  # rel L2, bf16 both: rounding flips only
LOGITS_BF16_VS_F32 = 3e-2  # rel L2, bf16 vs f32 forward (CPU measured 7e-3)
SLICE_VS_IN_PROCESS = 1e-3  # rel L2, same kernels, weights and batches


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


def kernel_phase(sites: list[tuple]) -> dict:
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.kernels import group_norm

    counts = collections.Counter(sites)
    totals = collections.Counter()
    max_err = 0.0
    bound_by = collections.Counter()
    for i, ((c, h, w, groups, res, relu), per_fwd) in enumerate(
            counts.items()):
        gen = torch.Generator(device="cuda").manual_seed(i)
        shape = (KERNEL_BATCH, c, h, w)

        def draw():
            return (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
                    ).to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)

        gamma = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
        act_bytes = KERNEL_BATCH * c * h * w * 2
        call_bytes = act_bytes * (3 if res else 2) + 2 * c * 4
        # rotate over copies so the working set is 4x L2: each launch
        # reads its inputs from device memory, as after a large conv
        copies = min(64, max(2, math.ceil(4 * L2_BYTES / call_bytes)))
        xs = [draw() for _ in range(copies)]
        rs = [draw() if res else None for _ in range(copies)]
        ref = group_norm.group_norm_act_plain(xs[0], gamma, beta, groups,
                                              1e-6, rs[0], relu)
        out = group_norm.group_norm_act(xs[0], gamma, beta, groups, 1e-6,
                                        rs[0], relu)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = KERNEL_TOL_ULPS * 2.0 ** -7 * max(1.0, float(ref.abs().max()))
        ok = err <= tol and out.is_contiguous(memory_format=torch.channels_last)
        max_err = max(max_err, err)

        turn = [0]

        def cycle(fn):
            def call():
                k = turn[0] = (turn[0] + 1) % copies
                return fn(xs[k], rs[k])
            return call

        kernel_ms = time_ms(cycle(lambda x, r: group_norm.group_norm_act(
            x, gamma, beta, groups, 1e-6, r, relu)), 50)
        plain_ms = time_ms(cycle(lambda x, r: group_norm.group_norm_act_plain(
            x, gamma, beta, groups, 1e-6, r, relu)), 20)
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

        def library(x, r):
            y = F.group_norm(x, groups, g16, b16, 1e-6)
            if r is not None:
                y = y + r
            return torch.relu(y) if relu else y

        library_ms = time_ms(cycle(library), 20)
        ops = KERNEL_BATCH * c * h * w * (6 + int(res) + int(relu))
        bytes_ms = call_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by[("bytes" if bytes_ms >= ops_ms else "operations")] += 1
        mode = "GN" + ("+add" if res else "") + ("+ReLU" if relu else "")
        print(f"kernel group_norm_act {KERNEL_BATCH}x{h}x{w}x{c} G={groups} "
              f"{mode:11s} x{per_fwd:2d}/fwd max_abs_err={err:.3e} "
              f"(tol {tol:.3e}) kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"group_norm_act disagrees with its plain twin "
                             f"at {shape} {mode}: {err} > {tol}")
        for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                       ("library_ms", library_ms), ("bound_ms", bound_ms)):
            totals[key] += per_fwd * v
        del xs, rs
    print(f"kernel group_norm_act per ResNet-50 forward at batch "
          f"{KERNEL_BATCH} ({len(sites)} calls, {len(counts)} shapes): "
          + " ".join(f"{k}={v:.4f}" for k, v in totals.items()), flush=True)
    return {"max_abs_err": max_err, **{k: totals[k] for k in totals},
            "bound_by": bound_by.most_common(1)[0][0]}


def model_phase(model, f32_model) -> dict:
    import numpy as np
    import torch

    from tensorflowonspark_torch.kernels import group_norm

    images = torch.from_numpy(np.random.RandomState(0).rand(
        8, 224, 224, 3).astype(np.float32)).cuda()
    with torch.inference_mode():
        group_norm.launches = 0
        kernel_logits = model(images)
        torch.cuda.synchronize()
        per_forward = group_norm.launches
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
            or vs_f32 > LOGITS_BF16_VS_F32 or per_forward != 53):
        raise SystemExit("model phase failed")

    batch = torch.rand(MODEL_BATCH, 224, 224, 3, device="cuda")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(batch), 10)
    ips = MODEL_BATCH / fwd_ms * 1e3
    print(f"model resnet50 forward batch {MODEL_BATCH}: {fwd_ms:.3f} ms, "
          f"{ips:.1f} images/s", flush=True)
    profile_forward(model, batch, fwd_ms)
    return {"images_per_s": ips, "forward_ms": fwd_ms}


def profile_forward(model, batch, fwd_ms: float, forwards: int = 3) -> None:
    """Device time per forward by kernel family (torch.profiler, CUPTI):
    the fused norm's three kernels, convolutions, everything else, and the
    device's idle share against the event-timed forward."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            model(batch)
        torch.cuda.synchronize()
    fams, others = collections.Counter(), collections.Counter()
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue  # host-side op; its kernels are events of their own
        name = e.name.lower()
        fam = next((k for k in ("gn_stats", "gn_finalize", "gn_apply")
                    if k in name), None)
        if fam is None:
            fam = "conv" if any(k in name for k in (
                "conv", "fprop", "xmma", "gemm", "cudnn", "implicit",
                "cutlass")) else "other"
        ms = e.time_range.elapsed_us() / 1e3 / forwards
        fams[fam] += ms
        if fam == "other":
            others[e.name[:60]] += ms
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

    group_norm.launches = 0
    return [0]


def _executor_state(_):
    from tensorflowonspark_torch import serving
    from tensorflowonspark_torch.kernels import group_norm

    return [(group_norm.launches,
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
        group_norm.launches = 0
        t0 = time.perf_counter()
        out = tfmodel.transform(df).collect()
        seconds = time.perf_counter() - t0
        driver_launches = group_norm.launches
        [(exec_launches, seen)] = sc.parallelize([0], 1).mapPartitions(
            _executor_state).collect()
        # again, with the model loaded and the kernel built on both sides
        t0 = time.perf_counter()
        warm_rows = len(tfmodel.transform(df).collect())
        warm_seconds = time.perf_counter() - t0
    finally:
        sc.stop()

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
            or err > SLICE_VS_IN_PROCESS or exec_launches <= 0
            or got != want or len(seen) != 1):
        raise SystemExit("slice phase failed")
    return {"launches": exec_launches + driver_launches,
            "rows_per_s": rows_per_s}


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
    main_path = slice_phase(model)

    print(card)  # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": [{
        "name": "group_norm_act", "route": "cuda",
        "source": "tensorflowonspark_torch/csrc/group_norm.cu",
        "replaces": "tensorflowonspark_tpu/models/resnet.py:59",
        "launches": main_path["launches"],
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
