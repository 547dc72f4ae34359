#!/usr/bin/env python3
"""The paged attention kernel's launch plans against each other, on one card.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:
``python3 tools/torch_paged_attention_probe.py [--calls N]``.  It prints
the card's name and power limit, builds ``csrc/paged_attention.cu`` once
more with ``-Xptxas -v`` and prints each instantiation's registers, stack
and spills, then takes ``chip_smoke.py``'s 17(a) cases (the decode step,
chunk 16 and 32, the long decode case, 256 rows x 128 causal positions)
and, for each, launches the kernel under ``paged_attention.plan``'s plan
and under the other tiles ``paged_attention.tiled`` takes there.  Every
plan's output must lie within ``chip_smoke.ATTN_TOL`` of the plain twin
and give the same bits twice, or the probe stops.  For each plan it
prints the ms a call (CUDA events over ``N`` back-to-back launches, the
plans timed in turns, forward then backward, and averaged) and the µs a
launch under CUPTI (``torch.profiler``), beside the case's bound.  Then
it builds edited copies of the source (:data:`VARIANTS`: a tighter
launch bound, a phase left out) and times each beside the shipped build
under the default plan, in turns, at the decode, chunk 32 and 256 x 128
cases: where a phase's time goes, without a profiler that reads inside a
kernel.  A variant that leaves a phase out computes garbage, so only the
launch-bound variants are checked against the twin.  The shipped sources
are not changed.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: edits of ``csrc/paged_attention.cu`` built beside it: ``(old, new)``
#: text replacements, and whether the result must still match the twin
VARIANTS = {
    "bounds4": ([("constexpr int kMinBlocks = 5;",
                  "constexpr int kMinBlocks = 4;")], True),
    "bounds6": ([("constexpr int kMinBlocks = 5;",
                  "constexpr int kMinBlocks = 6;")], True),
    "unroll1": ([("constexpr int kScoreUnroll = 2;",
                  "constexpr int kScoreUnroll = 1;")], True),
    "unroll4": ([("constexpr int kScoreUnroll = 2;",
                  "constexpr int kScoreUnroll = 4;")], True),
    "no_scores": ([("    if (scores) {  // scores",
                    "    if (scores && a.L < 0) {  // scores")], False),
    "no_apply": ([("    if (applies) {  // acc",
                   "    if (applies && a.L < 0) {  // acc")], False),
}

#: (query tile, position tile) tried beside the default plan
TILES = ((1, 32), (1, 64), (2, 64), (4, 64), (8, 64), (16, 64), (32, 64),
         (8, 32), (16, 32))


def ptxas_report() -> list[str]:
    """``-Xptxas -v``'s lines for the attention kernel's instantiations:
    ``<QA, JB, QPT>: registers, stack, spills``."""
    from tensorflowonspark_torch.kernels import _build

    src = os.path.join(_build.CSRC_DIR, "paged_attention.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "probe.so"), src],
            capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "tfos_paged_attention" in name and "Used" in line:
            shape = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)E", name)
            label = (f"<{', '.join(shape.groups())}>" if shape else name)
            lines.append(f"{label}: {line.split(':', 1)[-1].strip()}")
        elif name and "tfos_paged_attention" in name and (
                "spill" in line or "stack" in line):
            lines.append(f"    {line.split(':', 1)[-1].strip()}")
    return lines


def variant_libs(tmp: str) -> dict:
    """``{name: bound library}`` of :data:`VARIANTS`, built in ``tmp``
    with ``kernels/_build.py``'s flags, all ``nvcc`` processes at once."""
    import ctypes

    from tensorflowonspark_torch.kernels import _build
    from tensorflowonspark_torch.kernels import paged_attention as pa

    shipped = open(os.path.join(_build.CSRC_DIR, "paged_attention.cu")).read()
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        src = shipped
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"probe: variant {name}: {old!r} not found")
            src = src.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(tmp, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: variant {name} failed to build:\n{log}")
        libs[name] = pa._bind(ctypes.CDLL(os.path.join(tmp, f"{name}.so")))
    return libs


def cases() -> list:
    """``(label, case, max_len)``: chip_smoke.py's 17(a) cases."""
    import chip_smoke as cs

    out = []
    for i, (label, L) in enumerate((("decode", 1), ("chunk16", 16),
                                    ("chunk32", 32))):
        rows = cs.paged_case_rows(label, L)
        out.append((label, cs.paged_case(rows, L, 1 + 8 * len(rows),
                                         170 + i), 128))
    rows = cs.paged_case_rows("long", 1)
    out.append(("long", cs.paged_case(rows, 1, 1 + cs.LONG_PAGES * len(rows),
                                      178, width=cs.LONG_PAGES),
                cs.LONG_MAX_LEN))
    synth = [(0, cs.SYNTH_POSITIONS, [("own", j) for j in range(8)])
             for _ in range(cs.SYNTH_ROWS)]
    out.append(("synthetic", cs.paged_case(synth, cs.SYNTH_POSITIONS,
                                           1 + 8 * cs.SYNTH_ROWS, 179), 128))
    return out


def cupti_us(fn, calls: int) -> float:
    """Mean µs a launch of the attention kernel over ``calls`` calls of
    ``fn`` under torch.profiler (after spin kernels: a session drops its
    first device records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.TRACE_WARMUP_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = [t for name, t in cs.device_kernels(prof, 1)
          if "tfos_paged_attention" in name]
    if not ms:
        raise SystemExit("probe: the trace holds no attention launch")
    return sum(ms) / len(ms) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from tensorflowonspark_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA card")
    print(cs.card_line(), flush=True)
    for line in ptxas_report():
        print("ptxas", line, flush=True)
    layer = 1
    for label, case, max_len in cases():
        q, tables, start = case["q"], case["tables"], case["start"]
        kp, vp = case["k_pool"], case["v_pool"]
        R, L, H, K = q.shape
        ps = kp.shape[2]
        scale = 1.0 / K ** 0.5
        default = pa.plan(R, L, H, K, ps, max_len)
        plans = {(default.q_tile, default.pos_tile): default}
        for qt, tp in TILES:
            if (L == 1) != (qt == 1) or (qt, tp) in plans:
                continue
            try:
                plans[(qt, tp)] = pa.tiled(R, L, H, K, ps, max_len, qt, tp)
            except ValueError:
                continue
        twin = pa.paged_attention_plain(q, kp, vp, layer, tables, start,
                                        max_len=max_len)
        calls = {k: (lambda p=p: pa._launch(q, kp, vp, layer, tables, start,
                                            max_len, scale, p))
                 for k, p in plans.items()}
        for key, fn in calls.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            err = float((a - twin).abs().max())
            if not (err <= cs.ATTN_TOL and torch.equal(a, b)):
                raise SystemExit(f"probe: {label} {key}: {err:.3e} from the "
                                 f"twin, or not the same bits twice")
        order = list(calls)
        ms = dict.fromkeys(order, 0.0)
        for turn in (order, order[::-1]):
            for key in turn:
                ms[key] += cs.time_ms(calls[key], args.calls) / 2
        bound = cs.paged_bounds(case, max_len)["paged_attention"]
        print(f"{label} ({R} rows x {L} queries, {H} heads of {K}, "
              f"max_len {max_len}): bound {bound['bound_ms']:.5f} ms by "
              f"{bound['bound_by']}", flush=True)
        for key in order:
            p = plans[key]
            us = cupti_us(calls[key], 20)
            print(f"  tile {key[0]:>2} x {key[1]:>2}"
                  f"{' (plan)' if p == default else '       '}: "
                  f"{ms[key]:.4f} ms a call (events), {us:.2f} us a launch "
                  f"(CUPTI); {p.blocks} blocks, smem {p.smem} B, "
                  f"<{p.score_rows}, {p.score_cols}, {p.out_rows}>, splits "
                  f"{p.splits}", flush=True)
        del case, twin, calls
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        compare_variants(variant_libs(tmp), args.calls)
    return 0


def compare_variants(libs: dict, calls: int) -> None:
    """Time :func:`paged_attention`'s plan under each variant library and
    the shipped one, in turns (forward, then backward), at the decode,
    chunk 32 and 256 x 128 cases."""
    import torch

    import chip_smoke as cs
    from tensorflowonspark_torch.kernels import paged_attention as pa

    shipped = pa._lib()
    libs = {"shipped": shipped, **libs}
    layer = 1
    for label, case, max_len in cases():
        if label not in ("decode", "chunk32", "synthetic"):
            continue
        q, tables, start = case["q"], case["tables"], case["start"]
        kp, vp = case["k_pool"], case["v_pool"]
        R, L, H, K = q.shape
        p = pa.plan(R, L, H, K, kp.shape[2], max_len)
        twin = pa.paged_attention_plain(q, kp, vp, layer, tables, start,
                                        max_len=max_len)

        def call():
            return pa._launch(q, kp, vp, layer, tables, start, max_len,
                              1.0 / K ** 0.5, p)

        ms = dict.fromkeys(libs, 0.0)
        try:
            for name, lib in libs.items():
                pa._LIB = lib
                out = call()
                torch.cuda.synchronize()
                if name == "shipped" or VARIANTS[name][1]:
                    err = float((out - twin).abs().max())
                    if not err <= cs.ATTN_TOL:
                        raise SystemExit(f"probe: variant {name} at {label}:"
                                         f" {err:.3e} from the twin")
            order = list(libs)
            for turn in (order, order[::-1]):
                for name in turn:
                    pa._LIB = libs[name]
                    ms[name] += cs.time_ms(call, calls) / 2
        finally:
            pa._LIB = shipped
        print(f"variants at {label} (tile {p.q_tile} x {p.pos_tile}): "
              + "; ".join(
                  f"{name} {v:.4f} ms" for name, v in ms.items()),
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
