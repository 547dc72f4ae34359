#!/usr/bin/env python3
"""The paged kernels' launch plans and source variants, on one card.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:
``python3 tools/torch_paged_attention_probe.py [--calls N] [--only
attention|append]``.  It prints the card's name and power limit, builds
``csrc/paged_attention.cu`` once more with ``-Xptxas -v`` and prints each
instantiation's registers, stack and spills.

The attention (``--only attention``) takes ``chip_smoke.py``'s 17(a)
cases (the decode step, chunk 16 and 32, the long decode case, 256 rows
x 128 causal positions) and, for each, launches the kernel under
``paged_attention.plan``'s plan and under the other tiles
``paged_attention.tiled`` takes there.  Every
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
launch-bound variants are checked against the twin.

The K/V append (``--only append``) takes the same five cases and a wider
one (:data:`WIDE_ROWS` rows of 128 positions), holds ``kv_append`` bit for
bit to the plain twin outside page 0, and prints ms a call (CUDA events,
which at the small cases read the wrapper's host time) and µs a launch
(CUPTI) beside the bound.  Then :data:`APPEND_VARIANTS`, timed the same
way in turns with the shipped build: ``no_copies`` (the scalars read and
the page found, nothing copied: the launch floor), ``copies4`` (4-byte
copies, a lane a float), ``load_cs`` and ``store_cs`` (evict-first loads
or stores); and the device time (CUPTI, every kernel of a call summed) of
two PyTorch yardsticks: ``chip_smoke.py``'s library call, ``index_put_``
of k and v at their (page, offset) made beforehand, and ``copy_`` of the
same k and v bytes into two buffers.  With the floor and the shipped
kernel's time, a launch's time splits into launch, scalars and bytes.
The shipped sources are not changed.
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

#: edits of the append in ``csrc/paged_attention.cu`` (``(old, new)``
#: text replacements); ``no_copies`` stores only where the offset is
#: negative, which it never is, so the loads and scalars stay
APPEND_VARIANTS = {
    "no_copies": [("  if (page < 0 || page >= a.num_pages) return;",
                   "  if (page < 0 || page >= a.num_pages || dst >= 0) "
                   "return;")],
    "copies4": [("constexpr int kAppendVec = 4;",
                 "constexpr int kAppendVec = 1;")],
    "load_cs": [  # k and v loaded evict-first (ld.global.cs)
        ("__ldg(reinterpret_cast<const Vec*>",
         "__ldcs(reinterpret_cast<const Vec*>")],
    "store_cs": [  # the pools stored evict-first (st.global.cs)
        ("    *reinterpret_cast<Vec*>(a.k_pool + dst + c) = kv;\n"
         "    *reinterpret_cast<Vec*>(a.v_pool + dst + c) = vv;",
         "    __stcs(reinterpret_cast<Vec*>(a.k_pool + dst + c), kv);\n"
         "    __stcs(reinterpret_cast<Vec*>(a.v_pool + dst + c), vv);")],
}

#: rows of 128 positions in the append's widest case: 131,072 items
WIDE_ROWS = 1024

#: (query tile, position tile) tried beside the default plan
TILES = ((1, 32), (1, 64), (2, 64), (4, 64), (8, 64), (16, 64), (32, 64),
         (8, 32), (16, 32))


def ptxas_report(kernel: str = "tfos_paged_attention") -> list[str]:
    """``-Xptxas -v``'s lines for ``kernel``'s instantiations: ``<template
    arguments>: registers, stack, spills``."""
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
        if name and kernel in name and "Used" in line:
            shape = re.findall(r"Li(\d+)E", name)
            label = f"{kernel}<{', '.join(shape)}>" if shape else name
            lines.append(f"{label}: {line.split(':', 1)[-1].strip()}")
        elif name and kernel in name and (
                "spill" in line or "stack" in line):
            lines.append(f"    {line.split(':', 1)[-1].strip()}")
    return lines


def variant_libs(tmp: str, variants: dict | None = None) -> dict:
    """``{name: bound library}`` of ``variants`` (``{name: edits}``;
    :data:`VARIANTS` by default), built in ``tmp`` with
    ``kernels/_build.py``'s flags, all ``nvcc`` processes at once."""
    import ctypes

    from tensorflowonspark_torch.kernels import _build
    from tensorflowonspark_torch.kernels import paged_attention as pa

    shipped = open(os.path.join(_build.CSRC_DIR, "paged_attention.cu")).read()
    if variants is None:
        variants = {name: edits for name, (edits, _) in VARIANTS.items()}
    procs = {}
    for name, edits in variants.items():
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


def wide_case():
    """``(label, case, max_len)`` of the append's widest case:
    :data:`WIDE_ROWS` rows of 128 positions (268 MB moved)."""
    import chip_smoke as cs

    rows = [(0, cs.SYNTH_POSITIONS, [("own", j) for j in range(8)])
            for _ in range(WIDE_ROWS)]
    return ("wide", cs.paged_case(rows, cs.SYNTH_POSITIONS,
                                  1 + 8 * WIDE_ROWS, 181), 128)


def cupti_us(fn, calls: int, kernel: str = "tfos_paged_attention") -> float:
    """Mean µs a launch of ``kernel`` over ``calls`` calls of ``fn``
    (``chip_smoke.cupti_us``); stops the probe when the trace holds
    none."""
    import chip_smoke as cs

    us = cs.cupti_us(fn, calls, kernel)
    if us is None:
        raise SystemExit(f"probe: the trace holds no {kernel} launch")
    return us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--only", choices=("attention", "append"),
                    help="probe one kernel (both by default)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA card")
    print(cs.card_line(), flush=True)
    if args.only != "append":
        attention_probe(args.calls)
    if args.only != "attention":
        append_probe(args.calls)
    return 0


def attention_probe(calls_n: int) -> None:
    """The attention's plans and :data:`VARIANTS` (the module docstring)."""
    import torch

    import chip_smoke as cs
    from tensorflowonspark_torch.kernels import paged_attention as pa

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
                ms[key] += cs.time_ms(calls[key], calls_n) / 2
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
        compare_variants(variant_libs(tmp), calls_n)


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


def device_us(fn, calls: int) -> float:
    """Mean device µs a call of ``fn`` under torch.profiler: every kernel
    and copy of the trace but the spin kernels, summed, over ``calls``
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    for _ in range(3):
        fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.TRACE_WARMUP_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ms for name, ms in cs.device_kernels(prof, calls)
               if "sleep" not in name.lower()
               and "spin" not in name.lower()) * 1e3


def append_probe(calls_n: int) -> None:
    """The append against its twin, :data:`APPEND_VARIANTS` and the
    PyTorch yardsticks (the module docstring)."""
    import torch

    import chip_smoke as cs
    from tensorflowonspark_torch.kernels import paged_attention as pa

    for line in ptxas_report("tfos_kv_append"):
        print("ptxas", line, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = variant_libs(tmp, APPEND_VARIANTS)
        shipped = pa._lib()
        layer = 1
        for label, case, max_len in cases() + [wide_case()]:
            k, v = case["k"], case["v"]
            R, L, H, K = k.shape
            idx = (case["tables"], case["start"], case["lens"])
            kt, vt = case["k_pool"].clone(), case["v_pool"].clone()
            pa.kv_append_plain(kt, vt, layer, k, v, *idx, max_len=max_len)
            kc, vc = case["k_pool"].clone(), case["v_pool"].clone()

            def call():
                pa.kv_append(kc, vc, layer, k, v, *idx, max_len=max_len)

            call()
            torch.cuda.synchronize()
            if not (torch.equal(kc[:, 1:], kt[:, 1:])
                    and torch.equal(vc[:, 1:], vt[:, 1:])):
                raise SystemExit(f"probe: append {label} differs from the "
                                 f"twin outside page 0")
            bound = cs.paged_bounds(case, max_len)["kv_append"]
            print(f"append {label} ({R} rows x {L} positions, {H} heads of "
                  f"{K}, {pa.append_plan(R, L, H, K).blocks} blocks): bound "
                  f"{bound['bound_ms']:.6f} ms by {bound['bound_by']}",
                  flush=True)
            named = {"shipped": shipped, **libs}
            ms = dict.fromkeys(named, 0.0)
            us = dict.fromkeys(named, 0.0)
            try:
                for turn in (list(named), list(named)[::-1]):
                    for name in turn:
                        pa._LIB = named[name]
                        ms[name] += cs.time_ms(call, calls_n) / 2
                        us[name] += cupti_us(call, 20, "tfos_kv_append") / 2
            finally:
                pa._LIB = shipped
            print(f"append variants at {label}: " + "; ".join(
                f"{name} {us[name]:.3f} us a launch (CUPTI), {ms[name]:.4f} "
                f"ms a call (events)" for name in named), flush=True)
            where = cs._append_indices(case, max_len)
            kb, vb = torch.empty_like(k), torch.empty_like(v)
            put = device_us(lambda: (kt[layer].index_put_(where, k),
                                     vt[layer].index_put_(where, v)), 20)
            copy = device_us(lambda: (kb.copy_(k), vb.copy_(v)), 20)
            print(f"append {label}: PyTorch yardsticks, us a call (CUPTI, "
                  f"every kernel summed): index_put_ x2 {put:.3f}; copy_ of "
                  f"the same bytes x2 {copy:.3f}", flush=True)
            del case, kc, vc, kt, vt
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
