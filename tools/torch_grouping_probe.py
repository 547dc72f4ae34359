#!/usr/bin/env python3
"""Where the id grouping kernel's time goes, phase by phase, on one card.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:
``python3 tools/torch_grouping_probe.py``.  It copies
``tensorflowonspark_torch/csrc/sparse_adagrad.cu`` into a temporary
directory, inserts ``%globaltimer`` stamps (block 0, thread 0) at the
grouping kernel's phase boundaries, builds that copy with the flags of
``kernels/_build.py``, and groups three batches of 26,624 ids at
``widedeep.Config()``'s vocab (uniform, Zipf(1.1), all one id).  For each
it checks the outputs against ``embedding.group_ids_plain`` and prints
the kernel's time (CUDA events over back-to-back launches) and the µs
from the kernel's start to each stamp: per pass ``p``, ``p.load`` (keys
loaded, histograms zeroed), ``p.count`` (each warp's digits counted and
ranked), ``p.offsets`` (the cluster's digit offsets), ``p.scatter``
(staged and written out), ``p.barrier`` (the pass's cluster barrier);
then ``heads.count``, ``heads.scan`` and ``end``.  The shipped source is
not changed; a marker that is not found stops the probe.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "tensorflowonspark_torch", "csrc",
                      "sparse_adagrad.cu")

#: (text that follows a phase boundary, the stamp put just before it):
#: per pass the keys loaded, counted, offset, scattered and past the
#: pass's barrier; then the heads counted and scanned, and the end
MARKS = [
    ("#pragma unroll\n      for (int k = 0; k < kRegSteps; ++k) {\n"
     "        if (lo + 32 * k < hi) {", "      STAMP(1 + 6 * p);\n"),
    ("      digit_offsets(sm, cluster, rank, t, warp, lane);\n#pragma unroll",
     "      STAMP(2 + 6 * p);\n"),
    ("#pragma unroll\n      for (int k = 0; k < kRegSteps; ++k) {\n"
     "        if (lo + 32 * k + lane < hi) {", "      STAMP(3 + 6 * p);\n"),
    ("    // the barrier's release and acquire order",
     "    STAMP(4 + 6 * p);\n"),
    ("  }\n\n  // segment starts over the sorted keys",
     "    STAMP(5 + 6 * p);\n"),
    ("  if (lane == 0) {\n    sm.warp_sum[0][warp] = heads;", "  STAMP(40);\n"),
    ("  const int count = sm.cluster_sums[2];", "  STAMP(41);\n"),
    ("  cluster.sync();  // no block leaves", "  STAMP(42);\n"),
]
PHASES = ("load", "count", "offsets", "scatter", "barrier")


def stamped_source() -> str:
    """The kernel source with the stamps and a reader of them."""
    src = open(SOURCE).read()
    head = ("__device__ unsigned long long tfos_probe[64];\n"
            "#define STAMP(k) do { if (rank == 0 && t == 0) { "
            "unsigned long long x; asm volatile(\"mov.u64 %0, "
            "%%globaltimer;\" : \"=l\"(x)); tfos_probe[k] = x; } } while (0)\n")
    marks = [("namespace {\n", None),
             ("  const bool resident = per_warp <= 32 * kRegSteps;", None)]
    for marker, _ in marks + MARKS:
        if src.count(marker) != 1:
            raise SystemExit(f"torch_grouping_probe: marker not found once: "
                             f"{marker[:50]!r}")
    src = src.replace("namespace {\n", "namespace {\n" + head)
    src = src.replace(marks[1][0], "  STAMP(0);\n" + marks[1][0])
    for marker, stamp in MARKS:
        src = src.replace(marker, stamp + marker)
    return src + ('\nextern "C" int tfos_probe_read(unsigned long long* out) '
                  "{\n  return static_cast<int>(cudaMemcpyFromSymbol(out, "
                  "tfos_probe, sizeof(tfos_probe)));\n}\n")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_grouping_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from tensorflowonspark_torch.kernels import _build, sparse_adagrad
    from tensorflowonspark_torch.models import widedeep

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(stamped_source())
        lib_path = os.path.join(tmp, "probe.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                        lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tfos_group_ids.argtypes = [p, i32, i64, i64] + [p] * 8
    lib.tfos_group_ids.restype = i32
    config = widedeep.Config()
    vocab = config.total_buckets
    rng = np.random.RandomState(6)

    def batch(zipf):
        cat = chip_smoke.criteo_ids(rng, chip_smoke.WD_BATCH,
                                    config.hash_buckets, zipf)
        return widedeep.fold_ids(torch.from_numpy(cat.astype(np.int32)),
                                 config).reshape(-1).cuda()

    draws = {"uniform": batch(0.0), "zipf": batch(chip_smoke.WD_ZIPF)}
    draws["same"] = torch.full_like(draws["uniform"], 7 * 100_000 + 3)
    print(chip_smoke.card_line(), flush=True)
    for name, ids in draws.items():
        n = ids.numel()
        out = sparse_adagrad.Grouping.empty(n, vocab, ids.device)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.tfos_group_ids(
                ids.data_ptr(), 4, n, vocab, out.keys.data_ptr(),
                out.pos.data_ptr(), *out.scratch(), out.seg_start.data_ptr(),
                out.seg_row.data_ptr(), out.meta.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        same = chip_smoke.grouping_matches(out, ids, vocab)
        ms = chip_smoke.time_ms(call, 200)
        stamps = (ctypes.c_ulonglong * 64)()
        call()
        torch.cuda.synchronize()
        if lib.tfos_probe_read(stamps):
            raise RuntimeError("could not read the stamps")
        t0 = stamps[0]
        marks = []
        for pass_ in range(4):
            for k, phase in enumerate(PHASES):
                at = stamps[1 + 6 * pass_ + k]
                if at >= t0:
                    marks.append((f"{pass_}.{phase}", (at - t0) / 1e3))
        marks += [(label, (stamps[k] - t0) / 1e3) for k, label in
                  ((40, "heads.count"), (41, "heads.scan"), (42, "end"))]
        print(f"grouping {name}: {n} ids, equal to group_ids_plain {same}, "
              f"{ms:.4f} ms a launch (CUDA events); µs from the start: "
              + " ".join(f"{k}={v:.1f}" for k, v in marks), flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
