"""Where the one-pass GroupNorm kernels spend a call, phase by phase.

Builds ``csrc/group_norm.cu`` and ``csrc/group_norm_bwd.cu`` once more with
``-DTFOS_GN_PHASE_STAMPS``: at each phase boundary, after a block barrier,
thread 0 of every block reads the card's ``%globaltimer``.  Then it runs the
one-pass forward and backward (GN+ReLU, as the model zoo calls them) through
the wrapper on that build at each shape, and prints per kernel the cluster
the plan took, the clusters the card runs at once and the waves that makes,
each phase's mean µs over the blocks, the mean cluster lifetime, the span of
the call, and the events time of the kernel built without stamps.  The
stamped build adds a block barrier at each stamp, so its phases sum to a
little more than the plain kernel's time.

    python -m tensorflowonspark_torch.kernels.phases [N,C,H,W ...]

With no shape it takes Inception-v3's four stem samples at batch 64
(147²×64, 71²×192, 150²×64, 75²×192), the samples that need a cluster of
9–16 blocks.  Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import sys

import numpy as np
import torch

from tensorflowonspark_torch.kernels import _build, group_norm

DEFINES = ("TFOS_GN_PHASE_STAMPS",)
STAMPS = 8  # kStamps in both sources
STAMP_BLOCKS = 4096  # kStampBlocks: blocks whose stamps are kept
GROUPS = 32
#: (name, first stamp, last stamp) of each kernel's phases
PHASES = {
    "forward": (("load and sums", 0, 1), ("to groups", 1, 2),
                ("cluster barrier", 2, 3), ("statistics", 3, 4),
                ("apply", 4, 5), ("exit barrier", 5, 6)),
    "backward": (("sweep", 0, 1), ("to channels", 1, 2),
                 ("cluster barrier", 2, 3),
                 ("reduce, ticket, coefficients", 3, 4), ("apply", 4, 5),
                 ("last ticket", 5, 6), ("exit barrier", 6, 7)),
}
STEM_SHAPES = ((64, 64, 147, 147), (64, 192, 71, 71), (64, 64, 150, 150),
               (64, 192, 75, 75))


def summarize(stamps: np.ndarray, kernel: str) -> dict:
    """From ``(N, k, STAMPS)`` stamps in ns (a sample's cluster of k
    blocks): each phase's mean µs over the blocks, the mean cluster
    lifetime (its first block's first stamp to its last block's last) and
    the span of the call, in µs."""
    last = PHASES[kernel][-1][2]
    t = (stamps.astype(np.int64) - stamps[:, :, 0].min()) / 1e3
    out = {name: float(np.mean(t[:, :, b] - t[:, :, a]))
           for name, a, b in PHASES[kernel]}
    out["cluster lifetime"] = float(np.mean(
        t[:, :, last].max(axis=1) - t[:, :, 0].min(axis=1)))
    out["span"] = float(t[:, :, last].max())
    return out


@contextlib.contextmanager
def stamped_kernels():
    """Inside, the wrapper launches the stamped build (prepared afresh);
    on leaving, the plain build and its caches come back."""
    saved = (group_norm._LIB, group_norm._BWD_LIB,
             set(group_norm._PREPARED), dict(group_norm._CAPACITY))
    load = _build.load
    _build.build_all(("group_norm", "group_norm_bwd"), DEFINES)
    try:
        _build.load = functools.partial(load, defines=DEFINES)
        group_norm._LIB = group_norm._BWD_LIB = None
        group_norm._lib(), group_norm._bwd_lib()
        _build.load = load
        group_norm._PREPARED.clear()
        group_norm._CAPACITY.clear()
        yield {kernel: _build.load(name, DEFINES)
               for kernel, name in (("forward", "group_norm"),
                                    ("backward", "group_norm_bwd"))}
    finally:
        _build.load = load
        (group_norm._LIB, group_norm._BWD_LIB, prepared, capacity) = saved
        group_norm._PREPARED.clear()
        group_norm._PREPARED.update(prepared)
        group_norm._CAPACITY.clear()
        group_norm._CAPACITY.update(capacity)


def read_stamps(lib, kernel: str, n: int, k: int) -> np.ndarray:
    """The last launch's stamps of its first ``n`` clusters of ``k``."""
    buf = (ctypes.c_ulonglong * (STAMP_BLOCKS * STAMPS))()
    err = getattr(lib, f"tfos_gn_{kernel}_phase_stamps")(buf)
    if err:
        raise RuntimeError(f"reading the {kernel} stamps: CUDA error {err}")
    return np.frombuffer(buf, dtype=np.uint64).reshape(
        STAMP_BLOCKS, STAMPS)[:n * k].reshape(n, k, STAMPS)


def _events_ms(fn, calls: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _calls(shape):
    """The forward and backward calls at ``shape`` on seeded inputs."""
    n, c, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw():
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    x, dy = draw(), draw()
    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    y, stats = group_norm._launch(x, gamma, beta, GROUPS, 1e-6, None, True,
                                  keep_stats=True)
    return {"forward": lambda: group_norm._launch(x, gamma, beta, GROUPS,
                                                  1e-6, None, True),
            "backward": lambda: group_norm._launch_backward(
                dy, x, y, gamma, stats, GROUPS, False, True)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("phases: torch.cuda.is_available() is false: this needs a "
              "CUDA card", file=sys.stderr)
        return 1
    shapes = ([tuple(int(v) for v in a.split(",")) for a in argv]
              or STEM_SHAPES)
    device = torch.cuda.current_device()
    for shape in shapes:
        n, c, h, w = shape
        calls = _calls(shape)
        plain_ms = {kernel: _events_ms(fn) for kernel, fn in calls.items()}
        plans = {
            "forward": group_norm._plan(n, h, w, c, GROUPS,
                                        group_norm._capacity("forward",
                                                             device)),
            "backward": group_norm._plan_backward(
                n, h, w, c, GROUPS, group_norm._capacity("backward",
                                                         device))}
        with stamped_kernels() as libs:
            for kernel, fn in calls.items():
                plan = plans[kernel]
                if plan.path != "one_pass" or n * plan.cluster > STAMP_BLOCKS:
                    print(f"phases {kernel} {'x'.join(map(str, shape))}: "
                          f"{plan.path}, {n * plan.cluster} blocks: not "
                          f"stamped")
                    continue
                fn()
                torch.cuda.synchronize()
                got = summarize(read_stamps(libs[kernel], kernel, n,
                                            plan.cluster), kernel)
                at_once = dict(group_norm._capacity(kernel, device)).get(
                    plan.cluster)
                waves = (f"{at_once} at once, {math.ceil(n / at_once)} waves"
                         if at_once else "the card's count not read: k <= 8")
                print(f"phases {kernel} {n}x{h}x{w}x{c}/G{GROUPS}: cluster "
                      f"{plan.cluster} ({waves}); "
                      + "; ".join(f"{name} {us:.2f}"
                                  for name, us in got.items())
                      + f" us (stamped build); the kernel without stamps "
                      f"{plain_ms[kernel] * 1e3:.1f} us (events)",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
