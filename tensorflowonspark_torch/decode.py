"""Token-level continuous batching for generative decode, over a paged
KV-cache pool, on the card.

Reference anchor: ``tensorflowonspark_tpu/decode.py``.  The engine
schedules at TOKEN granularity (the Orca/vLLM discipline): it runs one
batched decode step at a time over its active slots and admits and
retires requests *between steps*.

**Paged KV cache.**  Every sequence's K/V live in fixed-size PAGES
allocated from one pre-sized device pool (``(layers, num_pages,
page_size, heads, head_dim)`` per side, page 0 reserved as the trash
page); each slot owns a page *table* of physical page ids.  Memory is
reserved page-granular at admission (worst case ``ceil((prompt +
max_new) / page_size)`` pages) and returned at retirement — the pool
never grows, and a mid-stream disconnect frees exactly what it held.
The pools are allocated once, at construction: the captured graphs write
them in place, so their bytes and addresses never move until
:meth:`DecodeEngine.stop`.

**Chunked, multi-sequence prefill.**  Prompts are split into page-aligned
chunks drawn from the ``shapes.prefill_chunks`` ladder and each engine
step packs chunks from SEVERAL admitted requests into one prefill call of
fixed ``(max_seqs, chunk_len)`` geometry, interleaved with decode steps,
so every co-tenant's TTFT is bounded by the chunk budget
(``TFOS_PREFILL_CHUNK``), not the longest prompt in flight.
``TFOS_PREFILL_CHUNK=0`` selects the legacy one-prompt-per-call prefill
(pads to ``shapes.prefill_buckets``), kept as the baseline.

**Copy-on-write prefix sharing.**  A bounded registry
(:class:`_PrefixRegistry`, ``TFOS_PREFIX_SHARE`` /
``TFOS_PREFIX_REGISTRY_MAX``) maps completed prompts' page-aligned
prefixes to REFCOUNTED read-only physical pages; admission maps the
longest common token prefix into the new slot's table for free (KV at
position t depends only on tokens ``0..t``, so shared pages are exact).
A prefix that diverges mid-page maps the boundary page too; the first
divergent write copies it into a private page first
(``tinylm.copy_page_fn``).

**Speculative multi-token decoding** (reference ``decode.py:47-69``).
With ``spec_tokens >= 1`` (or ``TFOS_SPEC_TOKENS``) the single-token step
is replaced by propose/verify: a DRAFTER (``spec_drafter`` or
``TFOS_SPEC_DRAFTER``: ``ngram``, host-side prompt lookup, the default;
``model``, a smaller ``tinylm`` shadow-caching into its own pools through
the SAME page tables; ``none``, no drafts) proposes up to ``k`` tokens a
sequence, then ONE verify step (``tinylm.verify_fn``) scores the ``k+1``
positions of every slot and the longest agreeing draft prefix is kept plus
one token of the target's own.  Greedy streams are token for token the
single-token engine's.  A rejected draft rolls back by the write cursor
(``seq_lens``) alone: its K/V stays where the causal mask keeps it unread.
An adaptive controller (:class:`_SpecController`) moves ``k`` down and up
a pre-captured ``shapes.spec_ladder``.

**Seeded sampling** (reference ``decode.py:70-83``).  A request may carry
:class:`SamplingParams`; the host samples from the verify step's logits
(and the prompt's last-position logits for the first token) with
``np.random.default_rng([seed, position])``, so a stream is a pure function
of prompt, parameters and seed.  A draft token is accepted with
probability ``p(draft)``, else the token is resampled from ``p`` without
it: the law of the stream is the target's whatever the drafter.

**One capture per shape.**  Every step's shapes are fixed by the (slot,
page) geometry, so sequence growth moves an integer, never a shape.  The
model's K/V writes and attention run through the hand-written kernels of
``kernels/paged_attention.py``.  On the card each signature (a chunk rung
or prefill bucket, the decode step or a verify rung, the COW copy, and the
model drafter's own under ``draft_`` keys) runs once eagerly and is
captured into one CUDA graph (``parallel.train.CudaGraphs``);
:meth:`DecodeEngine.warmup` does this for every signature up front, after
which serving copies each step's host arrays into the graph's static
inputs and replays — it captures nothing and runs nothing eagerly, the
counterpart of the reference's zero new jit signatures.  A signature met
before ``warmup()`` is run and captured then.  Signatures are counted
through ``serving.note_compile`` as the reference counts them.  On the CPU
(``device="cpu"``) every step runs eagerly unless a stand-in graph
backend is given.

**Phases are separate flight stages** (``prefill_chunk`` or ``prefill``,
and ``decode``, or ``speculate`` and ``verify`` with speculation on, on
the ``"decode"`` plane), tokens stream to callers as they are produced
(:class:`DecodeStream`; chunked HTTP via :class:`DecodeHTTPServer`), and
TTFT/ITL are SLO histograms
(``decode_ttft_seconds`` / ``decode_itl_seconds``) plus the tumbling
windows of the ``/healthz`` ``slo`` block.
"""

from __future__ import annotations

import itertools
import json as _json
import logging
import queue as _queue_mod
import threading
import time
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from tensorflowonspark_torch.obs import journal as _journal
from tensorflowonspark_torch.obs import trace as _trace
from tensorflowonspark_torch.online import Rejected, ShedWindow

logger = logging.getLogger(__name__)

#: TTFT histogram bounds (prefill + queueing: ms to seconds)
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, float("inf"))
#: ITL histogram bounds (one decode step: sub-ms to a second)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
               0.25, 0.5, 1.0, float("inf"))

#: default per-engine pending-request admission bounds (the byte bound:
#: prompt payload bytes held from enqueue to admission; one oversize
#: request admits when the queue is byte-empty)
DEFAULT_MAX_PENDING_REQUESTS = 128
DEFAULT_MAX_PENDING_MB = 8.0
#: default latency SLOs (tail-retention + /healthz)
DEFAULT_TTFT_SLO_MS = 2000.0
DEFAULT_ITL_SLO_MS = 500.0
#: tumbling window for the /healthz slo block's p99s — admission pressure
#: NOW, not the lifetime histogram
SLO_WINDOW_S = 60.0
#: per-token spans listed on a retained trace before truncation
_MAX_TOKEN_SPANS = 32
#: default chunked-prefill budget, in PAGES per chunk row (the
#: ``TFOS_PREFILL_CHUNK`` env knob overrides in tokens; 0 = legacy
#: per-prompt prefill)
DEFAULT_PREFILL_CHUNK_PAGES = 2
#: default prefix-registry entry bound (``TFOS_PREFIX_REGISTRY_MAX``);
#: each entry pins its prefix pages until evicted, so the bound is a
#: KV-memory bound too
DEFAULT_PREFIX_REGISTRY_MAX = 32
#: adaptive speculation controller: windowed acceptance below LOW halves
#: ``k`` (one ladder rung down), above HIGH restores one rung; the gap
#: keeps a borderline drafter from thrashing the rung
SPEC_ACCEPT_LOW = 0.35
SPEC_ACCEPT_HIGH = 0.70
#: acceptance window (seconds) and the proposals it must hold before the
#: controller acts: a cold start is not a cold drafter
SPEC_WINDOW_S = 30.0
SPEC_WINDOW_MIN_PROPOSED = 16

_DONE = object()
_ENGINE_SEQ = itertools.count(1)


def _env_int(name: str, default: int) -> int:
    import os

    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", name, raw)
        return default


def prefix_share_enabled() -> bool:
    """COW prefix sharing on/off (``TFOS_PREFIX_SHARE``, default ON).
    Re-read per engine construction, not cached at import."""
    import os

    return os.environ.get("TFOS_PREFIX_SHARE", "1").strip().lower() \
        not in ("0", "false", "no", "off")


class SamplingParams:
    """Per-request sampling policy for the verify-path token choice.

    ``temperature == 0`` (the default) is GREEDY: pure argmax, no RNG
    drawn, bit-exact against the single-token engine.  With
    ``temperature > 0`` the next token is sampled from the softmax of
    ``logits / temperature``, optionally truncated to the ``top_k``
    highest-probability tokens (0 = off) and/or the smallest nucleus
    covering ``top_p`` probability mass (1.0 = off), renormalized.

    ``seed`` keys a per-request RNG folded with the token's ABSOLUTE
    position (``np.random.default_rng([seed, position])``), so the
    stream is a pure function of (prompt, params, seed) — replayable
    across engine restarts, independent of slot placement, batch
    composition, and scheduling.  Sampling rides the speculative verify
    path (it needs logits, which the argmax-only decode step never
    brings to the host), so it requires ``spec_tokens >= 1``;
    ``spec_drafter="none"`` gives sampling without speculation.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _sampling_dist(logits: np.ndarray, sp: SamplingParams) -> np.ndarray:
    """The target distribution ``p`` a sampling request draws from:
    temperature-scaled softmax, then top-k / top-p truncation,
    renormalized.  float64 host math — the distribution must be a
    deterministic function of the float32 logits alone, never of batch
    shape or device reduction order."""
    z = np.asarray(logits, np.float64) / max(sp.temperature, 1e-6)
    z = z - z.max()
    p = np.exp(z)
    p /= p.sum()
    if sp.top_k and sp.top_k < p.shape[0]:
        kth = np.sort(p)[-sp.top_k]
        p = np.where(p >= kth, p, 0.0)
        p /= p.sum()
    if sp.top_p < 1.0:
        order = np.argsort(-p, kind="stable")
        keep = int(np.searchsorted(np.cumsum(p[order]),
                                   sp.top_p - 1e-12) + 1)
        mask = np.zeros(p.shape[0], bool)
        mask[order[:keep]] = True
        p = np.where(mask, p, 0.0)
        p /= p.sum()
    return p


class PagedKVPool:
    """Fixed-size page allocator over a pre-sized device buffer pair.

    Page 0 is the TRASH page: never allocated, the target of every
    unallocated page-table slot, so out-of-range writes (prompt padding,
    inactive slots) land where nothing is ever read.  Allocation is
    page-granular with worst-case reservation at admission — no
    mid-flight preemption, no fragmentation (any free page serves any
    sequence; the page table is the indirection).

    Pages are REFCOUNTED: :meth:`alloc` hands out pages at refcount 1,
    :meth:`share` (prefix sharing mapping one physical page into
    several slots' tables) increments, and :meth:`free` DECREMENTS —
    the page returns to the free list only at zero.  Every holder frees
    exactly the references it took, so a shared page's
    "double free" is impossible by construction: the hazard the
    refcount exists to remove is two tables releasing one physical page
    twice.  Releasing a reference nobody holds (refcount already zero)
    still raises loudly — that is a real bookkeeping bug, not sharing.

    :meth:`invariant` states the conservation law (every page is
    exactly one of trash / free-with-refcount-0 / used-with-positive
    refcount) as a JSON-able dict for ``/healthz``;
    :meth:`check_invariant` raises on violation and is asserted at
    engine shutdown and in every decode test teardown.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        self.num_pages = int(num_pages)
        self._free: list[int] = list(range(1, self.num_pages))
        self._refs: list[int] = [0] * self.num_pages
        self.peak_used = 0
        #: cumulative pages ever allocated — with prefix sharing this
        #: grows SUB-LINEARLY in requests served (shared prefixes alloc
        #: once), which is the bench round's unique-page claim
        self.alloc_total = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Physical pages mapped by more than one holder."""
        return sum(1 for r in self._refs if r > 1)

    @property
    def logical_pages(self) -> int:
        """Total page REFERENCES outstanding (what non-shared
        allocation would have cost): sum of refcounts."""
        return sum(r for r in self._refs if r > 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.alloc_total += n
        self.peak_used = max(self.peak_used, self.used_pages)
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Take one additional reference on each page (all-or-nothing:
        validated before any refcount moves)."""
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            if self._refs[p] <= 0:
                raise ValueError(f"share of unallocated page {p}")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Release one reference per listed page; a page returns to the
        free list when its last reference drops.  Validated up front
        COUNTING DUPLICATES (freeing ``[p, p]`` against one reference
        must not leave a negative refcount behind a partial mutation)."""
        from collections import Counter

        want = Counter(pages)
        for p, k in want.items():
            if not 1 <= p < self.num_pages:
                raise ValueError(f"bad page id {p}")
            if self._refs[p] < k:
                raise ValueError(
                    f"double free of page {p} ({k} releases, "
                    f"{self._refs[p]} references held)")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def invariant(self) -> dict[str, Any]:
        """The conservation law as data (no raise — the ``/healthz``
        surface): ``used + free + trash == num_pages``, refcounts
        non-negative, the free list duplicate-free with refcount 0."""
        free = len(self._free)
        used = self.num_pages - 1 - free
        referenced = sum(1 for p in range(1, self.num_pages)
                         if self._refs[p] > 0)
        negative = sum(1 for r in self._refs if r < 0)
        free_clean = (len(set(self._free)) == free
                      and all(self._refs[p] == 0 for p in self._free))
        ok = (negative == 0 and referenced == used and free_clean
              and self._refs[0] == 0
              and used + free + 1 == self.num_pages)
        return {"ok": ok, "pages_used": used, "pages_free": free,
                "pages_trash": 1, "num_pages": self.num_pages,
                "referenced": referenced, "negative_refcounts": negative}

    def check_invariant(self) -> dict[str, Any]:
        doc = self.invariant()
        if not doc["ok"]:
            raise RuntimeError(f"KV pool invariant violated: {doc}")
        return doc


class _PrefixRegistry:
    """Bounded LRU of completed prompts' page-aligned prefixes →
    refcounted read-only physical pages (the COW prefix-sharing map).

    Entries are keyed by the token-hash of the full prefix (the dict
    hash of its byte form) with the exact token array stored alongside
    — a hash collision can therefore never alias two prefixes, and
    :meth:`lookup` matches by longest common TOKEN prefix, so a new
    prompt reuses an entry's pages even when it diverges partway
    through (the divergence page is what COW copies).  Each entry holds
    one pool reference per page (taken in :meth:`register`, released on
    eviction / :meth:`clear`), so a registered prefix outlives the
    request that produced it but never outlives the registry bound.

    Engine-thread only — admission, registration, and eviction all run
    on the step loop, which is what makes lookup-then-share atomic
    without a lock of its own.
    """

    def __init__(self, pool: PagedKVPool, page_size: int,
                 max_entries: int = DEFAULT_PREFIX_REGISTRY_MAX):
        from collections import OrderedDict

        self._pool = pool
        self._page_size = int(page_size)
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[bytes, tuple[np.ndarray, list[int]]]"
        self._entries = OrderedDict()
        self.hits = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pinned_pages(self) -> int:
        """Unique physical pages currently pinned by registry entries —
        what a drained engine's ``used_pages`` legitimately holds."""
        return len({p for _, pages in self._entries.values()
                    for p in pages})

    def register(self, tokens: np.ndarray, pages: Sequence[int]) -> bool:
        """Pin ``pages`` (one reference each) as the read-only KV of
        ``tokens``; evicts LRU entries past the bound.  No-op (LRU
        touch) when the exact prefix is already registered."""
        key = tokens.tobytes()
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        self._pool.share(pages)
        self._entries[key] = (np.array(tokens, np.int32), list(pages))
        while len(self._entries) > self.max_entries:
            _, (_, old) = self._entries.popitem(last=False)
            self._pool.free(old)
            self.evictions += 1
        return True

    def lookup(self, prompt: np.ndarray, cap: int
               ) -> tuple[int, list[int]]:
        """Longest common token prefix of ``prompt`` against every
        entry, capped at ``cap`` tokens (callers pass
        ``prompt_len - 1`` so a fully-registered prompt still computes
        its last position — the logits that mint the first token).

        Returns ``(matched_tokens, pages)`` where ``pages`` covers the
        match (``ceil(matched / page_size)`` entries — the last one
        PARTIAL when the match ends mid-page; that page must be COW'd
        before the slot's first write).  ``(0, [])`` when the best
        match is under one page — mapping a page to reuse less than a
        page of KV costs a copy for nothing.  The caller takes its own
        references via ``pool.share``.
        """
        best_m, best_key, best_pages = 0, None, []
        for key, (tok, pages) in self._entries.items():
            k = min(len(tok), int(cap))
            if k <= best_m:
                continue
            eq = tok[:k] == prompt[:k]
            m = k if eq.all() else int(np.argmax(~eq))
            if m > best_m:
                n_map = -(-m // self._page_size)
                best_m, best_key, best_pages = m, key, pages[:n_map]
        if best_m < self._page_size:
            return 0, []
        self._entries.move_to_end(best_key)
        self.hits += 1
        return best_m, list(best_pages)

    def clear(self) -> None:
        """Release every pinned page (engine shutdown)."""
        while self._entries:
            _, (_, pages) = self._entries.popitem(last=False)
            self._pool.free(pages)


class _SpecController:
    """Windowed-acceptance adaptive controller over the speculation ladder
    (``shapes.spec_ladder``; reference ``decode.py:512``): halves ``k``
    when the drafter goes cold, restores it one rung at a time when it
    recovers.

    Every rung is captured at warmup, so moving between rungs never meets
    a new signature.  The window clears on every shift (fresh evidence at
    the new rung) and the controller refuses to act on fewer than
    ``SPEC_WINDOW_MIN_PROPOSED`` windowed proposals.  Callers hold the
    engine lock.
    """

    __slots__ = ("ladder", "rung", "window_s", "shifts", "_samples")

    def __init__(self, ladder: Sequence[int],
                 window_s: float = SPEC_WINDOW_S):
        self.ladder = tuple(int(k) for k in ladder)
        if not self.ladder:
            raise ValueError("empty speculation ladder")
        self.rung = len(self.ladder) - 1  # start at the configured k
        self.window_s = float(window_s)
        self.shifts = 0
        self._samples: list[tuple[float, int, int]] = []

    @property
    def k(self) -> int:
        return self.ladder[self.rung]

    def _trim(self, now: float) -> None:
        cut = now - self.window_s
        i = 0
        for i, (ts, _, _) in enumerate(self._samples):
            if ts >= cut:
                break
        else:
            i = len(self._samples)
        if i:
            del self._samples[:i]

    def acceptance(self, now: float | None = None) -> float | None:
        """Windowed acceptance rate (accepted / proposed), ``None`` until
        anything was proposed in the window."""
        self._trim(time.time() if now is None else now)
        proposed = sum(p for _, p, _ in self._samples)
        if not proposed:
            return None
        return round(sum(a for _, _, a in self._samples) / proposed, 4)

    def note(self, proposed: int, accepted: int,
             now: float | None = None) -> None:
        now = time.time() if now is None else now
        self._samples.append((now, int(proposed), int(accepted)))
        self._trim(now)
        total = sum(p for _, p, _ in self._samples)
        if total < SPEC_WINDOW_MIN_PROPOSED:
            return
        rate = sum(a for _, _, a in self._samples) / total
        if rate < SPEC_ACCEPT_LOW and self.rung > 0:
            self.rung -= 1
            self.shifts += 1
            self._samples.clear()
        elif rate > SPEC_ACCEPT_HIGH and self.rung < len(self.ladder) - 1:
            self.rung += 1
            self.shifts += 1
            self._samples.clear()


class _NullDrafter:
    """The ``none`` drafter (reference ``decode.py:581``): proposes
    nothing, every step verifies one position: the sampling-capable
    single-token engine."""

    kind = "none"

    def warmup(self, engine: "DecodeEngine") -> None:
        pass

    def on_prefill_chunk(self, engine, tokens, starts, lens,
                         tables) -> None:
        pass

    def on_cow(self, engine, src: int, dst: int) -> None:
        pass

    def propose_all(self, engine: "DecodeEngine",
                    rows: "list[_DecodeRequest]",
                    k: int) -> dict[int, list[int]]:
        return {}


class _NgramDrafter(_NullDrafter):
    """Prompt-lookup drafter (reference ``decode.py:604``): no second
    model, no device work.  For each sequence, the most recent earlier
    occurrence of its trailing n-gram (longest first, down to one token)
    in its own history (prompt and generated tokens) proposes the ``k``
    tokens that followed it; novel text proposes nothing."""

    kind = "ngram"
    #: longest trailing n-gram tried first
    max_ngram = 3

    def propose_all(self, engine: "DecodeEngine",
                    rows: "list[_DecodeRequest]",
                    k: int) -> dict[int, list[int]]:
        return {req.slot: self._propose_one(req.history, k)
                for req in rows}

    @classmethod
    def _propose_one(cls, hist: list[int], k: int) -> list[int]:
        L = len(hist)
        for n in range(min(cls.max_ngram, L - 1), 0, -1):
            pat = hist[-n:]
            # most recent occurrence ENDING strictly before the last
            # position (the trailing n-gram itself)
            for i in range(L - 2, n - 2, -1):
                if hist[i - n + 1: i + 1] == pat:
                    return hist[i + 1: i + 1 + k]
        return []


class _ModelDrafter(_NullDrafter):
    """Draft-model drafter (reference ``decode.py:640-798``): a smaller
    ``tinylm`` sharing the target's vocab proposes ``k`` tokens through
    ``k`` fixed-shape draft decode steps.

    The draft model shadow-caches into its OWN pools (sized by its own
    head geometry) through the target engine's page tables, so the target
    pool's refcounts cover both caches.  Its chunk step, decode step and
    page copy are the engine's programs (``DecodeEngine._run``) under
    ``draft_``-prefixed keys, so on the card each is one captured CUDA
    graph and its signatures stay apart from the target's in
    ``serving.note_compile``.

    One departure from the reference: there, a step that accepts all ``k``
    drafts leaves the draft cache one position short (its ``k`` steps
    write the last token and the first ``k - 1`` drafts, not the
    ``k``-th), and later proposals attend over that stale position.  Here
    each row first writes the positions its draft cache lacks, in as many
    more steps (one at most), which the rows not behind spend proposing a
    token they drop.  The draft cache then holds every position the
    target's holds, so a drafter with the target's weights proposes the
    target's tokens."""

    kind = "model"

    def __init__(self, engine: "DecodeEngine", config=None, params=None,
                 seed: int = 0):
        from tensorflowonspark_torch.models import tinylm

        self.config = config or tinylm.Config.draft_for(engine.config)
        if self.config.vocab_size != engine.config.vocab_size:
            raise ValueError(
                f"draft vocab {self.config.vocab_size} != target vocab "
                f"{engine.config.vocab_size} — proposals must be target "
                "tokens")
        if self.config.max_len < engine.max_len:
            raise ValueError(
                f"draft max_len {self.config.max_len} < engine max_len "
                f"{engine.max_len} — the shadow cache mirrors the "
                "target's positions")
        if params is None:
            params = tinylm.init_params(self.config, seed=seed)
        self._params = {k: torch.as_tensor(v).detach().to(engine.device)
                        for k, v in params.items()}
        shape = tinylm.kv_pool_shape(self.config, engine.num_pages,
                                     engine.page_size)
        self._kp = torch.zeros(shape, dtype=torch.float32,
                               device=engine.device)
        self._vp = torch.zeros(shape, dtype=torch.float32,
                               device=engine.device)
        #: slot -> (request, the last position its draft cache holds)
        self._frontier: dict[int, tuple] = {}
        #: draft decode steps run, catch-up steps included
        self.steps = 0

    def warmup(self, engine: "DecodeEngine") -> None:
        S, P = engine.max_seqs, engine.pages_per_seq
        for rung in engine.prefill_chunks:
            engine._run("draft_chunk", {
                "draft_tokens": np.zeros((S, rung), np.int32),
                "draft_start_lens": np.zeros((S,), np.int32),
                "draft_chunk_lens": np.zeros((S,), np.int32),
                "draft_page_tables": np.zeros((S, P), np.int32)})
        engine._run("draft_decode", {
            "draft_tokens": np.zeros((S,), np.int32),
            "draft_seq_lens": np.zeros((S,), np.int32),
            "draft_page_tables": np.zeros((S, P), np.int32)})
        if engine.share_prefixes:
            z = np.asarray(0, np.int32)
            engine._run("draft_cow", {"draft_src": z, "draft_dst": z})

    def on_prefill_chunk(self, engine, tokens, starts, lens,
                         tables) -> None:
        """Mirror the target's prefill chunk into the shadow cache."""
        engine._run("draft_chunk", {
            "draft_tokens": tokens, "draft_start_lens": starts,
            "draft_chunk_lens": lens, "draft_page_tables": tables})

    def on_cow(self, engine, src: int, dst: int) -> None:
        """Mirror a COW page copy: the shadow cache shares the target's
        page tables."""
        engine._run("draft_cow", {"draft_src": np.asarray(src, np.int32),
                                  "draft_dst": np.asarray(dst, np.int32)})

    def propose_all(self, engine: "DecodeEngine",
                    rows: "list[_DecodeRequest]",
                    k: int) -> dict[int, list[int]]:
        """Sequential fixed-shape draft decode steps over ALL slots at
        once, each proposing one more token a sequence: ``k``, and one
        more when a row's draft cache lacks the position its last step
        accepted in full.  Idle and prefilling slots ride along writing to
        the trash page (zero table rows), as in the target's decode
        step."""
        toks = engine._tokens.copy()
        seqs = engine._seq_lens.copy()
        feed: dict[int, list[int]] = {}
        for req in rows:
            s = req.slot
            n = int(seqs[s])
            last = self._frontier.get(s)
            start = (min(n, last[1] + 1) if last is not None
                     and last[0] is req else n)
            # position p holds history[p]; n is the last emitted token's
            feed[s] = req.history[start:n + 1]
            seqs[s] = start
        steps = k + max(len(f) for f in feed.values()) - 1
        out: dict[int, list[int]] = {s: [] for s in feed}
        for j in range(steps):
            for s, f in feed.items():
                toks[s] = f[j] if j < len(f) else out[s][-1]
            nts, _ = engine._run("draft_decode", {
                "draft_tokens": toks, "draft_seq_lens": seqs,
                "draft_page_tables": engine._ptables})
            self.steps += 1
            for s, f in feed.items():
                if j >= len(f) - 1:
                    out[s].append(int(nts[s]))
            seqs = seqs + 1
        for req in rows:
            self._frontier[req.slot] = (req, int(seqs[req.slot]) - 1)
        return {s: v[:k] for s, v in out.items()}


def make_drafter(engine: "DecodeEngine", kind: str, *, draft_config=None,
                 draft_params=None, seed: int = 0) -> _NullDrafter:
    """Drafter factory behind the one interface the engine speaks
    (reference ``decode.py:800``): ``warmup`` / ``on_prefill_chunk`` /
    ``on_cow`` / ``propose_all``."""
    if kind == "ngram":
        return _NgramDrafter()
    if kind == "model":
        return _ModelDrafter(engine, config=draft_config,
                             params=draft_params, seed=seed)
    if kind == "none":
        return _NullDrafter()
    raise ValueError(f"unknown drafter kind {kind!r} "
                     "(expected 'ngram', 'model', or 'none')")


class _DecodeRequest:
    """One caller's generation: prompt in, streamed tokens out."""

    __slots__ = ("prompt", "prompt_len", "max_new_tokens", "nbytes",
                 "queue", "cancelled", "generated", "t_submit",
                 "t_submit_wall", "t_admit", "t_last", "ttft_s",
                 "max_itl_s", "error", "rt", "slot", "pages", "done",
                 "tenant", "prefill_pos", "start_pos", "shared_pages",
                 "cow_index", "table", "sampling", "history")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 rt: "_trace.RequestTrace | None",
                 tenant: str = "default",
                 sampling: SamplingParams | None = None):
        self.tenant = tenant
        self.prompt = prompt
        self.prompt_len = int(prompt.shape[0])
        self.max_new_tokens = int(max_new_tokens)
        self.nbytes = int(prompt.nbytes)
        self.queue: _queue_mod.Queue = _queue_mod.Queue()
        self.cancelled = False
        self.generated = 0
        self.t_submit = time.perf_counter()
        self.t_submit_wall = time.time()
        self.t_admit = 0.0
        self.t_last = 0.0
        self.ttft_s: float | None = None
        self.max_itl_s = 0.0
        self.error: BaseException | None = None
        self.rt = rt
        self.slot: int | None = None
        self.pages: list[int] = []
        self.done = False
        # chunked-prefill phase state: tokens [0, prefill_pos) are in
        # the cache (shared prefix pages and/or completed chunks); the
        # request enters the decode phase at prefill_pos == prompt_len
        self.prefill_pos = 0
        self.start_pos = 0            # prefill_pos at admission
        self.shared_pages = 0         # prefix pages mapped for free
        self.cow_index: int | None = None  # table index pending COW
        self.table: np.ndarray | None = None  # this slot's page table
        self.sampling = sampling  # None = greedy
        # full token history (prompt + emitted): the prompt-lookup
        # drafter's corpus and the model drafter's catch-up tokens
        self.history: list[int] = [int(t) for t in prompt]


class DecodeStream:
    """Caller-side handle: iterate tokens as they arrive, or collect.

    ``cancel()`` mid-stream (the client-disconnect path) retires the
    request at the next step boundary and returns its KV pages to the
    pool — generation for everyone else is unaffected.
    """

    def __init__(self, req: _DecodeRequest):
        self._req = req

    @property
    def trace_id(self) -> str | None:
        return self._req.rt.ctx.trace_id if self._req.rt else None

    def cancel(self) -> None:
        self._req.cancelled = True
        _journal.emit("decode.cancel", slot=self._req.slot,
                      generated=self._req.generated,
                      tenant=self._req.tenant,
                      **({"trace_id": self.trace_id}
                         if self.trace_id else {}))

    def __iter__(self):
        return self.tokens()

    def tokens(self, timeout: float = 60.0):
        """Yield generated token ids; raises the engine's error on
        failure, ``TimeoutError`` when no token arrives in ``timeout``."""
        while True:
            try:
                item = self._req.queue.get(timeout=timeout)
            except _queue_mod.Empty:
                raise TimeoutError(
                    f"no token within {timeout}s (engine overloaded or "
                    "stopped?)") from None
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise RuntimeError(f"decode failed: {item!r}") from item
            yield item

    def result(self, timeout: float = 120.0) -> list[int]:
        """Block until generation completes; all tokens in order."""
        deadline = time.perf_counter() + timeout
        out: list[int] = []
        for tok in self.tokens(timeout=timeout):
            out.append(tok)
            if time.perf_counter() > deadline:
                self.cancel()
                raise TimeoutError(f"generation exceeded {timeout}s")
        return out


class _LatencyWindow:
    """Tumbling time-window latency samples → windowed quantiles.

    The ``/healthz`` ``slo`` block's p99 source: bounded (time + count),
    so a breach long past cannot keep a replica shed forever — the
    stale-evidence trap the mesh admission design documents.  Callers
    hold the engine lock.
    """

    __slots__ = ("window_s", "maxlen", "_samples")

    def __init__(self, window_s: float = SLO_WINDOW_S, maxlen: int = 4096):
        self.window_s = float(window_s)
        self.maxlen = int(maxlen)
        self._samples: list[tuple[float, float]] = []

    def note(self, seconds: float, now: float | None = None) -> None:
        now = time.time() if now is None else now
        self._samples.append((now, float(seconds)))
        if len(self._samples) > self.maxlen:
            del self._samples[: len(self._samples) - self.maxlen]

    def _trim(self, now: float) -> None:
        cut = now - self.window_s
        i = 0
        for i, (ts, _) in enumerate(self._samples):
            if ts >= cut:
                break
        else:
            i = len(self._samples)
        if i:
            del self._samples[:i]

    def quantile_ms(self, q: float, now: float | None = None
                    ) -> float | None:
        now = time.time() if now is None else now
        self._trim(now)
        if not self._samples:
            return None
        vals = sorted(v for _, v in self._samples)
        idx = min(len(vals) - 1, int(q * len(vals)))
        return round(vals[idx] * 1000, 3)

    def count(self, now: float | None = None) -> int:
        self._trim(time.time() if now is None else now)
        return len(self._samples)


class _Staged:
    """One signature's inputs on the engine's device: int32 views of one
    buffer (the static inputs a captured graph reads), refreshed from a
    pinned host twin by one copy a step."""

    def __init__(self, arrays: dict[str, np.ndarray], device: torch.device):
        self.layout: dict[str, tuple[int, int]] = {}
        shapes_of = {}
        off = 0
        for name, a in arrays.items():
            n = int(np.prod(np.shape(a), dtype=np.int64))
            self.layout[name] = (off, n)
            shapes_of[name] = tuple(np.shape(a))
            off += n
        on_card = device.type == "cuda"
        self.device_buf = torch.zeros(off, dtype=torch.int32, device=device)
        self.host_buf = torch.zeros(off, dtype=torch.int32,
                                    pin_memory=on_card)
        self._host = self.host_buf.numpy()
        self.views = {name: self.device_buf[o:o + n].view(shapes_of[name])
                      for name, (o, n) in self.layout.items()}
        #: the last copy out of the host twin: the next refresh waits for
        #: it before writing there (a COW step fetches nothing back)
        self._copied = torch.cuda.Event() if on_card else None

    def refresh(self, arrays: dict[str, np.ndarray]) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            o, n = self.layout[name]
            self._host[o:o + n] = np.asarray(a).reshape(-1)
        self.device_buf.copy_(self.host_buf, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class _Program(NamedTuple):
    """One signature's step: its static inputs, its graph (None where
    there are no graphs: the CPU runs the step eagerly) and the graph's
    output (None for the COW copy)."""
    staged: _Staged
    graph: Any
    out: Any


class DecodeEngine:
    """Continuous-batching generative decode engine (see module doc).

    Lifecycle: construct (pools and weights on the device, bound to the
    fixed geometry) → :meth:`warmup` (run and capture every ladder shape;
    after this, serving captures nothing) → :meth:`start` → concurrent
    :meth:`submit` → :meth:`stop` (fails every in-flight request loudly;
    all pages return to the pool).

    Geometry: ``max_seqs`` decode slots per step; pages of ``page_size``
    tokens; ``max_len`` total positions per sequence (prompt +
    generation); the pool defaults to worst-case sizing (every slot at
    ``max_len``) plus the trash page.

    ``device``: the card by default (``util.select_device``: raises where
    there is none), ``"cpu"`` for the CPU.  ``graphs``: the CUDA graph
    backend (``parallel.train.CudaGraphs`` on the card, none on the CPU;
    the CPU tests pass a stand-in).  ``params``: the flat name → tensor
    (or array) dict, by default ``tinylm.init_params(config, seed)``.
    """

    def __init__(self, config=None, params=None, *,
                 model_name: str = "tiny_lm",
                 max_seqs: int = 8, page_size: int = 16,
                 max_len: int | None = None,
                 num_pages: int | None = None,
                 max_prompt_len: int | None = None,
                 prefill_bucket_sizes: Sequence[int] | None = None,
                 eos_id: int | None = None,
                 max_pending_requests: int = DEFAULT_MAX_PENDING_REQUESTS,
                 max_pending_mb: float = DEFAULT_MAX_PENDING_MB,
                 ttft_slo_ms: float = DEFAULT_TTFT_SLO_MS,
                 itl_slo_ms: float = DEFAULT_ITL_SLO_MS,
                 prefill_chunk: int | None = None,
                 share_prefixes: bool | None = None,
                 prefix_registry_max: int | None = None,
                 spec_tokens: int | None = None,
                 spec_drafter: str | None = None,
                 draft_config=None, draft_params=None,
                 seed: int = 0, device=None, graphs=None):
        import os

        from tensorflowonspark_torch import obs, shapes, util
        from tensorflowonspark_torch.models import tinylm

        self.device = util.select_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config or tinylm.Config.tiny()
        self.model_name = model_name
        if params is None:
            params = tinylm.init_params(self.config, seed=seed)
        self._params = {k: torch.as_tensor(v).detach().to(self.device)
                        for k, v in params.items()}
        self.max_seqs = int(max_seqs)
        self.page_size = int(page_size)
        self.max_len = int(max_len or self.config.max_len)
        if self.max_len > self.config.max_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's positional "
                f"capacity {self.config.max_len}")
        self.pages_per_seq = -(-self.max_len // self.page_size)
        self.num_pages = int(num_pages if num_pages is not None
                             else 1 + self.max_seqs * self.pages_per_seq)
        self.max_prompt_len = int(max_prompt_len or self.max_len // 2)
        if self.max_prompt_len >= self.max_len:
            raise ValueError("max_prompt_len must leave room to generate "
                             f"({self.max_prompt_len} >= {self.max_len})")
        self.prefill_buckets = (
            tuple(sorted({int(b) for b in prefill_bucket_sizes}))
            if prefill_bucket_sizes else
            shapes.prefill_buckets(self.max_prompt_len, cap=self.max_len))
        if self.prefill_buckets[-1] < self.max_prompt_len:
            raise ValueError("prefill ladder does not cover "
                             f"max_prompt_len {self.max_prompt_len}")
        self.eos_id = eos_id
        self.max_pending_requests = int(max_pending_requests)
        self.max_pending_bytes = int(max_pending_mb * (1 << 20))
        self.ttft_slo_s = float(ttft_slo_ms) / 1000.0
        self.itl_slo_s = float(itl_slo_ms) / 1000.0

        # chunked-prefill geometry: the chunk budget (tokens a prompt
        # may advance per engine step) comes from the argument, else
        # the TFOS_PREFILL_CHUNK env, else a pages-based default;
        # 0 selects the legacy one-prompt-per-call prefill
        if prefill_chunk is None:
            prefill_chunk = _env_int(
                "TFOS_PREFILL_CHUNK",
                DEFAULT_PREFILL_CHUNK_PAGES * self.page_size)
        self.chunked_prefill = int(prefill_chunk) != 0
        self.prefill_chunks = (
            shapes.prefill_chunks(self.max_prompt_len, self.page_size,
                                  max_chunk=int(prefill_chunk))
            if self.chunked_prefill else ())
        # prefix sharing rides the chunk scheduler (the legacy prefill
        # writes every position from 0, which would mutate shared
        # pages), so it is forced off in legacy mode
        if share_prefixes is None:
            share_prefixes = prefix_share_enabled()
        self.share_prefixes = bool(share_prefixes) and self.chunked_prefill
        if prefix_registry_max is None:
            prefix_registry_max = _env_int("TFOS_PREFIX_REGISTRY_MAX",
                                           DEFAULT_PREFIX_REGISTRY_MAX)
        self.prefix_registry_max = int(prefix_registry_max)

        # speculative decoding geometry: the configured draft length
        # (TFOS_SPEC_TOKENS; 0 = the single-token step) and the drafter
        # (TFOS_SPEC_DRAFTER: ngram | model | none).  Speculation rides
        # the chunk scheduler's phase discipline (prefill-phase slots
        # carry zero table rows, so the verify step's writes for them
        # land in trash), so it requires chunked prefill
        if spec_tokens is None:
            spec_tokens = _env_int("TFOS_SPEC_TOKENS", 0)
        self.spec_tokens = max(0, int(spec_tokens))
        if self.spec_tokens and not self.chunked_prefill:
            raise ValueError(
                "speculative decoding requires chunked prefill "
                "(spec_tokens >= 1 with prefill_chunk == 0)")
        self.spec_ladder = (shapes.spec_ladder(self.spec_tokens)
                            if self.spec_tokens else ())
        if spec_drafter is None:
            spec_drafter = os.environ.get(
                "TFOS_SPEC_DRAFTER", "ngram").strip().lower() or "ngram"
        self.spec_drafter = (str(spec_drafter)
                             if self.spec_tokens else "off")

        # the note_compile identity: one per engine INSTANCE — each engine
        # captures its own graphs
        self.cache_key = ("decode", model_name, self.max_seqs,
                          self.page_size, self.pages_per_seq,
                          self.prefill_buckets, self.prefill_chunks,
                          self.share_prefixes, self.spec_ladder,
                          self.spec_drafter, next(_ENGINE_SEQ))

        pool_shape = tinylm.kv_pool_shape(self.config, self.num_pages,
                                          self.page_size)
        self._kp = torch.zeros(pool_shape, dtype=torch.float32,
                               device=self.device)
        self._vp = torch.zeros(pool_shape, dtype=torch.float32,
                               device=self.device)
        #: bytes of the two pre-sized pools — fixed at init; the
        #: zero-device-buffer-growth tests assert this never moves
        self.kv_pool_bytes = 2 * int(np.prod(pool_shape)) * 4
        self.pool = PagedKVPool(self.num_pages)
        self._registry = (
            _PrefixRegistry(self.pool, self.page_size,
                            max_entries=self.prefix_registry_max)
            if self.share_prefixes else None)

        # one program a signature: static inputs, graph, output; captured
        # at its first sighting, right after its eager call
        from tensorflowonspark_torch.parallel.train import (CudaGraphs,
                                                            SignatureGraphs)

        if graphs is None and self.device.type == "cuda":
            graphs = CudaGraphs()
        self._graphs = graphs
        self._programs = SignatureGraphs(capture_at=1)
        #: signatures captured, steps replayed, steps run eagerly (each
        #: signature's first sighting, and every CPU step without graphs)
        self.captures = 0
        self.replays = 0
        self.eager_calls = 0

        # the drafter and the adaptive-k controller (speculation only);
        # the model drafter allocates its shadow pools here, once
        self._drafter = (make_drafter(self, self.spec_drafter,
                                      draft_config=draft_config,
                                      draft_params=draft_params, seed=seed)
                         if self.spec_tokens else None)
        self._spec_ctl = (_SpecController(self.spec_ladder)
                          if self.spec_tokens else None)

        # host-side slot state, mutated between steps (fixed shapes: the
        # arrays are reused, never reallocated)
        S, P = self.max_seqs, self.pages_per_seq
        self._tokens = np.zeros((S,), np.int32)
        self._seq_lens = np.zeros((S,), np.int32)
        self._ptables = np.zeros((S, P), np.int32)
        self._slots: list[_DecodeRequest | None] = [None] * S
        self._active = 0
        #: slots still in the prefill phase; their ``_ptables`` rows
        #: stay ZERO (and ``_seq_lens`` 0) until the phase flips, so
        #: the decode step's writes for them land in the trash page —
        #: never in a mapped (possibly shared) page
        self._prefilling = 0

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_DecodeRequest] = []
        self._pending_bytes = 0
        self._started = False
        self._started_ts = 0.0
        self._stopped = False
        self._thread: threading.Thread | None = None
        self._warmed = False
        self._warming = False
        self.shed_window = ShedWindow()
        self._ttft_window = _LatencyWindow()
        self._itl_window = _LatencyWindow()

        self._requests_total = obs.counter(
            "decode_requests_total", "generation requests admitted")
        self._tokens_total = obs.counter(
            "decode_tokens_total", "tokens generated and emitted")
        self._shed_total = obs.counter(
            "decode_shed_total",
            "generation requests shed by admission control (explicit "
            "429-style rejections, never silent drops)")
        self._errors_total = obs.counter(
            "decode_errors_total",
            "engine step failures (every affected caller got the error)")
        self._cancelled_total = obs.counter(
            "decode_cancelled_total",
            "generations cancelled mid-stream (client disconnects)")
        self._ttft_hist = obs.histogram(
            "decode_ttft_seconds",
            "submit -> first generated token (queueing + prefill)",
            buckets=TTFT_BUCKETS)
        self._itl_hist = obs.histogram(
            "decode_itl_seconds",
            "gap between consecutive generated tokens (one decode step "
            "plus scheduling)", buckets=ITL_BUCKETS)
        self._active_g = obs.gauge(
            "decode_active_seqs", "sequences occupying decode slots")
        self._pending_g = obs.gauge(
            "decode_pending_requests", "requests queued for admission")
        self._pages_used_g = obs.gauge(
            "decode_kv_pages_used", "KV pages currently allocated")
        obs.gauge("decode_kv_pages_total",
                  "allocatable KV pages (pool size minus the trash "
                  "page)").set(self.num_pages - 1)
        obs.gauge("decode_kv_pool_bytes",
                  "bytes of the pre-sized device KV pools (fixed at "
                  "engine init)").set(self.kv_pool_bytes)
        #: device bytes per KV page (both pools)
        self._page_bytes = self.kv_pool_bytes // max(1, self.num_pages)
        self._kv_bytes_g = obs.gauge(
            "decode_kv_bytes_resident",
            "device bytes of KV cache resident in allocated pages "
            "(pages used x per-page bytes; unique PHYSICAL pages — "
            "prefix-shared pages count once)")
        self._kv_bytes_g.set(0)
        self._prefix_hits_total = obs.counter(
            "decode_prefix_hits_total",
            "admissions that mapped a registered prompt prefix")
        self._prefix_shared_total = obs.counter(
            "decode_prefix_shared_pages_total",
            "KV pages mapped from the prefix registry instead of "
            "allocated (each one is a page of prefill compute and "
            "pool memory not spent)")
        self._cow_copies_total = obs.counter(
            "decode_cow_copies_total",
            "copy-on-write page copies (a shared prefix diverged "
            "mid-page; the boundary page was copied before the first "
            "divergent write)")
        self._pages_alloc_total = obs.counter(
            "decode_kv_pages_allocated_total",
            "cumulative pages allocated from the pool (sub-linear in "
            "requests when prefixes share)")
        self._shared_pages_g = obs.gauge(
            "decode_kv_pages_shared",
            "physical pages currently mapped by more than one holder")
        self._spec_proposed_total = obs.counter(
            "decode_spec_proposed_total",
            "draft tokens proposed to the speculative verify step")
        self._spec_accepted_total = obs.counter(
            "decode_spec_accepted_total",
            "draft tokens accepted by the verify step (the longest "
            "agreeing prefix; acceptance/proposed is the drafter's "
            "hit rate)")
        self._spec_steps_total = obs.counter(
            "decode_spec_steps_total",
            "speculative verify steps run (each emits >= 1 token per "
            "live sequence)")
        self._spec_emitted_total = obs.counter(
            "decode_spec_emitted_total",
            "tokens emitted by speculative verify steps (accepted "
            "drafts plus the bonus token each sequence mints per step)")
        self._spec_k_g = obs.gauge(
            "decode_spec_k",
            "current adaptive draft length k (0 = speculation off)")
        self._spec_k_g.set(self._spec_ctl.k if self._spec_ctl else 0)

    # -- shape policy --------------------------------------------------------

    def enumerate_signatures(self) -> list[tuple]:
        """The complete signature set this engine's runtime requests:
        one per chunk-ladder rung (or prefill bucket in legacy mode),
        exactly ONE for the decode step (or, with speculation on, one
        verify step per ``spec_ladder`` rung instead, plus the model
        drafter's own chunk, decode and COW set), and one for the COW
        page copy when prefix sharing is on.  What :meth:`warmup` runs
        and captures, and what steady-state serving must not grow."""
        return enumerate_signatures(
            max_seqs=self.max_seqs, pages_per_seq=self.pages_per_seq,
            prefill_buckets=(None if self.chunked_prefill
                             else self.prefill_buckets),
            prefill_chunks=(self.prefill_chunks
                            if self.chunked_prefill else None),
            share_prefixes=self.share_prefixes,
            spec_ladder=self.spec_ladder or None,
            spec_drafter=self.spec_drafter)

    def warmup(self) -> None:
        """Run and capture every ladder shape now: each chunk rung (or
        prefill bucket in legacy mode; zero tokens through the trash page
        — no allocation), the COW page copy when sharing is on (the trash
        page onto itself), and the decode step; a speculating engine
        captures one verify step a ladder rung instead of the decode step
        (it never issues it), then the drafter's own set.  Each signature
        counts
        through ``serving.note_compile`` and its first call's wall (the
        eager call and the capture) through
        ``serving.observe_compile_seconds``, as warmed (before any
        request)."""
        self._warming = True
        try:
            self._warm_all()
        finally:
            self._warming = False
        self._warmed = True

    def _warm_all(self) -> None:
        S, P = self.max_seqs, self.pages_per_seq
        if self.chunked_prefill:
            # zero chunk_lens route every warm write to the trash page
            for rung in self.prefill_chunks:
                self._run("chunk", {
                    "tokens": np.zeros((S, rung), np.int32),
                    "start_lens": np.zeros((S,), np.int32),
                    "chunk_lens": np.zeros((S,), np.int32),
                    "page_tables": np.zeros((S, P), np.int32)})
            if self.share_prefixes:
                z = np.asarray(0, np.int32)
                self._run("cow", {"src": z, "dst": z})
        else:
            for b in self.prefill_buckets:
                self._run("prefill", {
                    "tokens": np.zeros((b,), np.int32),
                    "prompt_len": np.asarray(1, np.int32)},
                    {"page_table": np.zeros((P,), np.int32)})
        if self.spec_tokens:
            for k in self.spec_ladder:
                self._run("verify", {
                    "tokens": np.zeros((S, k + 1), np.int32),
                    "seq_lens": np.zeros((S,), np.int32),
                    "step_lens": np.zeros((S,), np.int32),
                    "page_tables": np.zeros((S, P), np.int32)})
            self._drafter.warmup(self)
        else:
            self._run("decode", {"tokens": self._tokens,
                                 "seq_lens": self._seq_lens,
                                 "page_tables": self._ptables})

    def _run(self, kind: str, batch: dict[str, np.ndarray],
             extra: dict[str, np.ndarray] | None = None):
        """One step of ``kind`` (``chunk``, ``prefill``, ``decode``,
        ``verify``, ``cow``, or the model drafter's ``draft_chunk``,
        ``draft_decode``, ``draft_cow``) on ``batch`` (signed) plus
        ``extra`` (inputs that do not sign, as the reference's jit takes
        the legacy page table):
        ``(host output or None, fresh)``.  A signature's first sighting
        runs the step eagerly (its output is this call's) and, with graphs,
        captures it; later sightings copy the arrays into the static
        inputs and replay."""
        from tensorflowonspark_torch import serving, shapes

        fresh = serving.note_compile(self.cache_key, batch,
                                     warm=self._warming)
        arrays = {**batch, **(extra or {})}
        sig = shapes.signature(batch)
        prog, _ = self._programs.sight(sig)
        if prog is None:
            t0 = time.perf_counter()
            staged = _Staged(arrays, self.device)
            staged.refresh(arrays)
            host = _fetch(self._call(kind, staged.views))
            self.eager_calls += 1
            graph = out = None
            if self._graphs is not None:
                graph, out = self._graphs.capture(
                    lambda: self._call(kind, staged.views))
                self.captures += 1
            self._programs.captured[sig] = _Program(staged, graph, out)
            if fresh:
                serving.observe_compile_seconds(time.perf_counter() - t0)
            return host, fresh
        self._refresh(prog.staged, arrays)
        if prog.graph is None:
            self.eager_calls += 1
            return _fetch(self._call(kind, prog.staged.views)), fresh
        self._graphs.replay(prog.graph)
        self.replays += 1
        return _fetch(prog.out), fresh

    @staticmethod
    def _refresh(staged: _Staged, arrays: dict[str, np.ndarray]) -> None:
        staged.refresh(arrays)

    def _call(self, kind: str, v: dict[str, torch.Tensor]):
        """The model function of ``kind`` on the static inputs ``v``,
        writing the pools in place; its output tensor (None for ``cow``).
        A ``draft_`` kind runs the model drafter's weights over its own
        pools, its inputs under ``draft_`` keys; its chunk step returns
        None (nothing reads the draft's prompt logits)."""
        from tensorflowonspark_torch.models import tinylm

        params, kp, vp, config = (self._params, self._kp, self._vp,
                                  self.config)
        draft = kind.startswith("draft_")
        if draft:
            d = self._drafter
            params, kp, vp, config = d._params, d._kp, d._vp, d.config
            kind = kind[len("draft_"):]
            v = {name[len("draft_"):]: t for name, t in v.items()}
        geo = {"config": config, "page_size": self.page_size}
        with torch.no_grad():
            if kind == "chunk":
                out = tinylm.prefill_chunk_fn(
                    params, v["tokens"], v["start_lens"], v["chunk_lens"],
                    kp, vp, v["page_tables"], **geo)[0]
                return None if draft else out
            if kind == "prefill":
                return tinylm.prefill_fn(
                    params, v["tokens"], v["prompt_len"], kp, vp,
                    v["page_table"], **geo)[0]
            if kind == "decode":
                return tinylm.decode_fn(
                    params, v["tokens"], v["seq_lens"], kp, vp,
                    v["page_tables"], **geo)[0]
            if kind == "verify":
                return tinylm.verify_fn(
                    params, v["tokens"], v["seq_lens"], v["step_lens"], kp,
                    vp, v["page_tables"], **geo)[0]
            tinylm.copy_page_fn(kp, vp, v["src"], v["dst"])
            return None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "DecodeEngine":
        with self._cond:
            if self._stopped:
                raise RuntimeError("DecodeEngine is stopped")
            if self._started:
                return self
            self._started = True
            # monotonic, not wall clock: the fleet plane's young-replica
            # exemption reads this uptime
            self._started_ts = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name="tfos-decode-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop serving: every pending and in-flight generation fails
        with an explicit error, every page returns to the pool, and the
        captured graphs are released (the pools stay)."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        err = RuntimeError("decode engine stopped")
        with self._cond:
            pending, self._pending = self._pending, []
            self._pending_bytes = 0
        for req in pending:
            self._finish(req, "error", err)
        for s in range(self.max_seqs):
            req = self._slots[s]
            if req is not None:
                self._retire(s, "error", err)
        if self._registry is not None:
            self._registry.clear()
        self._programs.clear()
        self._pending_g.set(0)
        self._active_g.set(0)
        self._pages_used_g.set(self.pool.used_pages)
        self._kv_bytes_g.set(self.pool.used_pages * self._page_bytes)
        self._shared_pages_g.set(self.pool.shared_pages)
        # every reference is back: page conservation + non-negative
        # refcounts must hold here or the allocator lost track of a
        # page — fail the shutdown loudly rather than hide a leak
        self.pool.check_invariant()

    # -- request path --------------------------------------------------------

    def submit(self, prompt: Sequence[int] | np.ndarray,
               max_new_tokens: int = 16,
               trace_ctx: "_trace.TraceContext | None" = None,
               tenant: str = "default",
               sampling: SamplingParams | None = None) -> DecodeStream:
        """Queue one generation; returns a :class:`DecodeStream` whose
        tokens arrive as the engine produces them.

        ``sampling`` selects seeded sampling for this request
        (:class:`SamplingParams`); ``None`` and temperature 0 mean greedy.
        Non-greedy sampling needs the verify path's per-position logits,
        so it requires a speculating engine (``spec_tokens >= 1``; the
        ``"none"`` drafter gives sampling without speculation).

        Raises ``ValueError`` for malformed prompts (empty, over the
        ladder, out-of-vocab ids, no room to generate) and
        :class:`~tensorflowonspark_torch.online.Rejected` when admission
        control sheds (pending queue over its request or byte bound) —
        shedding is loud by design, callers back off and retry.

        ``tenant`` names the cost-accounting payer: the engine's step
        wall apportions to it by tokens emitted
        (:mod:`tensorflowonspark_torch.obs.ledger`), and the slot
        lifecycle journal events carry it.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        max_new_tokens = int(max_new_tokens)
        if plen < 1:
            raise ValueError("prompt must carry at least one token")
        if plen > self.max_prompt_len:
            raise ValueError(
                f"prompt length {plen} exceeds max_prompt_len "
                f"{self.max_prompt_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if plen + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {plen} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.max_len}")
        need = -(-(plen + max_new_tokens) // self.page_size)
        if need > self.num_pages - 1:
            # a request the pool can NEVER satisfy must be refused here:
            # admission is strict FIFO, so an unsatisfiable head would
            # wedge the queue forever while /healthz still says serving
            raise ValueError(
                f"request needs {need} KV pages worst-case (prompt "
                f"{plen} + max_new_tokens {max_new_tokens} at page_size "
                f"{self.page_size}) but the pool holds "
                f"{self.num_pages - 1} — size num_pages up or the "
                "request down")
        if prompt.min() < 0 or prompt.max() >= self.config.vocab_size:
            raise ValueError(
                f"prompt token ids must be in [0, "
                f"{self.config.vocab_size})")
        if (sampling is not None and not sampling.greedy
                and not self.spec_tokens):
            raise ValueError(
                "sampling needs the verify path's per-position logits: "
                "construct the engine with spec_tokens >= 1 (the "
                "'none' drafter gives sampling without speculation)")

        rt = None
        if _trace.requests_enabled():
            armed = trace_ctx is not None or _trace.arm_roll()
            if armed:
                rt = _trace.RequestTrace(
                    "decode.request", ctx=trace_ctx,
                    prompt_len=plen, max_new_tokens=max_new_tokens)
        req = _DecodeRequest(prompt, max_new_tokens, rt,
                             tenant=str(tenant), sampling=sampling)
        with self._cond:
            if not self._started or self._stopped:
                raise RuntimeError("DecodeEngine is not serving "
                                   "(start() it / already stopped)")
            over_count = len(self._pending) >= self.max_pending_requests
            over_bytes = (self._pending_bytes > 0
                          and self._pending_bytes + req.nbytes
                          > self.max_pending_bytes)
            if over_count or over_bytes:
                self.shed_window.note(shed=True)
                self._shed_total.inc()
                exc = Rejected(
                    f"decode pending queue over its "
                    f"{'request' if over_count else 'byte'} bound "
                    f"({len(self._pending)} pending, "
                    f"{self._pending_bytes} bytes); request shed — back "
                    "off and retry",
                    retry_after_s=max(0.05, self.itl_slo_s))
            else:
                exc = None
                self._pending.append(req)
                self._pending_bytes += req.nbytes
                self.shed_window.note(shed=False)
                self._requests_total.inc()
                self._pending_g.inc()
                self._cond.notify()
        if exc is not None:
            if rt is not None:
                rt.add("admission", time.perf_counter() - req.t_submit,
                       outcome="shed", pending=len(self._pending))
                rt.finish(status="shed", error=str(exc)[:300])
                _trace.get_trace_store().commit(rt, retain="shed")
            raise exc
        return DecodeStream(req)

    # -- engine loop ---------------------------------------------------------

    def _loop(self) -> None:
        from tensorflowonspark_torch.obs import flight

        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        rec = flight.recorder("decode")
        perf = time.perf_counter
        while True:
            wait_s = 0.0
            admits: list[_DecodeRequest] = []
            with self._cond:
                if self._stopped:
                    return
                self._reap_cancelled_locked()
                admits = self._admit_locked()
                if not admits and not self._active:
                    # idle: wait in SHORT slices, each committed as its
                    # own flight record (a submit's notify ends the slice
                    # early; the timeout bounds how long a pending-side
                    # cancel can go unreaped)
                    t0 = perf()
                    self._cond.wait(timeout=0.05)
                    wait_s = perf() - t0
            if wait_s:
                rec.add(wait=wait_s)
                rec.commit()
                continue
            chunked = self.chunked_prefill
            try:
                # stage windows cover the WHOLE phase — the step plus
                # token delivery and retirement bookkeeping — so the
                # plane's stage sum reconciles with the wall
                t0 = perf()
                if chunked:
                    for req in admits:
                        self._admit_one(req)
                    if self._prefilling:
                        self._prefill_chunk_step()
                else:
                    for req in admits:
                        self._prefill_one(req)
                t1 = perf()
                prefill_s = t1 - t0
                spec_s = verify_s = decode_s = 0.0
                if self._active - self._prefilling > 0:
                    if self.spec_tokens:
                        spec_s, verify_s = self._spec_step()
                    else:
                        self._decode_step()
                        decode_s = perf() - t1
            except Exception as e:  # a broken step must not wedge callers
                self._errors_total.inc()
                logger.warning("decode engine step failed: %r", e)
                self._fail_all(e)
                continue
            if prefill_s or decode_s or spec_s or verify_s:
                if self.spec_tokens:
                    rec.add(prefill_chunk=prefill_s, speculate=spec_s,
                            verify=verify_s)
                elif chunked:
                    rec.add(prefill_chunk=prefill_s, decode=decode_s)
                else:
                    rec.add(prefill=prefill_s, decode=decode_s)
                rec.commit()
            self._active_g.set(self._active)
            self._pages_used_g.set(self.pool.used_pages)
            self._kv_bytes_g.set(self.pool.used_pages * self._page_bytes)
            self._shared_pages_g.set(self.pool.shared_pages)

    def _pages_needed(self, req: _DecodeRequest) -> int:
        return -(-(req.prompt_len + req.max_new_tokens) // self.page_size)

    def _reap_cancelled_locked(self) -> None:
        kept = []
        for req in self._pending:
            if req.cancelled:
                self._pending_bytes -= req.nbytes
                self._pending_g.dec()
                self._cancelled_total.inc()
                self._finish(req, "cancelled", None)
            else:
                kept.append(req)
        self._pending = kept
        for s in range(self.max_seqs):
            req = self._slots[s]
            if req is not None and req.cancelled:
                self._cancelled_total.inc()
                self._retire(s, "cancelled", None)

    def _admit_locked(self) -> list[_DecodeRequest]:
        """Pop admissible pending requests into free slots — strictly
        FIFO (skipping the head for a smaller request behind it would
        starve long prompts under sustained load)."""
        admits: list[_DecodeRequest] = []
        budget = self.pool.free_pages  # allocs happen later, in
        # _admit_one / _prefill_one — the feasibility check must charge
        # THIS batch's earlier admits or the second could over-commit
        while self._pending and self._active + len(admits) < self.max_seqs:
            req = self._pending[0]
            need = self._pages_needed(req)
            if need > budget:
                break
            budget -= need
            self._pending.pop(0)
            self._pending_bytes -= req.nbytes
            self._pending_g.dec()
            admits.append(req)
        return admits

    def _admit_one(self, req: _DecodeRequest) -> None:
        """Assign a slot and map its page table (chunked mode): shared
        prefix pages for free, fresh pages for the rest.  No model
        compute here — the chunk scheduler owns that, so admission cost
        stays flat however long the prompt is."""
        t0 = time.perf_counter()
        slot = self._slots.index(None)
        need = self._pages_needed(req)
        matched: int = 0
        shared: list[int] = []
        if self._registry is not None:
            matched, shared = self._registry.lookup(
                req.prompt, req.prompt_len - 1)
        fresh = self.pool.alloc(need - len(shared))
        if shared:
            self.pool.share(shared)
        self._pages_alloc_total.inc(need - len(shared))
        req.slot = slot
        req.pages = list(shared) + fresh
        req.t_admit = t0
        req.prefill_pos = req.start_pos = matched
        req.shared_pages = len(shared)
        # a match ending mid-page maps that boundary page shared; the
        # slot's first write lands in it, so it is COW-pending
        req.cow_index = (matched // self.page_size
                         if matched % self.page_size else None)
        row = np.zeros((self.pages_per_seq,), np.int32)
        row[: len(req.pages)] = req.pages
        req.table = row
        self._slots[slot] = req
        self._active += 1
        self._prefilling += 1
        if matched:
            self._prefix_hits_total.inc()
            self._prefix_shared_total.inc(len(shared))
        if req.rt is not None:
            req.rt.add("queue", t0 - req.t_submit,
                       pending_depth=len(self._pending))
        _journal.emit(
            "decode.admit", slot=slot, pages=len(req.pages),
            prompt_len=req.prompt_len, tenant=req.tenant,
            queue_s=round(t0 - req.t_submit, 6),
            shared_pages=req.shared_pages, prefix_tokens=matched,
            **({"trace_id": req.rt.ctx.trace_id} if req.rt else {}))

    def _cow_resolve(self, req: _DecodeRequest) -> None:
        """The first divergent write into a shared page: copy it to a
        private page (one captured step) and swap the table entry, so the
        registered read-only page is never mutated.  Skipped when the
        reference turned exclusive in the meantime (registry eviction) —
        writing in place is safe then."""
        if req.cow_index is None:
            return
        idx, req.cow_index = req.cow_index, None
        old = req.pages[idx]
        if self.pool.refcount(old) <= 1:
            return
        new = self.pool.alloc(1)[0]
        self._pages_alloc_total.inc()
        self._run("cow", {"src": np.asarray(old, np.int32),
                          "dst": np.asarray(new, np.int32)})
        self.pool.free([old])
        if self._drafter is not None:
            # the drafter's shadow cache shares this page table, so its
            # copy of the page must move too (no-op for host drafters)
            self._drafter.on_cow(self, old, new)
        req.pages[idx] = new
        req.table[idx] = new
        self._cow_copies_total.inc()
        _journal.emit("decode.cow_copy", slot=req.slot, page=old,
                      copy=new, tenant=req.tenant)

    def _prefill_chunk_step(self) -> None:
        """ONE fixed-shape multi-sequence prefill call: pack the next
        chunk of every prefill-phase slot (COW-resolving any shared
        boundary page about to be written), advance each, and flip
        completed prompts into the decode phase.  The chunk length is
        the smallest ladder rung covering the largest packed chunk, so
        post-warmup calls meet no new signature."""
        from tensorflowonspark_torch import shapes

        perf = time.perf_counter
        t0 = perf()
        rows = [r for r in self._slots
                if r is not None and r.prefill_pos < r.prompt_len]
        if not rows:
            return
        for req in rows:
            self._cow_resolve(req)
        S, P = self.max_seqs, self.pages_per_seq
        top = self.prefill_chunks[-1]
        L = shapes.choose_bucket(
            max(min(r.prompt_len - r.prefill_pos, top) for r in rows),
            self.prefill_chunks)
        tokens = np.zeros((S, L), np.int32)
        starts = np.zeros((S,), np.int32)
        lens = np.zeros((S,), np.int32)
        tables = np.zeros((S, P), np.int32)
        packed: list[tuple[_DecodeRequest, int]] = []
        nbytes = 0
        for i, req in enumerate(rows):
            n = min(req.prompt_len - req.prefill_pos, L)
            tokens[i, :n] = req.prompt[req.prefill_pos:
                                       req.prefill_pos + n]
            starts[i] = req.prefill_pos
            lens[i] = n
            tables[i] = req.table
            packed.append((req, n))
            if req.prefill_pos == req.start_pos:
                nbytes += req.nbytes  # first chunk carries the payload
        logits, fresh = self._run(
            "chunk", {"tokens": tokens, "start_lens": starts,
                      "chunk_lens": lens, "page_tables": tables})
        dt = perf() - t0
        if self._drafter is not None:
            # mirror the chunk into the drafter's shadow cache (no-op for
            # host-side drafters) so its proposals see the prompt
            self._drafter.on_prefill_chunk(self, tokens, starts, lens,
                                           tables)
        from tensorflowonspark_torch.obs import ledger as _ledger_mod

        _ledger_mod.get_ledger().charge_decode(
            [(req.tenant, n) for req, n in packed], dt,
            compile_s=dt if fresh else 0.0, nbytes=nbytes)
        for i, (req, n) in enumerate(packed):
            pos = req.prefill_pos
            req.prefill_pos = pos + n
            if req.rt is not None:
                # per-chunk TTFT attribution: which chunk of which
                # prompt spent the time before the first token
                req.rt.add("prefill_chunk", dt / len(packed),
                           pos=pos, tokens=n, chunk_len=L)
            if req.prefill_pos >= req.prompt_len:
                self._finish_prefill(req, logits[i])

    def _finish_prefill(self, req: _DecodeRequest,
                        logits_row: np.ndarray) -> None:
        """Prompt fully in cache: flip the slot into the decode phase
        (its real page table becomes decode-visible only now — see
        ``_prefilling``) and emit the first generated token, chosen
        from the prompt's last-position logits (host argmax, the
        reference's)."""
        tok = self._choose_token(req, logits_row, req.prompt_len)
        slot = req.slot
        self._prefilling -= 1
        self._seq_lens[slot] = req.prompt_len
        self._tokens[slot] = tok
        self._ptables[slot][:] = req.table
        self._register_prefix(req)
        _journal.emit(
            "decode.prefill", slot=slot, tenant=req.tenant,
            prompt_len=req.prompt_len, from_pos=req.start_pos,
            shared_pages=req.shared_pages,
            **({"trace_id": req.rt.ctx.trace_id} if req.rt else {}))
        self._emit(req, tok)
        if req.generated >= req.max_new_tokens or (
                self.eos_id is not None and tok == self.eos_id):
            self._retire(slot, "ok", None)

    def _register_prefix(self, req: _DecodeRequest) -> None:
        """Publish this prompt's page-aligned prefix for future
        admissions.  Only FULL pages register: the page holding the
        prompt tail keeps taking decode writes, so sharing it would
        leak generated KV into other tenants' context."""
        if self._registry is None:
            return
        reg_tokens = (req.prompt_len // self.page_size) * self.page_size
        if reg_tokens < self.page_size:
            return
        self._registry.register(
            req.prompt[:reg_tokens],
            req.pages[: reg_tokens // self.page_size])

    def _prefill_one(self, req: _DecodeRequest) -> None:
        from tensorflowonspark_torch import shapes

        perf = time.perf_counter
        t0 = perf()
        slot = self._slots.index(None)
        pages = self.pool.alloc(self._pages_needed(req))
        self._pages_alloc_total.inc(len(pages))
        req.slot, req.pages = slot, pages
        req.t_admit = t0
        req.prefill_pos = req.prompt_len  # legacy: decode phase at once
        row = self._ptables[slot]
        row[:] = 0
        row[: len(pages)] = pages
        bucket = shapes.choose_bucket(req.prompt_len, self.prefill_buckets)
        padded = np.zeros((bucket,), np.int32)
        padded[: req.prompt_len] = req.prompt
        nt, fresh = self._run(
            "prefill", {"tokens": padded,
                        "prompt_len": np.asarray(req.prompt_len, np.int32)},
            {"page_table": row})
        tok = int(nt)
        dt = perf() - t0
        # prefill wall is this request's alone (one sequence at a time);
        # a fresh signature's capture rides the same tenant
        from tensorflowonspark_torch.obs import ledger as _ledger_mod

        _ledger_mod.get_ledger().charge_decode(
            [(req.tenant, 1)], dt,
            compile_s=dt if fresh else 0.0, nbytes=req.nbytes)
        if req.rt is not None:
            req.rt.add("queue", req.t_admit - req.t_submit,
                       pending_depth=len(self._pending))
            req.rt.add("prefill", dt, bucket=bucket,
                       prompt_len=req.prompt_len, pages=len(pages))
        self._slots[slot] = req
        self._active += 1
        self._seq_lens[slot] = req.prompt_len
        self._tokens[slot] = tok
        _journal.emit(
            "decode.admit", slot=slot, pages=len(pages),
            prompt_len=req.prompt_len, tenant=req.tenant,
            queue_s=round(req.t_admit - req.t_submit, 6),
            **({"trace_id": req.rt.ctx.trace_id} if req.rt else {}))
        self._emit(req, tok)
        if req.generated >= req.max_new_tokens or (
                self.eos_id is not None and tok == self.eos_id):
            self._retire(slot, "ok", None)

    def _decode_step(self) -> None:
        perf = time.perf_counter
        t0 = perf()
        nts, fresh = self._run("decode", {"tokens": self._tokens,
                                          "seq_lens": self._seq_lens,
                                          "page_tables": self._ptables})
        dt = perf() - t0
        # step wall splits across the live slots by tokens emitted (one
        # each this step); a capture's wall books to the first live
        # slot's tenant — the request whose step met the new signature
        from tensorflowonspark_torch.obs import ledger as _ledger_mod

        # prefill-phase slots ride the step with zero seq_len and a
        # zero table row (writes land in trash); their outputs are
        # garbage — skip them here, the chunk scheduler owns them
        shares = [(req.tenant, 1) for req in self._slots
                  if req is not None and req.prefill_pos >= req.prompt_len]
        _ledger_mod.get_ledger().charge_decode(
            shares, dt, compile_s=dt if fresh else 0.0)
        for s in range(self.max_seqs):
            req = self._slots[s]
            if req is None or req.prefill_pos < req.prompt_len:
                continue
            tok = int(nts[s])
            self._seq_lens[s] += 1
            self._tokens[s] = tok
            self._emit(req, tok)
            if req.generated >= req.max_new_tokens or (
                    self.eos_id is not None and tok == self.eos_id):
                self._retire(s, "ok", None)

    def _spec_step(self) -> tuple[float, float]:
        """One speculative engine step (reference ``decode.py:1913``): the
        drafter proposes up to ``k`` tokens a decode-phase slot (the
        *speculate* flight stage), then ONE verify replay scores the
        ``k+1`` positions of every slot and each slot keeps its longest
        agreeing prefix plus one token of the target's (the *verify*
        stage).

        Rollback is host bookkeeping: the write cursor (``_seq_lens``)
        advances only over accepted positions, so a rejected draft's K/V
        sits beyond every later read mask until a later step overwrites
        it.  Draft writes land only in the slot's private pages (shared
        prefix pages were COW-resolved first).  Greedy streams are token
        for token the single-token engine's; sampled ones resample a
        rejected draft from the rest of the target distribution.

        Returns ``(speculate_s, verify_s)`` for the flight recorder."""
        perf = time.perf_counter
        t0 = perf()
        rows = [r for r in self._slots
                if r is not None and r.prefill_pos >= r.prompt_len]
        if not rows:
            return 0.0, 0.0
        k = self._spec_ctl.k
        for req in rows:  # a no-op after prefill, kept for the COW law
            self._cow_resolve(req)
        proposals = self._drafter.propose_all(self, rows, k)
        S = self.max_seqs
        tokens = np.zeros((S, k + 1), np.int32)
        step_lens = np.zeros((S,), np.int32)
        drafts: dict[int, list[int]] = {}
        proposed = 0
        for req in rows:
            s = req.slot
            # clamp so full acceptance (d+1 emitted) never exceeds the
            # request's max_new budget: the last write position stays
            # inside the admitted page reservation
            room = max(0, req.max_new_tokens - req.generated - 1)
            d = [int(t) for t in proposals.get(s, [])][:min(k, room)]
            drafts[s] = d
            tokens[s, 0] = self._tokens[s]
            tokens[s, 1:1 + len(d)] = d
            step_lens[s] = 1 + len(d)
            proposed += len(d)
        t1 = perf()
        logits, fresh = self._run(
            "verify", {"tokens": tokens, "seq_lens": self._seq_lens,
                       "step_lens": step_lens,
                       "page_tables": self._ptables})
        run_s = perf() - t1
        self._spec_steps_total.inc()
        # prefill-phase slots rode the call with zero step_lens and a zero
        # table row (trash writes); only decode-phase rows emit
        accepted_total = 0
        emissions: list[tuple[_DecodeRequest, list[int]]] = []
        for req in rows:
            s = req.slot
            d = drafts[s]
            n0 = int(self._seq_lens[s])
            emitted: list[int] = []
            for j in range(len(d) + 1):
                tok = self._choose_token(req, logits[s, j], n0 + j + 1,
                                         d[j] if j < len(d) else None)
                emitted.append(tok)
                if j < len(d) and tok == d[j]:
                    continue
                break
            if self.eos_id is not None and self.eos_id in emitted:
                # the single-token engine stops at EOS: tokens past it
                # were never generated there, so they don't count
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            accepted_total += len(emitted) - 1
            self._seq_lens[s] = n0 + len(emitted)
            self._tokens[s] = emitted[-1]
            emissions.append((req, emitted))
        from tensorflowonspark_torch.obs import ledger as _ledger_mod

        _ledger_mod.get_ledger().charge_decode(
            [(req.tenant, len(em)) for req, em in emissions], run_s,
            compile_s=run_s if fresh else 0.0)
        n_emitted = 0
        for req, emitted in emissions:
            for tok in emitted:
                self._emit(req, tok)
                n_emitted += 1
                if req.generated >= req.max_new_tokens or (
                        self.eos_id is not None and tok == self.eos_id):
                    self._retire(req.slot, "ok", None)
                    break
        self._spec_proposed_total.inc(proposed)
        self._spec_accepted_total.inc(accepted_total)
        self._spec_emitted_total.inc(n_emitted)
        if proposed:
            # under the stats lock: acceptance() readers come from the
            # stats/healthz threads
            with self._lock:
                self._spec_ctl.note(proposed, accepted_total)
            self._spec_k_g.set(self._spec_ctl.k)
        return t1 - t0, perf() - t1

    def _choose_token(self, req: _DecodeRequest,
                      logits_row: np.ndarray, position: int,
                      draft_tok: int | None = None) -> int:
        """Pick the next token from one position's logits (reference
        ``decode.py:2029``).

        Greedy (no sampling params, or temperature 0) is a plain host
        argmax (the first maximum, as the device's).  Sampling derives its
        RNG from ``(seed, position)``, the token's ABSOLUTE position, so a
        stream replays identically however generation was split into
        speculative steps.  A draft token goes through speculative
        rejection sampling: accepted with probability ``p(draft)``, else
        the token is drawn from ``p`` with the draft excluded and
        renormalized, which composes to exactly ``p`` for any
        deterministic proposal."""
        sp = req.sampling
        if sp is None or sp.greedy:
            return int(np.argmax(logits_row))
        p = _sampling_dist(logits_row, sp)
        rng = np.random.default_rng([sp.seed, int(position)])
        if draft_tok is not None:
            if rng.random() < p[draft_tok]:
                return int(draft_tok)
            q = p.copy()
            q[draft_tok] = 0.0
            tot = q.sum()
            if tot <= 0.0:
                return int(draft_tok)  # p was a point mass on the draft
            return int(rng.choice(len(q), p=q / tot))
        return int(rng.choice(len(p), p=p))

    def _emit(self, req: _DecodeRequest, tok: int) -> None:
        now = time.perf_counter()
        req.generated += 1
        if req.ttft_s is None:
            req.ttft_s = now - req.t_submit
            # exemplar only on an SLO-breaching observation of an armed
            # request: a breach guarantees _finish retains the trace
            self._ttft_hist.observe(
                req.ttft_s,
                exemplar=({"trace_id": req.rt.ctx.trace_id}
                          if req.rt is not None
                          and req.ttft_s > self.ttft_slo_s else None))
            with self._lock:
                self._ttft_window.note(req.ttft_s)
        else:
            itl = now - req.t_last
            req.max_itl_s = max(req.max_itl_s, itl)
            self._itl_hist.observe(
                itl,
                exemplar=({"trace_id": req.rt.ctx.trace_id}
                          if req.rt is not None
                          and itl > self.itl_slo_s else None))
            with self._lock:
                self._itl_window.note(itl)
            if req.rt is not None and req.generated <= _MAX_TOKEN_SPANS:
                req.rt.add("token", itl, index=req.generated - 1,
                           itl_ms=round(itl * 1000, 3))
        req.t_last = now
        self._tokens_total.inc()
        req.history.append(int(tok))
        if not req.cancelled:
            req.queue.put(tok)

    def _retire(self, slot: int, status: str,
                err: BaseException | None) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._active -= 1
        if req.prefill_pos < req.prompt_len:
            self._prefilling -= 1  # cancelled/failed mid-prefill
        self._seq_lens[slot] = 0
        self._tokens[slot] = 0
        self._ptables[slot][:] = 0
        req.table = None
        if req.pages:
            self.pool.free(req.pages)
            req.pages = []
        self._pages_used_g.set(self.pool.used_pages)
        self._kv_bytes_g.set(self.pool.used_pages * self._page_bytes)
        self._active_g.set(self._active)
        _journal.emit(
            "decode.retire", slot=slot, status=status,
            tokens=req.generated, tenant=req.tenant,
            **({"trace_id": req.rt.ctx.trace_id} if req.rt else {}))
        self._finish(req, status, err)

    def _finish(self, req: _DecodeRequest, status: str,
                err: BaseException | None) -> None:
        if req.done:
            return
        req.done = True
        req.error = err
        rt = req.rt
        if rt is not None:
            lat = time.perf_counter() - req.t_submit
            rt.finish(status=status, tokens=req.generated,
                      ttft_ms=(round(req.ttft_s * 1000, 3)
                               if req.ttft_s is not None else None),
                      latency_ms=round(lat * 1000, 3),
                      **({"error": f"{type(err).__name__}: {err}"[:300]}
                         if err else {}))
            if status != "ok":
                retain = status
            elif ((req.ttft_s is not None
                   and req.ttft_s > self.ttft_slo_s)
                  or req.max_itl_s > self.itl_slo_s):
                retain = "slo_breach"
            else:
                retain = None  # commit's own uniform-sample roll applies
            _trace.get_trace_store().commit(rt, retain=retain)
        req.queue.put(err if err is not None else _DONE)

    def _fail_all(self, err: BaseException) -> None:
        with self._cond:
            pending, self._pending = self._pending, []
            self._pending_bytes = 0
        for req in pending:
            self._pending_g.dec()
            self._finish(req, "error", err)
        for s in range(self.max_seqs):
            if self._slots[s] is not None:
                self._retire(s, "error", err)

    # -- introspection -------------------------------------------------------

    @property
    def state(self) -> str:
        if self._stopped:
            return "stopped"
        return "serving" if self._started else "created"

    def slo_snapshot(self, now: float | None = None) -> dict[str, Any]:
        """The windowed-latency ``slo`` block: TTFT/ITL p99 over the
        last ``SLO_WINDOW_S`` seconds against their SLOs — what the mesh
        router's admission check reads (windowed, so it CLEARS when
        pressure does; the lifetime histograms stay on /metrics)."""
        with self._lock:
            return {
                "ttft_p99_ms": self._ttft_window.quantile_ms(0.99, now),
                "itl_p99_ms": self._itl_window.quantile_ms(0.99, now),
                "ttft_slo_ms": round(self.ttft_slo_s * 1000, 3),
                "itl_slo_ms": round(self.itl_slo_s * 1000, 3),
                "window_s": SLO_WINDOW_S,
                "samples": self._ttft_window.count(now),
                "itl_samples": self._itl_window.count(now),
                # windowed draft acceptance (None when speculation is off
                # or nothing was proposed lately): the fleet's signal of a
                # drafter gone cold on the live workload
                "spec_acceptance_rate": (
                    self._spec_ctl.acceptance(now)
                    if self._spec_ctl is not None else None),
            }

    def stats(self) -> dict[str, Any]:
        """JSON-able engine state (the ``/healthz`` body), in the
        reference's schema.  ``compile_cache`` carries the process's
        ``serving.cache_health()`` (the kernel library cache's state, the
        signature counters, ``warm_ratio``) and this engine's
        signatures, captures, replays and eager steps; ``uptime_s`` says
        how long this engine has served."""
        from tensorflowonspark_torch import serving

        with self._lock:
            pending = len(self._pending)
            pending_bytes = self._pending_bytes
            window = self.shed_window.snapshot()
        slo = self.slo_snapshot()
        used = self.pool.used_pages
        total = self.num_pages - 1
        shared = self.pool.shared_pages
        logical = self.pool.logical_pages
        invariant = self.pool.invariant()
        reg = self._registry
        return {
            "state": self.state,
            "uptime_s": (round(time.monotonic() - self._started_ts, 3)
                         if self._started_ts else None),
            "compile_cache": {
                **serving.cache_health(),
                "signatures": len(serving._SEEN_SHAPES.get(self.cache_key,
                                                           ())),
                "captures": self.captures, "replays": self.replays,
                "eager_calls": self.eager_calls},
            "engine": {
                "model": self.model_name,
                "device": str(self.device),
                "max_seqs": self.max_seqs,
                "active_seqs": self._active,
                "page_size": self.page_size,
                "kv_pages_used": used,
                "kv_pages_total": total,
                "kv_pages_peak": self.pool.peak_used,
                "kv_occupancy": round(used / total, 4) if total else 0.0,
                "kv_pool_bytes": self.kv_pool_bytes,
                "prefill_buckets": list(self.prefill_buckets),
                "prefill_chunks": list(self.prefill_chunks),
                "chunked_prefill": self.chunked_prefill,
                "prefix_share": self.share_prefixes,
                "prefix_registry": {
                    "entries": len(reg) if reg is not None else 0,
                    "max_entries": reg.max_entries if reg is not None else 0,
                    "hits": reg.hits if reg is not None else 0,
                    "evictions": reg.evictions if reg is not None else 0,
                    "pinned_pages": (reg.pinned_pages if reg is not None
                                     else 0),
                },
                "max_len": self.max_len,
                "max_prompt_len": self.max_prompt_len,
                "warmed": self._warmed,
                "spec": {
                    "spec_tokens": self.spec_tokens,
                    "drafter": self.spec_drafter,
                    "ladder": list(self.spec_ladder),
                    "k": (self._spec_ctl.k
                          if self._spec_ctl is not None else 0),
                    "shifts": (self._spec_ctl.shifts
                               if self._spec_ctl is not None else 0),
                },
            },
            "slo": slo,
            "admission": {
                "admission_schema": 1,
                "pending_bytes": pending_bytes,
                "pending_rows": pending,
                "max_pending_bytes": self.max_pending_bytes,
                "saturation": (round(pending_bytes
                                     / self.max_pending_bytes, 4)
                               if self.max_pending_bytes else 0.0),
                "shed_window": window,
                "slo": slo,
                # paged KV-pool occupancy: pages_used/bytes_resident
                # count UNIQUE physical pages (a prefix-shared page counts
                # once); pages_logical is what non-shared allocation
                # would have held — the gap is the sharing win
                "kv": {
                    "pages_used": used,
                    "pages_total": total,
                    "pages_shared": shared,
                    "pages_logical": logical,
                    "occupancy": (round(used / total, 4)
                                  if total else 0.0),
                    "bytes_resident": used * self._page_bytes,
                    "pool_bytes": self.kv_pool_bytes,
                    "prefix_hits_total": int(
                        self._prefix_hits_total.value),
                    "shared_pages_total": int(
                        self._prefix_shared_total.value),
                    "cow_copies_total": int(
                        self._cow_copies_total.value),
                    "pages_allocated_total": self.pool.alloc_total,
                    "invariant": invariant,
                    "spec_proposed_total": int(
                        self._spec_proposed_total.value),
                    "spec_accepted_total": int(
                        self._spec_accepted_total.value),
                    "spec_acceptance_rate": slo["spec_acceptance_rate"],
                    "spec_k": (self._spec_ctl.k
                               if self._spec_ctl is not None else 0),
                },
            },
            "requests_total": int(self._requests_total.value),
            "tokens_total": int(self._tokens_total.value),
            "shed_total": int(self._shed_total.value),
            "errors_total": int(self._errors_total.value),
            "cancelled_total": int(self._cancelled_total.value),
        }


def _fetch(out):
    """A step's output on the host, as its own numpy array (a replay
    overwrites the graph's output), or None."""
    return None if out is None else out.cpu().numpy().copy()


def enumerate_signatures(*, max_seqs: int, pages_per_seq: int,
                         prefill_buckets: Sequence[int] | None = None,
                         prefill_chunks: Sequence[int] | None = None,
                         share_prefixes: bool = False,
                         spec_ladder: Sequence[int] | None = None,
                         spec_drafter: str | None = None) -> list[tuple]:
    """The decode tier's complete signature set, from geometry alone (no
    engine, no weights; reference ``decode.py:2312``): one prefill
    signature per chunk-ladder rung (``prefill_chunks``; or per prompt
    bucket via ``prefill_buckets`` in legacy mode), exactly one
    decode-step signature — or, with ``spec_ladder``, one VERIFY
    signature per rung in its place — and one COW page-copy signature
    when ``share_prefixes``.  A ``spec_drafter`` of ``"model"`` adds the
    draft model's chunk rungs, decode step and COW copy under
    ``draft_``-prefixed keys.  Signed through
    ``shapes.signature`` on ``TensorSpec`` s — identical to what the
    engine hands ``serving.note_compile``."""
    from tensorflowonspark_torch import shapes

    i32 = np.dtype(np.int32)

    def spec(*shape):
        return shapes.TensorSpec(tuple(int(d) for d in shape), i32)

    S, P = int(max_seqs), int(pages_per_seq)
    sigs = []
    if prefill_chunks:
        for rung in prefill_chunks:
            sigs.append(shapes.signature({
                "tokens": spec(S, rung), "start_lens": spec(S),
                "chunk_lens": spec(S), "page_tables": spec(S, P)}))
    else:
        for b in prefill_buckets or ():
            sigs.append(shapes.signature({"tokens": spec(b),
                                          "prompt_len": spec()}))
    if spec_ladder:
        for k in spec_ladder:
            sigs.append(shapes.signature({
                "tokens": spec(S, int(k) + 1), "seq_lens": spec(S),
                "step_lens": spec(S), "page_tables": spec(S, P)}))
    else:
        sigs.append(shapes.signature({"tokens": spec(S),
                                      "seq_lens": spec(S),
                                      "page_tables": spec(S, P)}))
    if share_prefixes:
        sigs.append(shapes.signature({"src": spec(), "dst": spec()}))
    if spec_ladder and spec_drafter == "model":
        for rung in prefill_chunks or ():
            sigs.append(shapes.signature({
                "draft_tokens": spec(S, rung), "draft_start_lens": spec(S),
                "draft_chunk_lens": spec(S),
                "draft_page_tables": spec(S, P)}))
        sigs.append(shapes.signature({
            "draft_tokens": spec(S), "draft_seq_lens": spec(S),
            "draft_page_tables": spec(S, P)}))
        if share_prefixes:
            sigs.append(shapes.signature({"draft_src": spec(),
                                          "draft_dst": spec()}))
    return sigs


# ---------------------------------------------------------------------------
# HTTP front end (obs/httpd pattern; token streaming over chunked replies)
# ---------------------------------------------------------------------------


class DecodeHTTPServer:
    """Stdlib HTTP front end over a :class:`DecodeEngine`.

    - ``POST /v1/generate`` — body ``{"prompt": [ids],
      "max_new_tokens": n, "stream": bool?, "timeout_s": float?,
      "temperature": float?, "top_k": int?, "top_p": float?,
      "seed": int?}`` (the sampling quartet maps to
      :class:`SamplingParams`, reference ``decode.py:2447-2480``; omitted
      → greedy; non-greedy on an engine without speculation → 400).
      With ``stream`` (the default) the reply is newline-delimited JSON
      over ``Transfer-Encoding: chunked`` — one ``{"token": id,
      "index": i}`` line per generated token as it is produced, then a
      terminal ``{"done": true, "tokens": [...], "n": n}`` line — riding
      the keep-alive-safe streaming support in ``obs/httpd``.  Without
      it, one JSON document after generation completes.  Admission shed
      → **429** + ``Retry-After``; malformed → 400; token timeout → 504.
      A W3C ``traceparent`` header joins the caller's trace (per-token
      spans on the retained tree).
    - ``GET /metrics`` / ``/healthz`` / ``/pipeline`` /
      ``/debug/requests`` — the standard per-process views; ``/healthz``
      carries the ``admission`` block (with the windowed TTFT/ITL
      ``slo`` sub-document the mesh router sheds on) and is 200 only
      while serving.
    """

    def __init__(self, engine: DecodeEngine, host: str = "127.0.0.1",
                 port: int = 0):
        from tensorflowonspark_torch import obs
        from tensorflowonspark_torch.obs import flight
        from tensorflowonspark_torch.obs import httpd as _httpd

        self._engine = engine

        def metrics():
            return (200, _httpd.PROMETHEUS_CONTENT_TYPE,
                    obs.get_registry().to_prometheus())

        def healthz():
            doc = engine.stats()
            return (200 if doc["state"] == "serving" else 503,
                    "application/json", _json.dumps(doc))

        def pipeline():
            return (200, "application/json", _json.dumps(
                {"planes": flight.local_report(),
                 "server": engine.stats()}))

        def debug_requests():
            return (200, "application/json",
                    _json.dumps(_trace.get_trace_store().to_doc()))

        self._server = _httpd.ObservabilityServer(
            routes={"/metrics": metrics, "/healthz": healthz,
                    "/pipeline": pipeline,
                    "/debug/requests": debug_requests},
            host=host, port=port,
            post_routes={"/v1/generate": self._generate})

    def _generate(self, body: bytes, headers) -> tuple:
        import math

        engine = self._engine
        try:
            doc = _json.loads(body or b"{}")
            prompt = doc.get("prompt")
            if not isinstance(prompt, list) or not prompt:
                raise ValueError("body must carry a non-empty 'prompt' "
                                 "list of token ids")
            max_new = int(doc.get("max_new_tokens", 16))
            stream = bool(doc.get("stream", True))
            timeout = min(float(doc.get("timeout_s", 60.0)), 300.0)
            sp = None
            if any(key in doc for key in
                   ("temperature", "top_k", "top_p", "seed")):
                sp = SamplingParams(
                    temperature=float(doc.get("temperature", 0.0)),
                    top_k=int(doc.get("top_k", 0)),
                    top_p=float(doc.get("top_p", 1.0)),
                    seed=int(doc.get("seed", 0)))
            ctx = _trace.parse_traceparent(headers.get("traceparent"))
            handle = engine.submit(prompt, max_new_tokens=max_new,
                                   trace_ctx=ctx, sampling=sp)
        except Rejected as e:
            return (429, "application/json",
                    _json.dumps({"error": str(e),
                                 "retry_after_s": e.retry_after_s}),
                    {"Retry-After": str(max(1,
                                            math.ceil(e.retry_after_s)))})
        except (ValueError, TypeError) as e:
            return (400, "application/json",
                    _json.dumps({"error": str(e)}))
        except RuntimeError as e:
            return (503, "application/json",
                    _json.dumps({"error": str(e)}))
        trace_id = handle.trace_id
        if not stream:
            try:
                tokens = handle.result(timeout=timeout)
            except TimeoutError as e:
                # the caller stopped waiting: cancel so the generation
                # does not keep a slot + pages busy for nobody (the
                # streaming path does the same on its error line)
                handle.cancel()
                return (504, "application/json",
                        _json.dumps({"error": str(e)}))
            except RuntimeError as e:
                return (500, "application/json",
                        _json.dumps({"error": str(e)}))
            out = {"tokens": tokens, "n": len(tokens)}
            if trace_id:
                out["trace_id"] = trace_id
            return (200, "application/json", _json.dumps(out))

        def ndjson():
            tokens: list[int] = []
            try:
                for tok in handle.tokens(timeout=timeout):
                    tokens.append(tok)
                    yield _json.dumps({"token": tok,
                                       "index": len(tokens) - 1}) + "\n"
            except (TimeoutError, RuntimeError) as e:
                # headers are long gone: the error rides the stream as
                # its final line (the transport stays framed; the
                # caller sees an explicit failure, not a truncation)
                handle.cancel()
                yield _json.dumps({"error": str(e),
                                   "tokens": tokens}) + "\n"
                return
            except GeneratorExit:
                # the transport died mid-stream (client disconnect, via
                # the streaming reply closing its body iterator): stop
                # paying for tokens nobody will read — the slot retires
                # at the next step boundary and its pages return
                handle.cancel()
                raise
            done = {"done": True, "tokens": tokens, "n": len(tokens)}
            if trace_id:
                done["trace_id"] = trace_id
            yield _json.dumps(done) + "\n"

        return (200, "application/x-ndjson", ndjson())

    def start(self) -> tuple[str, int]:
        return self._server.start()

    @property
    def address(self) -> tuple[str, int]:
        return self._server.address

    @property
    def port(self) -> int:
        return self._server.port

    def url(self, path: str = "/") -> str:
        return self._server.url(path)

    def stop(self) -> None:
        self._server.stop()
