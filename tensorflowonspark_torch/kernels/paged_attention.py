"""The decode tier's paged-KV kernels on the card: ``csrc/paged_attention.cu``.

Two launches a transformer layer of ``models/tinylm.py``'s incremental
functions, each one ``ctypes`` call on the current stream with no host
synchronisation, so a CUDA graph captures them:

- :func:`kv_append` writes a layer's new K and V into the paged pools in
  place (``tfos_kv_append``, a warp a (row, position) moving 16-byte
  pieces of its K and V rows; reference ``k_pool.at[i, pages,
  offs].set(k)`` at ``tinylm.py:167``, ``:247``, ``:318``);
- :func:`paged_attention` attends every query over its row's positions,
  reading K and V in place through the row's page table
  (``tfos_paged_attention``; reference ``tinylm.py:249-255``, ``:320-322``
  with ``_attend_one`` ``:124``, and ``:169-173``).

On a CUDA tensor each wrapper checks what its kernel takes, launches it
or raises, and counts the launch in :data:`launches` and
:data:`launches_by_kernel`.  :func:`plan` is the attention's launch plan,
pure Python: one block a (row, head, query tile), the tiles and the shared
memory chosen from the shapes alone, so that a CUDA graph replays it with
new ``start`` values; :func:`append_plan` is the append's (a warp a
(row, position), the blocks from the shapes alone).  On CPU tensors each
runs the plain twin beside it (:func:`kv_append_plain`,
:func:`paged_attention_plain`: an ``index_select`` gather and an einsum
softmax, the reference's math), which counts nothing: that is the
caller's explicit request for the CPU, not a fallback.  Tensors on both
devices raise.

Positions: row ``r``'s query ``t`` sits at ``p = start[r] + t``, clamped
into ``[0, max_len - 1]`` (the reference clips at ``max_len - 1``);
position ``j`` lives in page ``page_tables[r, j // page_size]`` at offset
``j % page_size``.  Page 0 is the trash page: padded positions (``t >=
lens[r]``) write there, and which of several writes to one place of it
wins is undefined, so nothing compares it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from tensorflowonspark_torch.kernels import _build

#: Kernel launches in this process, one per :func:`kv_append` or
#: :func:`paged_attention` call on the card (inside a CUDA graph's capture
#: too; a replay of the graph calls no wrapper and counts nothing).
launches = 0
#: The same launches by kernel.
launches_by_kernel = {"kv_append": 0, "paged_attention": 0}

#: The widest head the attention kernel takes.
MAX_HEAD_DIM = 128

_LIB = None
#: (id of a loaded library, device index) whose attention kernel may take
#: more than 48 KB of shared memory (``tfos_paged_attention_prepare``)
_PREPARED: set = set()

# the kernel's constants (csrc/paged_attention.cu)
_THREADS = 128
_WARPS = _THREADS // 32
_SMEM_DEFAULT = 48 * 1024
_SMEM_MAX = 232448  # 227 KB, with the attribute raised
#: blocks that keep every SM of an H100 busy (132 SMs, 4 blocks each):
#: the plan halves the query tile until the grid holds as many, or the
#: tile is 4 queries
_FILL_BLOCKS = 4 * 132
#: the (score_rows, score_cols, out_rows) instantiations of
#: ``TFOS_ATTN_SHAPES``
_KERNEL_SHAPES = frozenset({
    (1, 2, 1), (2, 2, 1), (4, 2, 1), (8, 2, 1), (8, 2, 2), (1, 1, 1),
    (2, 1, 1), (2, 1, 2), (4, 1, 2), (4, 1, 4)})

#: threads a block of the append: four warps, each one (row, position)
_APPEND_THREADS = 128


class Plan(NamedTuple):
    """How one :func:`paged_attention` call runs: ``blocks`` blocks of
    ``threads``, one a (row, head, tile of ``q_tile`` queries), each
    staging ``pos_tile`` positions of K and V a stage, two stages deep, in
    ``smem`` bytes of dynamic shared memory (``big_smem``: above the 48 KB
    default, so the kernel's limit is raised once a device); a
    warp scores ``score_rows`` queries at ``score_cols`` positions a lane
    (a whole tile), a group of ``lanes`` lanes accumulates ``out_rows``
    queries' outputs, and ``splits`` groups share one query's positions
    (their partials summed in a fixed order)."""
    q_tile: int
    pos_tile: int
    threads: int
    smem: int
    blocks: int
    score_rows: int
    score_cols: int
    out_rows: int
    lanes: int
    splits: int
    big_smem: bool


def _smem(q_tile: int, pos_tile: int, head_dim: int, pages: int) -> int:
    """Bytes of one block's shared memory, as ``attn_layout`` in
    ``csrc/paged_attention.cu`` lays it out: two stages of K tiles
    (``head_dim + 4`` floats a position) and of V tiles (``head_dim``),
    the query tile, the weights (``pos_tile + 4`` floats a query), corr, l
    and the bound a query, and ``pages`` table entries."""
    return 4 * (2 * pos_tile * (2 * head_dim + 4) + q_tile * head_dim
                + q_tile * (pos_tile + 4) + 3 * q_tile + pages)


@functools.lru_cache(maxsize=1024)
def plan(R: int, L: int, H: int, K: int, page_size: int,
         max_len: int) -> Plan:
    """The attention's launch plan for ``R`` rows of ``L`` queries, ``H``
    heads of ``K``, pages of ``page_size`` and ``max_len`` positions, by
    shape alone: a query tile of 1 for the decode step (``L == 1``: the
    block's lane groups split the positions); else the least power of two
    ≥ ``L``, at most 32 (``K`` ≤ 32) or 16, halved while the grid holds
    fewer than :data:`_FILL_BLOCKS` blocks and the tile more than 4
    queries (a staged tile serves every query of its block, but a grid
    that leaves SMs idle walks its rows on fewer of them); a position tile
    of 64 (``K`` ≤ 32) or 32.  Raises ``ValueError`` on what the kernel
    cannot take (see :func:`tiled`)."""
    q_tile = 1
    if L > 1:
        q_tile = min(32 if K <= 32 else 16, 1 << (L - 1).bit_length())
        while q_tile > 4 and R * H * -(-L // q_tile) < _FILL_BLOCKS:
            q_tile //= 2
    return tiled(R, L, H, K, page_size, max_len, q_tile,
                 64 if K <= 32 else 32)


def tiled(R: int, L: int, H: int, K: int, page_size: int, max_len: int,
          q_tile: int, pos_tile: int) -> Plan:
    """The plan with a given query tile (a power of two up to 32) and
    position tile (32 or 64): :func:`plan`'s choice, or another for a
    probe.  Raises ``ValueError`` on what the kernel cannot take: ``K`` not
    a multiple of 4 (its copies move 16 bytes) or above
    :data:`MAX_HEAD_DIM`, tiles it has no instantiation for, more than 227
    KB of shared memory, more than 2³¹ − 1 blocks."""
    if min(R, L, H, page_size, max_len) < 1:
        raise ValueError(f"paged_attention: empty geometry R={R} L={L} H={H}"
                         f" page_size={page_size} max_len={max_len}")
    if not (1 <= K <= MAX_HEAD_DIM and K % 4 == 0):
        raise ValueError(f"paged_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM} and a multiple of 4 (16-byte "
                         f"copies), got {K}")
    no_kernel = ValueError(f"paged_attention: no kernel for a tile of "
                           f"{q_tile} queries by {pos_tile} positions at "
                           f"head_dim {K}")
    if pos_tile not in (32, 64) or q_tile not in (1, 2, 4, 8, 16, 32):
        raise no_kernel
    pages = -(-max_len // page_size)
    smem = _smem(q_tile, pos_tile, K, pages)
    if smem > _SMEM_MAX:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory "
                         f"(a table of {pages} pages) exceed {_SMEM_MAX}")
    blocks = R * H * -(-L // q_tile)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"paged_attention: {blocks} blocks")
    lanes = 1 << (K // 4 - 1).bit_length()
    groups = _THREADS // lanes
    p = Plan(q_tile, pos_tile, _THREADS, smem, blocks,
             score_rows=-(-q_tile // _WARPS), score_cols=pos_tile // 32,
             out_rows=max(1, q_tile // groups), lanes=lanes,
             splits=max(1, min(groups // q_tile, pos_tile // 4)),
             big_smem=smem > _SMEM_DEFAULT)
    if (p.score_rows, p.score_cols, p.out_rows) not in _KERNEL_SHAPES:
        raise no_kernel
    return p


def block_queries(p: Plan, R: int, L: int, H: int, block: int):
    """``(r, h, t0, queries)``: the row, head and query range that block
    ``block`` of plan ``p`` serves, as the kernel decodes ``blockIdx.x``."""
    nqt = -(-L // p.q_tile)
    qtile, rh = block % nqt, block // nqt
    t0 = qtile * p.q_tile
    return rh // H, rh % H, t0, min(p.q_tile, L - t0)


class AppendPlan(NamedTuple):
    """How one :func:`kv_append` call runs: ``blocks`` blocks of
    ``threads``, each warp moving the K and V rows of one (row, position)
    item."""
    threads: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def append_plan(R: int, L: int, H: int, K: int) -> AppendPlan:
    """The append's launch plan for ``R`` rows of ``L`` positions, ``H``
    heads of ``K``, by shape alone: a warp an item, four a block, the
    least grid that holds them.  Raises ``ValueError`` on an empty
    geometry, ``H * K`` not a multiple of 4 (the kernel copies 16 bytes at
    a time), or more than 2³¹ − 1 items or floats a row."""
    if min(R, L, H, K) < 1:
        raise ValueError(f"kv_append: empty geometry R={R} L={L} H={H} "
                         f"K={K}")
    if H * K % 4:
        raise ValueError(f"kv_append kernel copies 16 bytes at a time: "
                         f"H * K = {H * K} must be a multiple of 4")
    warps = _APPEND_THREADS // 32
    blocks = -(-(R * L) // warps)
    if max(H * K, blocks * warps) > 2 ** 31 - 1:
        raise ValueError(f"kv_append: {R * L} items of {H * K} floats")
    return AppendPlan(_APPEND_THREADS, blocks)


def append_warp_item(p: AppendPlan, R: int, L: int, block: int,
                     warp: int):
    """The ``(r, t)`` item that warp ``warp`` of block ``block`` of plan
    ``p`` moves, as the kernel decodes it; None for a spare warp."""
    item = block * (p.threads // 32) + warp
    return divmod(item, L) if item < R * L else None


def reset_launches() -> None:
    """Zero :data:`launches` and :data:`launches_by_kernel`."""
    global launches
    launches = 0
    for k in launches_by_kernel:
        launches_by_kernel[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _bind(_build.load("paged_attention"))
        _prepare(_LIB, torch.cuda.current_device())
    return _LIB


def _prepare(lib, device: int) -> None:
    """Raise ``lib``'s attention kernel's shared memory limit on card
    ``device`` (current) to 227 KB, once: at load, or at the first plan
    above 48 KB on another card."""
    if (id(lib), device) in _PREPARED:
        return
    err = lib.tfos_paged_attention_prepare()
    if err != 0:
        raise RuntimeError(f"paged_attention: raising the shared memory "
                           f"limit failed: CUDA error {err}")
    _PREPARED.add((id(lib), device))


def _bind(lib):
    """Set the argument types of ``lib``'s two entry points (a build of
    ``csrc/paged_attention.cu``, with or without ``-D`` macros); returns
    ``lib``."""
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfos_kv_append_f32.argtypes = [p] * 7 + [i32] * 12 + [p]
    lib.tfos_paged_attention_f32.argtypes = ([p] * 6 + [i32] * 10
                                             + [f32] + [i32] * 4 + [p])
    lib.tfos_paged_attention_prepare.argtypes = []
    for fn in (lib.tfos_kv_append_f32, lib.tfos_paged_attention_f32,
               lib.tfos_paged_attention_prepare):
        fn.restype = i32
    return lib


def _count(kernel: str) -> None:
    global launches
    launches += 1
    launches_by_kernel[kernel] += 1


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor is on the CPU, False when every one is on
    one card; raises on a mix."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}: "
                         "all must be on one device")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device.type == "cpu"


def _check(name: str, pools, rows_like, page_tables, start, lens, layer: int,
           max_len: int) -> tuple[int, int, int, int, int, int]:
    """Check the pools, a ``(R, L, H, K)`` f32 tensor and the int32 index
    tensors for the kernels; ``(layers, num_pages, page_size, R, L, P)``."""
    k_pool, v_pool = pools
    for label, t in (("k_pool", k_pool), ("v_pool", v_pool),
                     ("rows", rows_like)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous float32 "
                             f"{label}, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    if k_pool.dim() != 5 or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pools must be one (layers, pages, "
                         f"page_size, H, K) shape, got {tuple(k_pool.shape)}"
                         f" and {tuple(v_pool.shape)}")
    layers, num_pages, page_size, h, k = k_pool.shape
    if rows_like.dim() != 4 or tuple(rows_like.shape[2:]) != (h, k):
        raise ValueError(f"{name}: want (R, L, {h}, {k}), got "
                         f"{tuple(rows_like.shape)}")
    r, L = rows_like.shape[:2]
    for label, t, shape in (("page_tables", page_tables, None),
                            ("start", start, (r,)), ("lens", lens, (r,))):
        if t is None:
            continue
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous int32, got "
                             f"{t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} {tuple(t.shape)}, want "
                             f"{shape}")
    if page_tables.dim() != 2 or page_tables.shape[0] != r:
        raise ValueError(f"{name}: page_tables {tuple(page_tables.shape)}, "
                         f"want ({r}, P)")
    P = page_tables.shape[1]
    if not 0 <= layer < layers:
        raise ValueError(f"{name}: layer {layer} of {layers}")
    if not 1 <= max_len <= P * page_size:
        raise ValueError(f"{name}: max_len {max_len} must lie in [1, "
                         f"P * page_size = {P * page_size}]")
    return layers, num_pages, page_size, r, L, P


def _positions(start, L: int, max_len: int):
    """``(R, L)`` int64: ``start[r] + t`` clamped into ``[0, max_len-1]``."""
    t = torch.arange(L, device=start.device)
    return (start.long()[:, None] + t[None, :]).clamp(0, max_len - 1)


def kv_append(k_pool, v_pool, layer: int, k, v, page_tables, start,
              lens=None, *, max_len: int) -> None:
    """Write ``k`` and ``v`` ``(R, L, H, K)`` into layer ``layer`` of the
    pools ``(layers, num_pages, page_size, H, K)`` in place: row ``r``'s
    position ``t`` to its page when ``t < lens[r]`` (every ``t`` with
    ``lens`` None), else to the trash page 0.  One launch on the card."""
    if _on_cpu("kv_append", k_pool, v_pool, k, v, page_tables, start, lens):
        kv_append_plain(k_pool, v_pool, layer, k, v, page_tables, start,
                        lens, max_len=max_len)
        return
    _, _, _, r, L, _ = _check(
        "kv_append", (k_pool, v_pool), k, page_tables, start, lens, layer,
        max_len)
    if v.shape != k.shape or v.dtype != k.dtype or not v.is_contiguous():
        raise ValueError(f"kv_append: v {tuple(v.shape)} {v.dtype} does not "
                         f"match k {tuple(k.shape)} {k.dtype}")
    if r * L == 0:
        return
    _append_launch(k_pool, v_pool, layer, k, v, page_tables, start, lens,
                   max_len, append_plan(r, L, *k.shape[2:]))


def _append_launch(k_pool, v_pool, layer: int, k, v, page_tables, start,
                   lens, max_len: int, p: AppendPlan) -> None:
    """One launch of the append under plan ``p`` (checked tensors on one
    card): :func:`kv_append`'s plan, or another in a test.  Counts the
    launch; raises on any error."""
    layers, num_pages, page_size = k_pool.shape[:3]
    r, L, h, kd = k.shape
    for label, t in (("k", k), ("v", v), ("k_pool", k_pool),
                     ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"kv_append kernel copies 16 bytes at a time: "
                             f"{label} must start 16-byte aligned")
    with _build.raw_stream(k.device) as stream:
        err = _lib().tfos_kv_append_f32(
            k_pool.data_ptr(), v_pool.data_ptr(), k.data_ptr(), v.data_ptr(),
            page_tables.data_ptr(), start.data_ptr(),
            lens.data_ptr() if lens is not None else None, r, L, h, kd,
            page_tables.shape[1], page_size, num_pages, max_len, layer,
            layers, p.threads, p.blocks, stream)
    if err != 0:
        raise RuntimeError(f"kv_append kernel launch failed: CUDA error "
                           f"{err}")
    _count("kv_append")


def kv_append_plain(k_pool, v_pool, layer: int, k, v, page_tables, start,
                    lens=None, *, max_len: int) -> None:
    """:func:`kv_append` in plain PyTorch: the reference's scatter as an
    ``index_put_`` (a page id outside the pool is dropped, as XLA's scatter
    drops it)."""
    page_size = k_pool.shape[2]
    num_pages = k_pool.shape[1]
    r, L = k.shape[:2]
    pos = _positions(start, L, max_len)
    pages = torch.gather(page_tables.long(), 1, pos // page_size)
    if lens is not None:
        t = torch.arange(L, device=k.device)
        pages = torch.where(t[None, :] < lens.long()[:, None], pages,
                            torch.zeros_like(pages))
    keep = (pages >= 0) & (pages < num_pages)
    pages, offs = pages[keep], (pos % page_size)[keep]
    k_pool[layer].index_put_((pages, offs), k[keep])
    v_pool[layer].index_put_((pages, offs), v[keep])


def paged_attention(q, k_pool, v_pool, layer: int, page_tables, start, *,
                    max_len: int, scale: float | None = None):
    """``o (R, L, H, K)``: query ``(r, t, h)`` of ``q (R, L, H, K)``
    attends over positions ``j <= p`` of its row, K and V read in place
    from layer ``layer`` of the pools, the scores scaled by ``scale``
    (``1/sqrt(K)`` by default) and softmaxed in f32.  One launch on the
    card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _on_cpu("paged_attention", q, k_pool, v_pool, page_tables, start):
        return paged_attention_plain(q, k_pool, v_pool, layer, page_tables,
                                     start, max_len=max_len, scale=scale)
    _, _, page_size, r, L, _ = _check(
        "paged_attention", (k_pool, v_pool), q, page_tables, start, None,
        layer, max_len)
    if r * L == 0:
        return torch.empty_like(q)
    return _launch(q, k_pool, v_pool, layer, page_tables, start, max_len,
                   scale, plan(r, L, *q.shape[2:], page_size, max_len))


def _launch(q, k_pool, v_pool, layer: int, page_tables, start,
            max_len: int, scale: float, p: Plan):
    """One launch of the attention kernel under plan ``p`` (checked
    tensors on one card): :func:`paged_attention`'s, or another plan of
    :func:`tiled` in a probe.  Counts the launch; raises on any error."""
    layers, num_pages, page_size = k_pool.shape[:3]
    r, L, h, kd = q.shape
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention kernel copies 16 bytes at a time:"
                         " the pools must start 16-byte aligned")
    o = torch.empty_like(q)
    lib = _lib()
    with _build.raw_stream(q.device) as stream:
        if p.big_smem:
            _prepare(lib, q.device.index)
        err = lib.tfos_paged_attention_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), o.data_ptr(),
            page_tables.data_ptr(), start.data_ptr(), r, L, h, kd,
            page_tables.shape[1], page_size, num_pages, max_len, layer,
            layers, float(scale), p.q_tile, p.pos_tile, p.threads, p.smem,
            stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    _count("paged_attention")
    return o


def paged_attention_plain(q, k_pool, v_pool, layer: int, page_tables, start,
                          *, max_len: int, scale: float | None = None):
    """:func:`paged_attention` in plain PyTorch, the reference's math: the
    row's ``P * page_size`` positions gathered through its table by
    ``index_select`` (a page id clamped into the pool, as XLA's gather
    clamps), the scores masked to ``j <= p`` with -1e30, a softmax and the
    weighted sum by einsum."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _, num_pages, page_size, h, kd = k_pool.shape
    r, L = q.shape[:2]
    P = page_tables.shape[1]
    ctx = P * page_size
    idx = page_tables.long().clamp(0, num_pages - 1).reshape(-1)
    kg = k_pool[layer].index_select(0, idx).reshape(r, ctx, h, kd)
    vg = v_pool[layer].index_select(0, idx).reshape(r, ctx, h, kd)
    pos = _positions(start, L, max_len)
    mask = (torch.arange(ctx, device=q.device)[None, None, :]
            <= pos[:, :, None])
    s = torch.einsum("cthk,cshk->chts", q, kg) * scale
    s = torch.where(mask[:, None], s, torch.full_like(s, -1e30))
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("chts,cshk->cthk", w, vg)
