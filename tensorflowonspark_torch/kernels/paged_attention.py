"""The decode tier's paged-KV kernels on the card: ``csrc/paged_attention.cu``.

Two launches a transformer layer of ``models/tinylm.py``'s incremental
functions, each one ``ctypes`` call on the current stream with no host
synchronisation, so a CUDA graph captures them:

- :func:`kv_append` writes a layer's new K and V into the paged pools in
  place (``tfos_kv_append``; reference ``k_pool.at[i, pages, offs].set(k)``
  at ``tinylm.py:167``, ``:247``, ``:318``);
- :func:`paged_attention` attends every query over its row's positions,
  reading K and V in place through the row's page table
  (``tfos_paged_attention``; reference ``tinylm.py:249-255``, ``:320-322``
  with ``_attend_one`` ``:124``, and ``:169-173``).

On a CUDA tensor each wrapper checks what its kernel takes, launches it
or raises, and counts the launch in :data:`launches` and
:data:`launches_by_kernel`.  On CPU tensors it runs the plain twin beside
it (:func:`kv_append_plain`, :func:`paged_attention_plain`: an
``index_select`` gather and an einsum softmax, the reference's math), which
counts nothing: that is the caller's explicit request for the CPU, not a
fallback.  Tensors on both devices raise.

Positions: row ``r``'s query ``t`` sits at ``p = start[r] + t``, clamped
into ``[0, max_len - 1]`` (the reference clips at ``max_len - 1``);
position ``j`` lives in page ``page_tables[r, j // page_size]`` at offset
``j % page_size``.  Page 0 is the trash page: padded positions (``t >=
lens[r]``) write there, and which of several writes to one place of it
wins is undefined, so nothing compares it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tensorflowonspark_torch.kernels import _build

#: Kernel launches in this process, one per :func:`kv_append` or
#: :func:`paged_attention` call on the card (inside a CUDA graph's capture
#: too; a replay of the graph calls no wrapper and counts nothing).
launches = 0
#: The same launches by kernel.
launches_by_kernel = {"kv_append": 0, "paged_attention": 0}

#: The widest head the attention kernel takes (4 values a lane of a warp).
MAX_HEAD_DIM = 128

_LIB = None


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
    return _LIB


def _bind(lib):
    """Set the argument types of ``lib``'s two entry points (a build of
    ``csrc/paged_attention.cu``, with or without ``-D`` macros); returns
    ``lib``."""
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfos_kv_append_f32.argtypes = [p, p, p, p, p, p, p] + [i32] * 10 + [p]
    lib.tfos_paged_attention_f32.argtypes = ([p] * 6 + [i32] * 10
                                             + [f32, p])
    lib.tfos_kv_append_f32.restype = i32
    lib.tfos_paged_attention_f32.restype = i32
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
    layers, num_pages, page_size, r, L, P = _check(
        "kv_append", (k_pool, v_pool), k, page_tables, start, lens, layer,
        max_len)
    if v.shape != k.shape or v.dtype != k.dtype or not v.is_contiguous():
        raise ValueError(f"kv_append: v {tuple(v.shape)} {v.dtype} does not "
                         f"match k {tuple(k.shape)} {k.dtype}")
    if r * L == 0:
        return
    h, kd = k_pool.shape[3:]
    with _build.raw_stream(k.device) as stream:
        err = _lib().tfos_kv_append_f32(
            k_pool.data_ptr(), v_pool.data_ptr(), k.data_ptr(), v.data_ptr(),
            page_tables.data_ptr(), start.data_ptr(),
            lens.data_ptr() if lens is not None else None, r, L, h, kd, P,
            page_size, num_pages, max_len, layer, layers, stream)
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
    layers, num_pages, page_size, r, L, P = _check(
        "paged_attention", (k_pool, v_pool), q, page_tables, start, None,
        layer, max_len)
    h, kd = q.shape[2:]
    if kd > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {kd}")
    o = torch.empty_like(q)
    if r * L == 0:
        return o
    with _build.raw_stream(q.device) as stream:
        err = _lib().tfos_paged_attention_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), o.data_ptr(),
            page_tables.data_ptr(), start.data_ptr(), r, L, h, kd, P,
            page_size, num_pages, max_len, layer, layers, float(scale),
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
