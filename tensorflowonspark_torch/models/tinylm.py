"""Small causal decoder LM, the generative-decode demo workload: port of
``tensorflowonspark_tpu/models/tinylm.py``.

Two surfaces over ONE set of weights, as in the reference:

- the zoo surface: ``Config`` / :func:`make_model` (an ``nn.Module`` whose
  parameters carry the reference's FLAT names: ``embed``, ``pos``, ``lnf``,
  ``ln1_i``, ``wq_i``, …) / :func:`make_loss_fn` / :func:`make_forward_fn`
  / :func:`example_batch`, the teacher-forced forward (``(B, T)`` tokens →
  ``(B, T, V)`` logits) of :func:`apply_tokens`;
- the incremental decode surface (:func:`prefill_fn`,
  :func:`prefill_chunk_fn`, :func:`decode_fn`, :func:`verify_fn`,
  :func:`copy_page_fn`):
  functions over the name → tensor dict (``dict(model.named_parameters())``
  or :func:`init_params`), the int32 index tensors and a PAGED KV cache —
  pools ``(layers, num_pages, page_size, heads, head_dim)`` f32
  (:func:`kv_pool_shape`) in which each sequence owns a page TABLE.  They
  take the reference's arguments in its order, write the pools IN PLACE
  (the reference returns new arrays) and return ``(out, k_pool, v_pool)``.

Every K/V write and every attention over the pool goes through
``kernels/paged_attention.py``: on the card its two hand-written kernels
(``tfos_kv_append``, ``tfos_paged_attention``), on the CPU their plain
twins.  The projections, the MLP, RMSNorm and the final ``@ embed.T`` stay
plain PyTorch, products the JAX package leaves to XLA.  The copy-on-write
page copy is one ``index_copy_`` across every layer of both pools.

Page 0 of the pool is the TRASH page: a table entry never allocated reads
0, so out-of-range writes (prompt padding, idle decode slots) land where
nothing valid reads.  All shapes are fixed by the (slot, page) geometry, so
sequence growth moves an int in ``seq_lens``, never a shape: the decode
engine captures each function once per shape into a CUDA graph
(``decode.py``), as the reference jits each once.

:func:`verify_fn` is speculation's verify step (reference
``models/tinylm.py:330-400``): ``k+1`` positions a slot through the same
kernels, the logits of every position returned.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowonspark_torch.kernels import paged_attention

#: no sequence-parallel sharding: decode shapes are tiny by design
SEQUENCE_AXES: dict = {}


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 256
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    head_dim: int = 32
    mlp_dim: int = 256
    max_len: int = 128
    dtype: str = "float32"

    @classmethod
    def tiny(cls) -> "Config":
        return cls(vocab_size=64, dim=32, n_layers=2, n_heads=2,
                   head_dim=16, mlp_dim=64, max_len=64)

    @classmethod
    def draft_for(cls, target: "Config") -> "Config":
        """A smaller config suitable as a speculative DRAFT model for
        ``target``: same vocab (proposals must be target tokens) and the
        same ``max_len`` (the draft cache mirrors the target's page
        geometry), everything else halved — the cheap-proposer shape."""
        return cls(vocab_size=target.vocab_size,
                   dim=max(8, target.dim // 2), n_layers=1,
                   n_heads=max(1, target.n_heads // 2),
                   head_dim=max(8, target.head_dim // 2),
                   mlp_dim=max(16, target.mlp_dim // 2),
                   max_len=target.max_len, dtype=target.dtype)


def _rms(x, scale, eps=1e-6):
    return x * scale / torch.sqrt(
        torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)


def _layer_names(i: int) -> tuple[str, ...]:
    return (f"ln1_{i}", f"wq_{i}", f"wk_{i}", f"wv_{i}", f"wo_{i}",
            f"ln2_{i}", f"w1_{i}", f"w2_{i}")


def _names(config: Config) -> list[str]:
    names = ["embed", "pos", "lnf"]
    for i in range(config.n_layers):
        names += _layer_names(i)
    return names


def _shapes(config: Config) -> dict[str, tuple[int, ...]]:
    D, H, K, M = config.dim, config.n_heads, config.head_dim, config.mlp_dim
    out = {"embed": (config.vocab_size, D), "pos": (config.max_len, D),
           "lnf": (D,)}
    for i in range(config.n_layers):
        out.update({f"ln1_{i}": (D,), f"ln2_{i}": (D,),
                    f"wq_{i}": (D, H, K), f"wk_{i}": (D, H, K),
                    f"wv_{i}": (D, H, K), f"wo_{i}": (H, K, D),
                    f"w1_{i}": (D, M), f"w2_{i}": (M, D)})
    return out


def _qkv(h, wq, wk, wv):
    """``h (..., D)`` against ``(D, H, K)`` kernels → three ``(..., H, K)``
    (the reference's ``einsum("...d,dhk->...hk")``)."""
    D, H, K = wq.shape
    return tuple((h @ w.reshape(D, H * K)).reshape(*h.shape[:-1], H, K)
                 for w in (wq, wk, wv))


def _out_proj(o, wo):
    """``o (..., H, K)`` against ``wo (H, K, D)`` → ``(..., D)``."""
    H, K, D = wo.shape
    return o.reshape(*o.shape[:-2], H * K) @ wo.reshape(H * K, D)


def _mlp(x, ln2, w1, w2):
    return x + torch.relu(_rms(x, ln2) @ w1) @ w2


def apply_tokens(params, tokens, config: Config):
    """Full teacher-forced forward: ``(B, T) int tokens → (B, T, V)``
    logits.  The reference semantics the incremental paged path must
    reproduce token-for-token; plain PyTorch, no kernel."""
    B, T = tokens.shape
    scale = 1.0 / np.sqrt(config.head_dim)
    x = params["embed"][tokens.long()] + params["pos"][:T]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x.device))
    for i in range(config.n_layers):
        ln1, wq, wk, wv, wo, ln2, w1, w2 = (params[n]
                                            for n in _layer_names(i))
        q, k, v = _qkv(_rms(x, ln1), wq, wk, wv)
        s = torch.einsum("bthk,bshk->bhts", q, k) * scale
        s = torch.where(causal[None, None], s, torch.full_like(s, -1e30))
        w = torch.exp(s - s.amax(dim=-1, keepdim=True))
        w = w / w.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhts,bshk->bthk", w, v)
        x = _mlp(x + _out_proj(o, wo), ln2, w1, w2)
    x = _rms(x, params["lnf"])
    return x @ params["embed"].T


def _paged_layers(params, x, start, lens, k_pool, v_pool, page_tables,
                  config: Config):
    """Every layer over ``x (R, L, D)``, row ``r``'s position ``t`` at
    ``start[r] + t``: its K/V appended to the pools (the trash page for
    ``t >= lens[r]``; every position with ``lens`` None), then attention
    over the row's pages, both through the paged kernels.  Returns x."""
    max_len = config.max_len
    scale = 1.0 / math.sqrt(config.head_dim)
    for i in range(config.n_layers):
        ln1, wq, wk, wv, wo, ln2, w1, w2 = (params[n]
                                            for n in _layer_names(i))
        q, k, v = _qkv(_rms(x, ln1), wq, wk, wv)
        paged_attention.kv_append(k_pool, v_pool, i, k.contiguous(),
                                  v.contiguous(), page_tables, start, lens,
                                  max_len=max_len)
        o = paged_attention.paged_attention(
            q.contiguous(), k_pool, v_pool, i, page_tables, start,
            max_len=max_len, scale=scale)
        x = _mlp(x + _out_proj(o, wo), ln2, w1, w2)
    return x


def _rows_forward(params, tokens, start, lens, k_pool, v_pool, page_tables,
                  config: Config):
    """``tokens (R, L)`` embedded at positions ``start[r] + t`` (clipped at
    ``max_len - 1``, as the reference clips) and run through every layer
    by :func:`_paged_layers`: the final hidden states ``(R, L, D)``."""
    t_idx = torch.arange(tokens.shape[1], device=tokens.device)
    pos_c = (start.long()[:, None] + t_idx[None, :]).clamp(
        max=config.max_len - 1)
    x = params["embed"][tokens.long()] + params["pos"][pos_c]
    return _paged_layers(params, x, start, lens, k_pool, v_pool,
                         page_tables, config)


def _logits(params, x):
    return _rms(x, params["lnf"]) @ params["embed"].T


def prefill_fn(params, tokens, prompt_len, k_pool, v_pool, page_table,
               *, config: Config, page_size: int):
    """Prefill ONE sequence, the legacy one-prompt-per-call path: run the
    prompt (padded to a ladder bucket), write its K/V into the pool
    through ``page_table``, return the first generated token.

    - ``tokens``: ``(B,)`` int32, the prompt padded to bucket length B;
    - ``prompt_len``: ``()`` int32 tensor — every prompt length shares the
      bucket's one captured graph;
    - ``page_table``: ``(P,)`` int32 physical page ids; positions beyond
      the allocated pages read entry 0 = the trash page.

    The one-row case of the chunk path from position 0, every one of the B
    positions written through the table as the reference writes them; its
    attention reads the row's positions back from the pool, whose values
    are exact copies, so the math is the reference's.

    Returns ``(next_token (), k_pool, v_pool)``, the token int32.
    """
    del page_size  # the pools carry it
    start = torch.zeros((1,), dtype=torch.int32, device=tokens.device)
    x = _rows_forward(params, tokens[None], start, None, k_pool, v_pool,
                      page_table.reshape(1, -1), config)
    last = (prompt_len.reshape(1).long() - 1).clamp(min=0)
    logits = _logits(params, x[0].index_select(0, last))[0]
    return torch.argmax(logits).to(torch.int32), k_pool, v_pool


def prefill_chunk_fn(params, tokens, start_lens, chunk_lens, k_pool,
                     v_pool, page_tables, *, config: Config,
                     page_size: int):
    """Prefill ONE page-aligned chunk for SEVERAL sequences at once — the
    fixed-shape multi-sequence prefill step (`C` chunk rows × `L` tokens).

    - ``tokens``: ``(C, L)`` int32, each row the next ``chunk_lens[c]``
      prompt tokens of one sequence, zero-padded to the ladder rung L;
    - ``start_lens``: ``(C,)`` int32, how much of each row's sequence is
      already in the cache — row c's token t sits at global position
      ``start_lens[c] + t`` (clipped at ``max_len - 1``);
    - ``chunk_lens``: ``(C,)`` int32, valid tokens per row (0 for idle
      rows); padded/idle positions write to the trash page;
    - ``page_tables``: ``(C, P)`` int32, each ROW'S OWN table — rows may
      map the same physical pages (prefix sharing), which are only read
      here.

    Returns ``(logits (C, V) float32, k_pool, v_pool)``: ``logits[c]`` is
    the next-token distribution at the row's LAST valid position (idle
    rows read t = 0 garbage).  KV at position t depends only on tokens
    ``0..t``, so chunked computation is exact: attention reads prior
    positions and this chunk's own (appended first) from the pool, masked
    at ``j <= start + t``.
    """
    del page_size
    C = tokens.shape[0]
    x = _rows_forward(params, tokens, start_lens, chunk_lens, k_pool,
                      v_pool, page_tables, config)
    last = (chunk_lens.long() - 1).clamp(min=0)
    xl = torch.gather(x, 1, last[:, None, None].expand(C, 1, x.shape[-1]))
    return _logits(params, xl[:, 0]).float(), k_pool, v_pool


def copy_page_fn(k_pool, v_pool, src, dst):
    """Copy ONE physical page ``src → dst`` across every layer of both
    pools in place — the copy-on-write step.  ``src``/``dst`` are ``()``
    int32 tensors, so every page copy shares one captured graph."""
    s = src.reshape(1).long()
    d = dst.reshape(1).long()
    for pool in (k_pool, v_pool):
        pool.index_copy_(1, d, pool.index_select(1, s))
    return k_pool, v_pool


def decode_fn(params, tokens, seq_lens, k_pool, v_pool, page_tables,
              *, config: Config, page_size: int):
    """One decode step for EVERY slot at once — the fixed-shape batched
    token step (`S` slots × `P` pages).

    - ``tokens``: ``(S,)`` int32, each slot's last emitted token (the
      token entering the cache at position ``seq_lens[s]``);
    - ``seq_lens``: ``(S,)`` int32, cache length BEFORE this step;
    - ``page_tables``: ``(S, P)`` int32; inactive slots carry all-zero
      rows and ``seq_len`` 0, so their writes land in the trash page.

    Returns ``(next_tokens (S,) int32, k_pool, v_pool)``.  Per-slot math is
    row-independent, so a slot's output does not depend on which slot (or
    which physical pages) it occupies — the property that makes concurrent
    and sequential decode token-identical.
    """
    del page_size
    x = _rows_forward(params, tokens[:, None], seq_lens, None, k_pool,
                      v_pool, page_tables, config)
    logits = _logits(params, x[:, 0])
    return torch.argmax(logits, dim=-1).to(torch.int32), k_pool, v_pool


def verify_fn(params, tokens, seq_lens, step_lens, k_pool, v_pool,
              page_tables, *, config: Config, page_size: int):
    """Score ``k+1`` positions a slot in ONE fixed-shape call, the
    speculative-decoding VERIFY step (`S` slots × `L = k+1` positions).

    - ``tokens``: ``(S, L)`` int32, column 0 each slot's last emitted token
      (entering the cache at position ``seq_lens[s]``, as :func:`decode_fn`
      writes it), columns ``1..d`` the drafter's tokens, zero-padded;
    - ``seq_lens``: ``(S,)`` int32, cache length BEFORE this step;
    - ``step_lens``: ``(S,)`` int32, valid positions a slot (``d + 1`` for
      ``d`` drafts, 0 for idle and prefilling slots): positions ``t >=
      step_lens[s]`` write to the trash page;
    - ``page_tables``: ``(S, P)`` int32; a position beyond the slot's
      allocated pages reads entry 0, the trash page, so a near-finished
      slot's speculative tail lands nowhere it does not own.

    Returns ``(logits (S, L, V) float32, k_pool, v_pool)``: the next-token
    logits at EVERY position, from which the host accepts the longest
    agreeing draft prefix (or rejection-samples).  The K/V of rejected
    positions stays in the pool; the causal mask ``j <= start + t`` keeps
    it unread until a later step overwrites it, so rollback is host
    bookkeeping alone.
    """
    del page_size
    x = _rows_forward(params, tokens, seq_lens, step_lens, k_pool, v_pool,
                      page_tables, config)
    return _logits(params, x).float(), k_pool, v_pool


def kv_pool_shape(config: Config, num_pages: int,
                  page_size: int) -> tuple[int, ...]:
    """Shape of ONE pool (keys or values): pre-sized at engine init,
    never grown — the decode tier's whole-buffer memory contract."""
    return (config.n_layers, int(num_pages), int(page_size),
            config.n_heads, config.head_dim)


class TinyLM(nn.Module):
    """``forward(tokens)``: :func:`apply_tokens` over the module's own
    parameters, registered under the reference's flat names."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        dtype = getattr(torch, config.dtype)
        for name, shape in _shapes(config).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype)))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return apply_tokens(dict(self.named_parameters()), tokens,
                            self.config)


def make_model(config: Config, seed: int = 0) -> TinyLM:
    """A TinyLM on the CPU, drawn from ``seed`` as the reference's init
    draws (torch's generator, so not its numbers): N(0, 0.02) for the
    embeddings and kernels, ones for the RMSNorm scales."""
    model = TinyLM(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("ln"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def make_loss_fn(model: TinyLM, config: Config):
    """Next-token cross-entropy over the token sequence itself — no
    separate label column (the targets are the inputs shifted left)."""
    del model

    def loss_fn(model, batch):
        tokens = batch["tokens"]
        logits = model(tokens)
        return F.cross_entropy(
            logits[:, :-1].float().reshape(-1, logits.shape[-1]),
            tokens[:, 1:].long().reshape(-1))

    return loss_fn


def make_forward_fn(model: TinyLM, config: Config):
    def forward(model, batch):
        return model(batch["tokens"])

    return forward


def init_params(config: Config, seed: int = 0) -> dict:
    """The flat name → tensor dict the incremental functions take, from
    :func:`make_model`'s init, so training and decode hold one set of
    weights."""
    return {k: v.detach() for k, v in
            make_model(config, seed).named_parameters()}


def params_from_flax(params) -> dict:
    """The reference's flat param dict (``init_params`` there, or a
    ``Trainer``'s ``state.params``) as ``{name: f32 array}`` for the
    port's :func:`init_params` dict or ``make_model``'s parameters: the
    same names and layouts.  A nested or unknown leaf raises ``KeyError``.
    """
    out = {}
    for name, leaf in params.items():
        if not isinstance(name, str) or isinstance(leaf, dict) or not (
                name in ("embed", "pos", "lnf")
                or name.rsplit("_", 1)[0] in ("ln1", "ln2", "wq", "wk",
                                              "wv", "wo", "w1", "w2")):
            raise KeyError(f"unmapped flax leaf {name!r}")
        out[name] = np.array(leaf, dtype=np.float32)
    return out


def example_batch(config: Config, batch_size: int = 8, seed: int = 0,
                  seq_len: int | None = None):
    rng = np.random.RandomState(seed)
    T = min(16, config.max_len) if seq_len is None else int(seq_len)
    return {"tokens": rng.randint(
        0, config.vocab_size, size=(batch_size, T)).astype(np.int32)}
