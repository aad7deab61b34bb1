"""Attention: GQA (grouped-query), over a dense cache and over the
paged KV pool.

Three paths, as in the JAX package, plus the serving engine's:

* ``gqa_forward`` — prefill or a forward over a full sequence,
  optionally q-chunked so the live score tiles stay bounded;
* ``gqa_decode`` — one-token decode against a dense (B, S_max, KVH, Dh)
  cache;
* ``gqa_decode_paged`` — one-token decode against the page pool
  (NP, KVH, PS, Dh) addressed by the engine's block tables: the new K/V
  row is written into its page, then kernel B8
  (``kernels.paged_attn``) attends over the planned pages.

Scores and softmax are float32, with the JAX package's finite mask value
``NEG_INF`` in the dense paths; B8 masks by ``pos < seq_lens``, which
agrees with the dense decode's ``pos <= position`` when
``seq_lens = position + 1``.  JAX arrays are immutable; here the dense
decode's ``_scatter_time`` and the paged decode's K/V write update the
cache in place, and return it.

MLA (multi-head latent attention, DeepSeek) is not ported yet (ROADMAP
A10b): ``AttnConfig`` has only the GQA fields, and the transformer raises
for an ``attn_type="mla"`` configuration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..kernels.paged_attn import ops as paged_ops
from .layers import apply_rope, dense_init, rope_freqs

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10_000.0


def gqa_init(cfg: AttnConfig, **kw) -> dict:
    """``{"wq", "wk", "wv", "wo"}``, each drawn normal · 1/√d_in."""
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": dense_init(d, h * dh, **kw)["w"],
        "wk": dense_init(d, kvh * dh, **kw)["w"],
        "wv": dense_init(d, kvh * dh, **kw)["w"],
        "wo": dense_init(h * dh, d, **kw)["w"],
    }


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          positions_q: torch.Tensor, positions_kv: torch.Tensor,
          causal: bool, q_chunk: int | None) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Skv,KVH,Dh) → (B,Sq,H,Dh).  Exact softmax
    in float32; chunking over Sq (a ragged last chunk allowed) keeps the
    live score tiles bounded."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh)
    scale = 1.0 / math.sqrt(dh)
    k32, v32 = k.float(), v.float()

    def block(q_blk, pos_blk):
        s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(), k32) * scale
        if causal:
            m = pos_blk[:, None, None, :, None] >= \
                positions_kv[:, None, None, None, :]
            s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", p, v32)

    if q_chunk is None or sq <= q_chunk:
        out = block(qg, positions_q)
    else:
        out = torch.cat([block(qg[:, i:i + q_chunk],
                               positions_q[:, i:i + q_chunk])
                         for i in range(0, sq, q_chunk)], dim=1)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _qkv(params: dict, cfg: AttnConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """q (B,S,H,Dh), k and v (B,S,KVH,Dh), RoPE applied to q and k."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, h, dh)
    k = (x @ params["wk"].to(x.dtype)).reshape(b, s, kvh, dh)
    v = (x @ params["wv"].to(x.dtype)).reshape(b, s, kvh, dh)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_forward(params: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                q_chunk: int | None = 1024, return_cache: bool = False):
    """x (B,S,D) → (B,S,D); with ``return_cache`` also ``{"k", "v"}``
    (B,S,KVH,Dh)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions)
    out = _sdpa(q, k, v, positions, positions, causal, q_chunk)
    out = out.reshape(b, s, cfg.n_heads * cfg.d_head) @ \
        params["wo"].to(x.dtype)
    if return_cache:
        return out, {"k": k, "v": v}
    return out


def gqa_decode(params: dict, cfg: AttnConfig, x: torch.Tensor,
               cache: dict, position: torch.Tensor):
    """x (B,1,D); cache k/v (B,S_max,KVH,Dh); position (B,) current index.
    Returns out (B,1,D) and the cache, updated in place at
    ``position``."""
    b = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k_new, v_new = _qkv(params, cfg, x, position[:, None])
    k = _scatter_time(cache["k"], k_new, position)
    v = _scatter_time(cache["v"], v_new, position)
    s_max = k.shape[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    live = torch.arange(s_max, device=x.device)[None, :] <= \
        position.long()[:, None]
    scores = torch.where(live[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = out.reshape(b, 1, h * dh).to(x.dtype) @ params["wo"].to(x.dtype)
    return out, {"k": k, "v": v}


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  position: torch.Tensor) -> torch.Tensor:
    """cache (B,S,…) ← new (B,1,…) at per-batch position, in place: a
    one-slot write per sequence, as the JAX package's donated
    dynamic-update-slice is."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, position.long()] = new[:, 0].to(cache.dtype)
    return cache


def gqa_decode_paged(params: dict, cfg: AttnConfig, x: torch.Tensor,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     position: torch.Tensor, block_table: torch.Tensor,
                     seq_lens: torch.Tensor) -> torch.Tensor:
    """One decode token per sequence against the page pool.

    x (B,1,D); k_pages/v_pages (NP,KVH,PS,Dh), this layer's pool;
    position (B,) the new token's index; block_table (B,PMAX) and
    seq_lens (B,) the engine's plan, with ``seq_lens == position + 1``
    (the new token counted).  The new K/V row is written in place into
    page ``block_table[b, pos // PS]``, slot ``pos % PS``; then B8
    attends over the ``seq_lens[b]`` live slots.  Returns (B,1,D).
    """
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.d_head
    ps = k_pages.shape[2]
    q, k_new, v_new = _qkv(params, cfg, x, position[:, None])
    pos = position.long()
    page = block_table.long().gather(1, (pos // ps)[:, None])[:, 0]
    slot = pos % ps
    k_pages[page, :, slot] = k_new[:, 0].to(k_pages.dtype)
    v_pages[page, :, slot] = v_new[:, 0].to(v_pages.dtype)
    out = paged_ops.paged_decode_attention(q.reshape(b, h, dh), k_pages,
                                           v_pages, block_table, seq_lens)
    return out.reshape(b, 1, h * dh) @ params["wo"].to(x.dtype)
