"""Attention: GQA (grouped-query) and MLA (multi-head latent attention,
DeepSeek), over a dense cache and over the paged pool.

The JAX package's paths, plus the serving engine's:

* ``gqa_forward`` / ``mla_forward`` — prefill or a forward over a full
  sequence, optionally q-chunked so the live score tiles stay bounded
  (MLA expands K and V from the latent per head);
* ``gqa_decode`` / ``mla_decode`` — one-token decode against a dense
  cache: GQA's (B, S_max, KVH, Dh) K and V, MLA's (B, S_max, kv_rank)
  latent and (B, S_max, rope_dim) rope key, read in the *absorbed* form
  (scores taken in the latent space, scale 1/√(dn + dr));
* ``gqa_decode_paged`` — one-token decode against the page pool
  (NP, KVH, PS, Dh) addressed by the engine's block tables: the new K/V
  row is written into its page, then kernel B8
  (``kernels.paged_attn``) attends over the planned pages;
* ``mla_decode_paged`` — the same for MLA's latent pages, (NP, PS,
  kv_rank) and (NP, PS, rope_dim): the new latent row is written into
  its page, each sequence's pages are gathered into a dense view, and
  the absorbed decode runs over it in plain PyTorch.  MLA decode has no
  Pallas kernel in the JAX package (B8 is GQA's).

Scores and softmax are float32, with the JAX package's finite mask value
``NEG_INF`` in the dense paths; B8 masks by ``pos < seq_lens``, which
agrees with the dense decode's ``pos <= position`` when
``seq_lens = position + 1``.  JAX arrays are immutable; here the dense
decodes' ``_scatter_time`` and the paged decodes' row writes update the
cache in place, and return it.  The dense decodes' softmax is the
split-KV scheme (``_split_softmax``): on one card nothing is merged; on
a mesh, whose cache is sharded on S, each rank writes and attends over
its own rows and the ranks merge their partial statistics, so no rank
gathers the cache.  The forward's attention runs on each rank's rows
and heads (``_sdpa_local``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..distributed import sharding as shd
from ..kernels._mesh import merge_split_softmax, sharding_groups
from ..kernels.paged_attn import ops as paged_ops
from .layers import (apply_rope, dense_init, rmsnorm, rmsnorm_init,
                     rope_freqs)

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10_000.0
    # MLA (None → GQA)
    q_lora_rank: int | None = None
    kv_lora_rank: int | None = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None


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
    live score tiles bounded.  On a mesh each rank attends over its own
    rows and heads (``_sdpa_local``)."""
    if shd.is_dtensor(q):
        return _sdpa_local(q, k, v, positions_q, positions_kv, causal,
                           q_chunk)
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


def _sdpa_local(q, k, v, positions_q, positions_kv, causal: bool,
                q_chunk: int | None):
    """``_sdpa`` of ``DTensor`` q, k, v, run on each rank's local blocks:
    the batch split as q's rows are, the heads split over the mesh dims
    that divide both H and KVH (GQA's groups stay whole on a rank) and
    whole elsewhere (GLM-4's 2 KV heads over 4 ranks, Yi's 7 heads: each
    of those ranks attends over every head), the sequences whole.  The
    output is placed as those blocks; the inputs' gradients come back
    on them."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    h, kvh = q.shape[2], k.shape[2]
    want = []
    for j, p in enumerate(q.placements):
        n = mesh.size(j)
        if p.is_shard(0):
            want.append(Shard(0))
        elif p.is_shard(2) and h % n == 0 and kvh % n == 0:
            want.append(Shard(2))
        else:
            want.append(Replicate())
    rows = [p if p.is_shard(0) else Replicate() for p in want]
    local = []
    for t, pl in ((q, want), (k, want), (v, want), (positions_q, rows),
                  (positions_kv, rows)):
        t = shd.replicate_like(t, q)
        if tuple(t.placements) != tuple(pl):
            t = t.redistribute(mesh, pl)
        local.append(shd.local_of(t) if t.is_floating_point()
                     else t.to_local())
    out = _sdpa(*local, causal, q_chunk)
    return shd.dtensor_of(out, mesh, want, tuple(q.shape[:3]) +
                          (v.shape[-1],))


def _qkv(params: dict, cfg: AttnConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """q (B,S,H,Dh), k and v (B,S,KVH,Dh), RoPE applied to q and k."""
    b, s, _ = x.shape
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = shd.unflatten(x @ params["wq"].to(x.dtype), 2, (h, dh))
    k = shd.unflatten(x @ params["wk"].to(x.dtype), 2, (kvh, dh))
    v = shd.unflatten(x @ params["wv"].to(x.dtype), 2, (kvh, dh))
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
    out = shd.shard_as(out.reshape(b, s, cfg.n_heads * cfg.d_head), -1,
                       params["wo"], 0) @ params["wo"].to(x.dtype)
    if return_cache:
        return out, {"k": k, "v": v}
    return out


def gqa_decode(params: dict, cfg: AttnConfig, x: torch.Tensor,
               cache: dict, position: torch.Tensor):
    """x (B,1,D); cache k/v (B,S_max,KVH,Dh); position (B,) current index.
    Returns out (B,1,D) and the cache, updated in place at
    ``position``.  A ``DTensor`` cache sharded on S is read where it
    lies (``_at_cache``, ``_split_softmax``)."""
    b = x.shape[0]
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k_new, v_new = _qkv(params, cfg, x, position[:, None])
    at = _at_cache(cache["k"], q, k_new, v_new, position)
    q, k_new, v_new, pos = at.tensors
    k = _scatter_time(at.local(cache["k"]), k_new, pos, at.lo)
    v = _scatter_time(at.local(cache["v"]), v_new, pos, at.lo)
    qg = q[:, 0].reshape(q.shape[0], kvh, h // kvh, dh)
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    live = at.lo + torch.arange(k.shape[1], device=k.device)[None, :] <= \
        pos.long()[:, None]
    scores = torch.where(live[:, None, None, :], scores, NEG_INF)
    out = _split_softmax(scores, lambda e: torch.einsum(
        "bkgs,bskd->bkgd", e, v.float()), at.groups)
    out = at.placed(out.reshape(-1, 1, h * dh).to(x.dtype), (b, 1, h * dh))
    return out @ params["wo"].to(x.dtype), cache


class _CacheView(NamedTuple):
    """``_at_cache``'s result: the decode's tensors as local tensors
    beside this rank's cache rows, the cache's first sequence index
    here, the groups that split its sequence, and how to place a
    result."""
    tensors: tuple
    lo: int
    groups: list
    mesh: Any
    placements: tuple

    def local(self, cache: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``cache`` (a view: writes land in it)."""
        return cache.to_local() if self.mesh is not None else cache

    def placed(self, t: torch.Tensor, shape: tuple):
        """A local (B', ...) result, whole on every rank but for the
        cache's batch split, as a ``DTensor`` of global ``shape``."""
        if self.mesh is None:
            return t
        return shd.dtensor_of(t, self.mesh, self.placements, shape)


def _at_cache(cache: torch.Tensor, *tensors) -> _CacheView:
    """The decode's ``tensors`` (B, ...) beside a dense cache (B, S, ...):
    on one card as they are; on a mesh, each made whole but for the
    cache's batch split (sharded on the mesh dims that shard the
    cache's B, replicated on the others: the new token's q, k and v are
    a few rows) and taken as this rank's local tensor.  The cache is
    never gathered: each rank attends over its own S rows and the
    ranks that split S merge their softmax partials
    (``_split_softmax``)."""
    if not shd.is_dtensor(cache):
        return _CacheView(tensors, 0, [], None, ())
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    want = tuple(Shard(0) if p.is_shard(0) else Replicate()
                 for p in cache.placements)
    local = []
    for t in tensors:
        t = shd.replicate_like(t, cache)
        if tuple(t.placements) != want:
            t = t.redistribute(mesh, want)
        local.append(t.to_local())
    return _CacheView(tuple(local), shd.local_range(cache, 1)[0],
                      sharding_groups(cache, 1), mesh, want)


def store_prefix(cache: torch.Tensor, value: torch.Tensor) -> None:
    """cache (B, S_max, ...) ← value (B, S, ...) at [:, :S], in place (a
    prefill's rows).  On a mesh each rank writes the rows of its own
    part of the cache, from ``value`` made whole but for the cache's
    batch split (``_at_cache``)."""
    at = _at_cache(cache, value)
    (v,) = at.tensors
    local = at.local(cache)
    n = max(0, min(v.shape[1] - at.lo, local.shape[1]))
    local[:, :n] = v[:, at.lo:at.lo + n]


def _split_softmax(scores: torch.Tensor, weigh, groups: list
                   ) -> torch.Tensor:
    """``softmax(scores) · V`` over this rank's keys (the last dim), by
    the split-KV scheme: the running maximum, the sum of ``exp(s - m)``
    and ``weigh(exp(s - m))`` (the exponentials times V), merged over
    ``groups`` (the ranks that split the keys,
    ``merge_split_softmax``), then the weighted values over the sum.
    One card, or one rank, runs the same operations with nothing to
    merge."""
    if scores.shape[-1]:
        m = scores.amax(dim=-1)
    else:                   # no keys here: this rank's parts weigh 0
        m = torch.full(scores.shape[:-1], NEG_INF, dtype=scores.dtype,
                       device=scores.device)
    e = torch.exp(scores - m[..., None])
    _, (den, num) = merge_split_softmax(m, (e.sum(dim=-1), weigh(e)),
                                        groups)
    return num / den[..., None]


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  position: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """cache (B,S,…), sequence rows [lo, lo + S), ← new (B,1,…) at
    per-batch position where it falls in those rows, in place: a
    one-slot write per sequence, as the JAX package's donated
    dynamic-update-slice is (a sequence whose position lies on another
    rank's rows keeps its slot)."""
    if cache.shape[1] == 0:
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = position.long() - lo
    mine = (at >= 0) & (at < cache.shape[1])
    at = at.clamp(0, cache.shape[1] - 1)
    mine = mine.reshape((-1,) + (1,) * (cache.ndim - 2))
    cache[rows, at] = torch.where(mine, new[:, 0].to(cache.dtype),
                                  cache[rows, at])
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


# =====================================================================
# MLA (DeepSeek-V2/V3 multi-head latent attention)
# =====================================================================
def mla_init(cfg: AttnConfig, **kw) -> dict:
    """``wkv_a``, ``kv_norm``, ``wk_b``, ``wv_b``, ``wo`` and either
    ``wq_a``, ``q_norm``, ``wq_b`` (with ``q_lora_rank``) or ``wq``."""
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {
        "wkv_a": dense_init(d, kvr + dr, **kw)["w"],
        "kv_norm": rmsnorm_init(kvr, **kw),
        "wk_b": dense_init(kvr, h * dn, **kw)["w"],
        "wv_b": dense_init(kvr, h * dv, **kw)["w"],
        "wo": dense_init(h * dv, d, **kw)["w"],
    }
    if qr is not None:
        p["wq_a"] = dense_init(d, qr, **kw)["w"]
        p["q_norm"] = rmsnorm_init(qr, **kw)
        p["wq_b"] = dense_init(qr, h * (dn + dr), **kw)["w"]
    else:
        p["wq"] = dense_init(d, h * (dn + dr), **kw)["w"]
    return p


def _mla_q(params: dict, cfg: AttnConfig, x: torch.Tensor):
    """x (B,S,D) → q_nope (B,S,H,dn), q_rope (B,S,H,dr), RoPE not yet
    applied."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank is not None:
        ql = rmsnorm(params["q_norm"], x @ params["wq_a"].to(x.dtype))
        q = ql @ params["wq_b"].to(x.dtype)
    else:
        q = x @ params["wq"].to(x.dtype)
    q = shd.unflatten(q, 2, (h, dn + dr))
    return q[..., :dn], q[..., dn:]


def _mla_latent(params: dict, cfg: AttnConfig, x: torch.Tensor, cos, sin):
    """x (B,S,D) → the latent c_kv (B,S,kv_rank), normed, and the rope
    key (B,S,dr), rotated: what the cache holds."""
    b, s, _ = x.shape
    kvr, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv = x @ params["wkv_a"].to(x.dtype)                  # (B,S,kvr+dr)
    c_kv = rmsnorm(params["kv_norm"], kv[..., :kvr])
    k_rope = apply_rope(kv[..., kvr:].reshape(b, s, 1, dr), cos, sin)
    return c_kv, k_rope[:, :, 0]


def mla_forward(params: dict, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                q_chunk: int | None = 1024, return_cache: bool = False):
    """x (B,S,D) → (B,S,D), K and V expanded from the latent per head;
    with ``return_cache`` also ``{"c_kv", "k_rope"}`` (B,S,kv_rank) and
    (B,S,dr)."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _mla_q(params, cfg, x)
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_kv, k_rope = _mla_latent(params, cfg, x, cos, sin)

    k_nope = shd.unflatten(c_kv @ params["wk_b"].to(x.dtype), 2, (h, dn))
    v = shd.unflatten(c_kv @ params["wv_b"].to(x.dtype), 2, (h, dv))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, dr)], dim=-1)
    out = _sdpa(q, k, v, positions, positions, causal, q_chunk)
    out = shd.shard_as(out.reshape(b, s, h * dv), -1, params["wo"], 0) @ \
        params["wo"].to(x.dtype)
    if return_cache:
        return out, {"c_kv": c_kv, "k_rope": k_rope}
    return out


def _mla_absorbed(params: dict, cfg: AttnConfig, x: torch.Tensor,
                  q_nope: torch.Tensor, q_rope: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor,
                  live: torch.Tensor) -> torch.Tensor:
    """One query token per sequence over its latent rows: q_nope
    (B,H,dn), q_rope (B,H,dr) rotated, c_kv (B,S,kv_rank), k_rope
    (B,S,dr), live (B,S) → (B,1,D).  W_kb is absorbed into q and W_vb
    applied after the latent output, all in float32."""
    o_lat = _mla_attend(cfg, _mla_q_latent(params, cfg, q_nope), q_rope,
                        c_kv, k_rope, live, [])
    return _mla_out(params, cfg, x, o_lat)


def _mla_q_latent(params: dict, cfg: AttnConfig,
                  q_nope: torch.Tensor) -> torch.Tensor:
    """q_nope (B,H,dn) with W_kb absorbed: (B,H,kv_rank) float32."""
    wkb = shd.unflatten(params["wk_b"].float(), 1, (cfg.n_heads,
                                                    cfg.qk_nope_dim))
    return torch.einsum("bhd,rhd->bhr", q_nope.float(), wkb)


def _mla_attend(cfg: AttnConfig, q_lat: torch.Tensor, q_rope: torch.Tensor,
                c_kv: torch.Tensor, k_rope: torch.Tensor, live: torch.Tensor,
                groups: list) -> torch.Tensor:
    """The latent output (B,H,kv_rank) float32 of the absorbed scores
    over this rank's latent rows, merged over ``groups``
    (``_split_softmax``)."""
    c32 = c_kv.float()
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat, c32)        # (B,H,S)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope.float(), k_rope.float())
    scores = (s_lat + s_rope) * (1.0 / math.sqrt(cfg.qk_nope_dim
                                                 + cfg.qk_rope_dim))
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    return _split_softmax(scores, lambda e: torch.einsum(
        "bhs,bsr->bhr", e, c32), groups)


def _mla_out(params: dict, cfg: AttnConfig, x: torch.Tensor,
             o_lat: torch.Tensor) -> torch.Tensor:
    """The latent output (B,H,kv_rank) through W_vb and W_o: (B,1,D)."""
    h, dv = cfg.n_heads, cfg.v_head_dim
    wvb = shd.unflatten(params["wv_b"].float(), 1, (h, dv))
    out = torch.einsum("bhr,rhd->bhd", o_lat, wvb)          # absorb W_vb
    return out.reshape(x.shape[0], 1, h * dv).to(x.dtype) @ \
        params["wo"].to(x.dtype)


def _mla_decode_q(params: dict, cfg: AttnConfig, x: torch.Tensor,
                  position: torch.Tensor):
    """The decode token's q_nope, rotated q_rope (B,H,·) and its new
    latent and rope-key rows (B,1,·)."""
    q_nope, q_rope = _mla_q(params, cfg, x)                # (B,1,H,dn/dr)
    cos, sin = rope_freqs(position[:, None], cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    c_new, kr_new = _mla_latent(params, cfg, x, cos, sin)
    return q_nope[:, 0], q_rope[:, 0], c_new, kr_new


def mla_decode(params: dict, cfg: AttnConfig, x: torch.Tensor,
               cache: dict, position: torch.Tensor):
    """Absorbed-matmul MLA decode over a dense cache: x (B,1,D); cache
    ``c_kv`` (B,S_max,kv_rank) and ``k_rope`` (B,S_max,dr); position
    (B,).  Returns out (B,1,D) and the cache, updated in place at
    ``position``.  A ``DTensor`` cache sharded on S is read where it
    lies: W_kb is absorbed with the heads split, the latent query
    (B,H,kv_rank) made whole, and each rank attends over its own rows
    (``_at_cache``)."""
    b = x.shape[0]
    q_nope, q_rope, c_new, kr_new = _mla_decode_q(params, cfg, x, position)
    at = _at_cache(cache["c_kv"], _mla_q_latent(params, cfg, q_nope),
                   q_rope, c_new, kr_new, position)
    q_lat, q_rope, c_new, kr_new, pos = at.tensors
    c_kv = _scatter_time(at.local(cache["c_kv"]), c_new, pos, at.lo)
    k_rope = _scatter_time(at.local(cache["k_rope"]), kr_new, pos, at.lo)
    live = at.lo + torch.arange(c_kv.shape[1], device=c_kv.device)[
        None, :] <= pos.long()[:, None]
    o_lat = _mla_attend(cfg, q_lat, q_rope, c_kv, k_rope, live, at.groups)
    o_lat = at.placed(o_lat, (b, cfg.n_heads, cfg.kv_lora_rank))
    return _mla_out(params, cfg, x, o_lat), cache


def mla_decode_paged(params: dict, cfg: AttnConfig, x: torch.Tensor,
                     c_pages: torch.Tensor, r_pages: torch.Tensor,
                     position: torch.Tensor, block_table: torch.Tensor,
                     seq_lens: torch.Tensor) -> torch.Tensor:
    """One decode token per sequence against the latent page pool.

    x (B,1,D); c_pages (NP,PS,kv_rank) and r_pages (NP,PS,dr), this
    layer's pool; position, block_table (B,PMAX) and seq_lens as
    ``gqa_decode_paged`` takes them.  The new latent row is written in
    place into page ``block_table[b, pos // PS]``, slot ``pos % PS``;
    then each sequence's PMAX pages are gathered (unused entries, -1,
    read page 0) into a (B, PMAX·PS, ·) view and the absorbed decode
    attends over the ``seq_lens[b]`` live rows; the rest are masked, so
    what they hold never reaches the output.
    Returns (B,1,D)."""
    ps = c_pages.shape[1]
    b, pmax = block_table.shape
    q_nope, q_rope, c_new, kr_new = _mla_decode_q(params, cfg, x, position)
    pos = position.long()
    table = block_table.long()
    page = table.gather(1, (pos // ps)[:, None])[:, 0]
    slot = pos % ps
    c_pages[page, slot] = c_new[:, 0].to(c_pages.dtype)
    r_pages[page, slot] = kr_new[:, 0].to(r_pages.dtype)
    pages = table.clamp(min=0)
    live = torch.arange(pmax * ps, device=x.device)[None, :] < \
        seq_lens.long()[:, None]
    # Rows past seq_lens (the last page's tail, unused entries) score
    # NEG_INF and weigh 0: zeroed, whatever they hold, as B8 never reads
    # them.
    c_kv = torch.where(live[..., None],
                       c_pages[pages].reshape(b, pmax * ps, -1), 0)
    k_rope = r_pages[pages].reshape(b, pmax * ps, -1)
    return _mla_absorbed(params, cfg, x, q_nope, q_rope, c_kv, k_rope, live)
