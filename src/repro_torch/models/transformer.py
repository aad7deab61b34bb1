"""The dense GQA decoder (GLM-4, Granite, Yi): forward, prefill and
decode over a dense cache, and the serving engine's paged prefill and
decode over the page pool.

Parameters are a nested dict of tensors with the JAX package's keys:
``embed.table``, ``final_norm.scale``, ``head.w`` (untied embeddings
only) and, per layer, ``attn_norm``, ``attn`` (``wq``, ``wk``, ``wv``,
``wo``), ``ffn_norm`` and ``ffn`` (``w_gate``, ``w_up``, ``w_down``).
The JAX package stacks a group's layers along a leading axis for
``jax.lax.scan``; here ``params["layers"]`` is a list, one dict per
layer, run by a Python loop (``carry.transformer_from_params`` unstacks
a JAX tree).  The dense caches keep the JAX layout, one group of
``{"k", "v"}`` stacked (L, B, S_max, KVH, Dh); the page pool is one
(L, NP, KVH, PS, Dh) tensor each for K and V.

Left out, as for NequIP: ``constrain`` (a sharding hint for the pod) and
``jax.checkpoint`` (recomputation for training).  Not ported yet: MoE,
dense-residual MoE and MTP (DeepSeek-V3, Arctic; ROADMAP A10b), MLA
(A10b) and learned positions (BERT4Rec; A10c): a configuration that asks
for one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .._device import resolve_device
from .attention import (AttnConfig, gqa_decode, gqa_decode_paged,
                        gqa_forward, gqa_init)
from .layers import (dense_init, embed, embedding_init, glu_ffn,
                     glu_ffn_init, rmsnorm, rmsnorm_init, unembed)

Params = dict


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    # attention
    attn_type: str = "gqa"                  # "gqa" | "mla" (not ported)
    rope_theta: float = 10_000.0
    causal: bool = True
    learned_pos: bool = False               # BERT4Rec (not ported)
    # ffn and heads
    moe: Any = None                         # MoE (not ported)
    mtp: bool = False                       # DeepSeek MTP (not ported)
    tied_embeddings: bool = True
    # execution
    dtype: torch.dtype = torch.float32
    q_chunk: int | None = 1024

    def attn_config(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=self.rope_theta)


def check_ported(cfg: TransformerConfig) -> None:
    """Raise for a configuration this module does not run yet."""
    if cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attn_type} attention is not ported yet "
            f"(ROADMAP A10b)")
    if cfg.moe is not None or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MTP are not ported yet (ROADMAP A10b)")
    if cfg.learned_pos:
        raise NotImplementedError(
            f"{cfg.name}: learned positions are not ported yet "
            f"(ROADMAP A10c)")


# -- init --------------------------------------------------------------------
def init_params(cfg: TransformerConfig, device=None, seed: int = 0
                ) -> Params:
    """Random weights as the JAX package's ``init_params`` draws them
    (normal · 1/√d_in, embeddings · 0.02, norms ones), in ``cfg.dtype``
    on ``device`` (None = the card), from a ``torch.Generator`` seeded
    with ``seed``.  Each tensor is drawn in place where it lives, so the
    weights are never held twice.  ``device="meta"`` gives the shapes
    and allocates nothing."""
    check_ported(cfg)
    dev = torch.device("meta") if device == "meta" else \
        resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev, dtype=cfg.dtype)
    d = cfg.d_model
    params: Params = {
        "embed": embedding_init(cfg.vocab, d, **kw),
        "final_norm": rmsnorm_init(d, **kw),
        "layers": [],
    }
    if not cfg.tied_embeddings:
        params["head"] = dense_init(d, cfg.vocab, **kw)
    acfg = cfg.attn_config()
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": rmsnorm_init(d, **kw),
            "attn": gqa_init(acfg, **kw),
            "ffn_norm": rmsnorm_init(d, **kw),
            "ffn": glu_ffn_init(d, cfg.d_ff, **kw),
        })
    return params


def tree_leaves(tree):
    """The leaves of a nested dict/list tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def count_params(params: Params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# -- forward -------------------------------------------------------------
def _embed(params: Params, cfg: TransformerConfig, tokens: torch.Tensor):
    return embed(params["embed"], tokens).to(cfg.dtype)


def _ffn_block(lp: Params, x: torch.Tensor) -> torch.Tensor:
    return x + glu_ffn(lp["ffn"], rmsnorm(lp["ffn_norm"], x))


def _logits(params: Params, cfg: TransformerConfig, h: torch.Tensor):
    if cfg.tied_embeddings:
        return unembed(params["embed"], h)
    return h @ params["head"]["w"].to(h.dtype)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def trunk(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (hidden (B, S, D) after final norm, aux_loss)."""
    check_ported(cfg)
    if positions is None:
        positions = _positions(tokens)
    acfg = cfg.attn_config()
    x = _embed(params, cfg, tokens)
    for lp in params["layers"]:
        h = gqa_forward(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x),
                        positions, causal=cfg.causal, q_chunk=cfg.q_chunk)
        x = _ffn_block(lp, x + h)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x), aux


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V), aux_loss)."""
    h, aux = trunk(params, cfg, tokens, positions)
    return _logits(params, cfg, h), aux


# -- serving over a dense cache ------------------------------------------
def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None, device=None) -> list:
    """Dense decode cache: one group ``{"k", "v"}`` stacked
    (L, B, S_max, KVH, Dh), zeros."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    kw = dict(dtype=dtype or cfg.dtype, device=resolve_device(device))
    return [{"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}]


def _prefill_trunk(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor, store) -> torch.Tensor:
    """Run the prompt, hand each layer's K/V (B, S, KVH, Dh) to
    ``store(layer, k, v)``, and return the last position's logits."""
    check_ported(cfg)
    positions = _positions(tokens)
    acfg = cfg.attn_config()
    x = _embed(params, cfg, tokens)
    for i, lp in enumerate(params["layers"]):
        h, kv = gqa_forward(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x),
                            positions, causal=cfg.causal,
                            q_chunk=cfg.q_chunk, return_cache=True)
        store(i, kv["k"], kv["v"])
        x = _ffn_block(lp, x + h)
    h = rmsnorm(params["final_norm"], x[:, -1:])
    return _logits(params, cfg, h)[:, 0]


def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            max_seq: int) -> tuple[torch.Tensor, list]:
    """Run the full prompt; return last-position logits (B, V) and the
    filled dense cache, padded with zeros to ``max_seq``."""
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_seq, device=tokens.device)

    def store(i, k, v):
        caches[0]["k"][i, :, :s] = k
        caches[0]["v"][i, :, :s] = v

    return _prefill_trunk(params, cfg, tokens, store), caches


def decode_step(params: Params, cfg: TransformerConfig, caches: list,
                token: torch.Tensor, position: torch.Tensor
                ) -> tuple[torch.Tensor, list]:
    """One decode step over the dense cache.  token (B,), position (B,)
    → logits (B, V); the caches are updated in place and returned."""
    check_ported(cfg)
    acfg = cfg.attn_config()
    x = _embed(params, cfg, token[:, None])
    cache = caches[0]
    for i, lp in enumerate(params["layers"]):
        lc = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = gqa_decode(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x),
                          lc, position)
        x = _ffn_block(lp, x + h)
    h = rmsnorm(params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], caches


# -- serving over the page pool ------------------------------------------
def init_paged_cache(cfg: TransformerConfig, n_pages: int, page_size: int,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The K and V page pools, (L, NP, KVH, PS, Dh) each in
    ``cfg.dtype``, zeros."""
    check_ported(cfg)
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.d_head)
    kw = dict(dtype=cfg.dtype, device=resolve_device(device))
    return torch.zeros(shape, **kw), torch.zeros(shape, **kw)


def prefill_paged(params: Params, cfg: TransformerConfig,
                  tokens: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, pages: torch.Tensor
                  ) -> torch.Tensor:
    """Prefill one prompt (1, S) and write its K/V into ``pages`` (the
    pager's table for it, ceil(S / PS) page ids) of every layer's pool,
    in place: token t goes to page ``pages[t // PS]``, slot
    ``t % PS``.  Returns the last position's logits (1, V)."""
    s = tokens.shape[1]
    ps = k_pool.shape[3]
    t = torch.arange(s, device=tokens.device)
    page, slot = pages.long()[t // ps], t % ps

    def store(i, k, v):
        k_pool[i, page, :, slot] = k[0]
        v_pool[i, page, :, slot] = v[0]

    return _prefill_trunk(params, cfg, tokens, store)


def decode_paged(params: Params, cfg: TransformerConfig,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 token: torch.Tensor, position: torch.Tensor,
                 block_table: torch.Tensor, seq_lens: torch.Tensor
                 ) -> torch.Tensor:
    """One batched decode step over the page pool: token (B,), position
    (B,), block_table (B, PMAX), seq_lens (B,) = position + 1 →
    logits (B, V).  Each layer writes the new K/V row into the pool in
    place and launches B8 once over all B sequences."""
    check_ported(cfg)
    acfg = cfg.attn_config()
    x = _embed(params, cfg, token[:, None])
    for i, lp in enumerate(params["layers"]):
        h = gqa_decode_paged(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x),
                             k_pool[i], v_pool[i], position, block_table,
                             seq_lens)
        x = _ffn_block(lp, x + h)
    h = rmsnorm(params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0]
