"""The decoder of the five LM architectures: dense GQA (GLM-4, Granite,
Yi), MLA with fine-grained MoE and MTP (DeepSeek-V3) and dense-residual
MoE (Arctic); forward, prefill and decode over a dense cache, and the
serving engine's paged prefill and decode over the page pool.

Parameters are a nested dict of tensors with the JAX package's keys:
``embed.table``, ``final_norm.scale``, ``head.w`` (untied embeddings
only), ``mtp`` (DeepSeek's multi-token-prediction head: ``norm_h``,
``norm_e``, ``proj``, ``layer``) and, per layer, ``attn_norm``, ``attn``
(GQA's ``wq``, ``wk``, ``wv``, ``wo`` or MLA's, ``attention.mla_init``),
``ffn_norm`` and the FFN: ``ffn`` (``w_gate``, ``w_up``, ``w_down``) in a
dense layer, ``moe`` (``moe.moe_init``) in an MoE layer, and both with
``dense_residual``.  The JAX package stacks each group of layers
(``layer_groups``: DeepSeek's leading dense layers, then the MoE layers)
along a leading axis for ``jax.lax.scan``; here ``params["layers"]`` is
a list, one dict per layer in execution order, run by a Python loop
(``carry.transformer_from_params`` unstacks a JAX tree).  The dense
caches keep the JAX layout, one dict per group stacked (L_group, B,
S_max, ...): ``{"k", "v"}`` for GQA, ``{"c_kv", "k_rope"}`` for MLA.
The page pools are two tensors over all layers: K and V, (L, NP, KVH,
PS, Dh) each, for GQA; the latent and the rope key, (L, NP, PS,
kv_rank) and (L, NP, PS, rope_dim), for MLA.  The engine holds either
pair the same way.

MoE layers route with capacity on the forward and prefill paths and
dropless on the decode paths, as in the JAX package.  The ``mtp``
subtree is drawn and carried; serving never reads it, and the training
loss (``loss_fn``) adds its ``_mtp_loss``.

Training: ``loss_fn`` is the JAX package's (cross-entropy, plus the MoE
aux loss, plus ``mtp_loss_weight`` × the MTP loss).  With ``remat`` (the
JAX configuration's field, on by default) ``trunk`` recomputes each
layer in the backward pass whenever a gradient will be taken
(``torch.utils.checkpoint``, non-reentrant), as the JAX package's
``jax.checkpoint`` does: only each layer's input is kept.  A train
state holds the parameters flat, keyed by the JAX tree's paths with
each group's layers stacked (``"groups/0/attn/wq"`` (L_group, ...)):
``stack_groups`` builds that tree from the port's nested one, and
``unstack_groups`` gives the port's nested tree back as views of the
stacked tensors (``torch.unbind``, whose backward is one ``stack`` of
the layers' gradients).

Learned positions (BERT4Rec, ``learned_pos``): a ``pos_embed.table``
(max_seq, D) whose row at each token's position is added to its
embedding, on top of RoPE inside attention, wherever the JAX package
adds it (``trunk``, ``prefill``, ``decode_step``) and in the paged
prefill and decode the engine serves through.  A position outside
[0, max_seq) raises ``IndexError`` before the table is read (ROADMAP
C12), where the JAX package's ``jnp.take`` would return a NaN row.

The JAX package's ``constrain`` calls (``distributed.context``, sharding
hints for the pod) are not made here: the paged decode calls kernel
B8 (``kernels.paged_attn``) on local tensors through raw pointers,
which has no ``DTensor`` sharding rule, so the decoder runs on one
card's tensors, as NequIP does.  ``configs.common.lm_arch`` gives its shardings for the
dry run.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device, seeded_generator
from .attention import (AttnConfig, gqa_decode, gqa_decode_paged,
                        gqa_forward, gqa_init, mla_decode, mla_decode_paged,
                        mla_forward, mla_init)
from .layers import (cross_entropy, dense_init, embed, embedding_init,
                     glu_ffn, glu_ffn_init, rmsnorm, rmsnorm_init, unembed)
from .moe import MoEConfig, moe_ffn, moe_init

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
    attn_type: str = "gqa"                  # "gqa" | "mla"
    q_lora_rank: int | None = None
    kv_lora_rank: int | None = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10_000.0
    causal: bool = True
    learned_pos: bool = False               # BERT4Rec-style
    max_seq: int = 8192                     # for learned positions only
    # ffn
    moe: MoEConfig | None = None
    n_dense_layers: int = 0                 # leading dense layers w/ MoE
    dense_d_ff: int | None = None           # d_ff of those dense layers
    dense_residual: bool = False            # Arctic: dense FFN ∥ MoE
    # heads
    mtp: bool = False                       # DeepSeek multi-token predict
    mtp_loss_weight: float = 0.3
    tied_embeddings: bool = True
    # execution
    dtype: torch.dtype = torch.float32
    q_chunk: int | None = 1024
    remat: bool = True

    def attn_config(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=self.rope_theta, q_lora_rank=self.q_lora_rank,
            kv_lora_rank=self.kv_lora_rank, qk_nope_dim=self.qk_nope_dim,
            qk_rope_dim=self.qk_rope_dim, v_head_dim=self.v_head_dim)

    def layer_groups(self) -> list[tuple[int, bool]]:
        """[(n_layers, uses_moe), …] in execution order."""
        if self.moe is None:
            return [(self.n_layers, False)]
        if self.n_dense_layers:
            return [(self.n_dense_layers, False),
                    (self.n_layers - self.n_dense_layers, True)]
        return [(self.n_layers, True)]

    def layer_uses_moe(self) -> list[bool]:
        """Whether each layer, in execution order, is an MoE layer."""
        return [m for n, m in self.layer_groups() for _ in range(n)]


# -- init --------------------------------------------------------------------
def _layer_init(cfg: TransformerConfig, use_moe: bool, **kw) -> Params:
    acfg = cfg.attn_config()
    d = cfg.d_model
    p = {
        "attn_norm": rmsnorm_init(d, **kw),
        "attn": (mla_init(acfg, **kw) if cfg.attn_type == "mla"
                 else gqa_init(acfg, **kw)),
        "ffn_norm": rmsnorm_init(d, **kw),
    }
    if use_moe:
        p["moe"] = moe_init(cfg.moe, **kw)
        if cfg.dense_residual:
            p["ffn"] = glu_ffn_init(d, cfg.dense_d_ff or cfg.d_ff, **kw)
    else:
        d_ff = cfg.dense_d_ff if (cfg.moe is not None and cfg.dense_d_ff) \
            else cfg.d_ff
        p["ffn"] = glu_ffn_init(d, d_ff, **kw)
    return p


def init_params(cfg: TransformerConfig, device=None, seed: int = 0
                ) -> Params:
    """Random weights as the JAX package's ``init_params`` draws them
    (normal · 1/√d_in, embeddings · 0.02, norms ones; the MoE router in
    float32, everything else in ``cfg.dtype``) on ``device`` (None = the
    card), from a ``torch.Generator`` seeded with ``seed``.  Each tensor
    is drawn in place where it lives, so the weights are never held
    twice.  ``device="meta"`` gives the shapes and allocates nothing."""
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    kw = dict(generator=gen, device=dev, dtype=cfg.dtype)
    d = cfg.d_model
    params: Params = {
        "embed": embedding_init(cfg.vocab, d, **kw),
        "final_norm": rmsnorm_init(d, **kw),
        "layers": [_layer_init(cfg, m, **kw) for m in cfg.layer_uses_moe()],
    }
    if cfg.learned_pos:
        params["pos_embed"] = embedding_init(cfg.max_seq, d, **kw)
    if not cfg.tied_embeddings:
        params["head"] = dense_init(d, cfg.vocab, **kw)
    if cfg.mtp:
        params["mtp"] = {
            "norm_h": rmsnorm_init(d, **kw),
            "norm_e": rmsnorm_init(d, **kw),
            "proj": dense_init(2 * d, d, **kw),
            "layer": _layer_init(cfg, False, **kw),
        }
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
def check_positions(cfg: TransformerConfig, positions: torch.Tensor,
                    span: tuple[int, int] | None = None) -> None:
    """Raise ``IndexError`` unless every position lies in [0, max_seq)
    of a learned position table (ROADMAP C12).  ``span`` is the (lowest,
    highest) position where the caller knows it; else it is read from
    ``positions`` (one read back from the card)."""
    if not cfg.learned_pos or positions.numel() == 0:
        return
    if span is None:
        span = tuple(torch.stack(torch.aminmax(positions)).tolist())
    lo, hi = span
    if lo < 0 or hi >= cfg.max_seq:
        raise IndexError(f"{cfg.name}: positions span [{lo}, {hi}], "
                         f"outside the [0, {cfg.max_seq}) of its learned "
                         f"position table")


def _embed(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
           positions: torch.Tensor, span: tuple[int, int] | None = None):
    """The token embeddings, plus the learned position embeddings where
    the configuration has them (``check_positions`` first)."""
    x = embed(params["embed"], tokens).to(cfg.dtype)
    if cfg.learned_pos:
        check_positions(cfg, positions, span)
        x = x + embed(params["pos_embed"], positions).to(cfg.dtype)
    return x


def _ffn_block(cfg: TransformerConfig, use_moe: bool, lp: Params,
               x: torch.Tensor, dropless: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The residual FFN half of a layer (``_layer_apply``'s second half):
    (x + FFN(norm(x)), the MoE aux loss or None)."""
    f = rmsnorm(lp["ffn_norm"], x)
    if not use_moe:
        return x + glu_ffn(lp["ffn"], f), None
    out, aux = moe_ffn(lp["moe"], cfg.moe, f, dropless=dropless)
    if cfg.dense_residual:
        out = out + glu_ffn(lp["ffn"], f)
    return x + out, aux


def _logits(params: Params, cfg: TransformerConfig, h: torch.Tensor):
    if cfg.tied_embeddings:
        return unembed(params["embed"], h)
    return h @ params["head"]["w"].to(h.dtype)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device)[None, :].expand(b, s)


def _forward_attn(cfg: TransformerConfig):
    return mla_forward if cfg.attn_type == "mla" else gqa_forward


def _layer_apply(cfg: TransformerConfig, use_moe: bool, lp: Params,
                 x: torch.Tensor, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: (its output, the MoE aux loss or None)."""
    h = _forward_attn(cfg)(lp["attn"], cfg.attn_config(),
                           rmsnorm(lp["attn_norm"], x), positions,
                           causal=cfg.causal, q_chunk=cfg.q_chunk)
    return _ffn_block(cfg, use_moe, lp, x + h)


def _needs_remat(cfg: TransformerConfig, params: Params) -> bool:
    """Whether ``trunk`` recomputes its layers: ``cfg.remat`` and a
    gradient will be taken through them."""
    return cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params["layers"]))


def trunk(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (hidden (B, S, D) after final norm, aux_loss, the
    MoE layers' summed)."""
    span = None
    if positions is None:
        positions, span = _positions(tokens), (0, tokens.shape[1] - 1)
    x = _embed(params, cfg, tokens, positions, span)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _needs_remat(cfg, params)
    for lp, use_moe in zip(params["layers"], cfg.layer_uses_moe()):
        if remat:
            x, a = checkpoint(_layer_apply, cfg, use_moe, lp, x, positions,
                              use_reentrant=False)
        else:
            x, a = _layer_apply(cfg, use_moe, lp, x, positions)
        if a is not None:
            aux = aux + a
    return rmsnorm(params["final_norm"], x), aux


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V), aux_loss)."""
    h, aux = trunk(params, cfg, tokens, positions)
    return _logits(params, cfg, h), aux


# -- training ----------------------------------------------------------------
def loss_fn(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor, mask: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """(cross-entropy of ``labels`` + the MoE aux loss + ``mtp_loss_weight``
    × the MTP loss where the configuration has it, {"ce", "aux",
    "mtp_ce"}), as the JAX package's ``loss_fn``."""
    logits, aux = forward(params, cfg, tokens)
    ce = cross_entropy(logits, labels, mask)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mtp_ce = _mtp_loss(params, cfg, tokens, labels)
        loss = loss + cfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


def _mtp_loss(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's depth-1 multi-token prediction as the JAX package
    writes it: the token's embedding and the next token's (``roll`` by
    one), each RMS-normed, concatenated and projected, one dense layer,
    the final norm and the tied unembedding, predicting the label after
    next (``roll`` of the labels); the last two positions are masked."""
    b, s = tokens.shape
    positions = _positions(tokens)
    x = embed(params["embed"], tokens).to(cfg.dtype)
    nxt = torch.roll(tokens, -1, dims=1)
    mp = params["mtp"]
    hcat = torch.cat([
        rmsnorm(mp["norm_h"], x),
        rmsnorm(mp["norm_e"], embed(params["embed"], nxt).to(cfg.dtype)),
    ], dim=-1)
    h = hcat @ mp["proj"]["w"].to(cfg.dtype)
    h, _ = _layer_apply(cfg, False, mp["layer"], h, positions)
    logits = unembed(params["embed"], rmsnorm(params["final_norm"], h))
    mtp_labels = torch.roll(labels, -1, dims=1)
    mask = (torch.arange(s, device=tokens.device)[None, :] < s - 2).to(
        torch.float32).expand(b, s)
    return cross_entropy(logits, mtp_labels, mask)


def stack_groups(params: Params, cfg: TransformerConfig) -> Params:
    """The port's nested parameters as the JAX package's tree: the layers
    of each of ``cfg.layer_groups()``'s groups stacked along a leading
    axis under ``"groups"`` (new tensors; the per-layer ones are
    dropped from the returned tree)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["groups"], i = [], 0
    for n, _ in cfg.layer_groups():
        group = params["layers"][i:i + n]
        out["groups"].append(_stack(group))
        i += n
    return out


def _stack(layers: list):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in first}
    return torch.stack(layers)


def unstack_groups(tree: Params, cfg: TransformerConfig) -> Params:
    """The inverse of ``stack_groups``: the port's nested parameters,
    each layer's tensors views of the group's stacked ones."""
    out = {k: v for k, v in tree.items() if k != "groups"}
    out["layers"] = []
    for (n, _), group in zip(cfg.layer_groups(), tree["groups"]):
        out["layers"].extend(_unbind(group, n))
    return out


def _unbind(group, n: int) -> list:
    if isinstance(group, dict):
        parts = {k: _unbind(v, n) for k, v in group.items()}
        return [{k: v[j] for k, v in parts.items()} for j in range(n)]
    return list(torch.unbind(group, 0))


# -- serving over a dense cache ------------------------------------------
def _cache_shapes(cfg: TransformerConfig, batch: int, max_seq: int
                  ) -> dict[str, tuple[int, ...]]:
    """One layer's dense cache entries, (B, S_max, ...) each."""
    if cfg.attn_type == "mla":
        return {"c_kv": (batch, max_seq, cfg.kv_lora_rank),
                "k_rope": (batch, max_seq, cfg.qk_rope_dim)}
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": kv, "v": kv}


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None, device=None) -> list:
    """Dense decode cache, one dict per layer group stacked (L_group, B,
    S_max, ...): ``{"k", "v"}`` (GQA) or ``{"c_kv", "k_rope"}`` (MLA),
    zeros."""
    kw = dict(dtype=dtype or cfg.dtype, device=resolve_device(device))
    shapes = _cache_shapes(cfg, batch, max_seq)
    return [{key: torch.zeros((n, *shape), **kw)
             for key, shape in shapes.items()}
            for n, _ in cfg.layer_groups()]


def _layer_caches(cfg: TransformerConfig, caches: list) -> list[dict]:
    """Each layer's view of the dense cache, in execution order."""
    return [{key: c[j] for key, c in cache.items()}
            for (n, _), cache in zip(cfg.layer_groups(), caches)
            for j in range(n)]


def _prefill_trunk(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor, store) -> torch.Tensor:
    """Run the prompt, hand each layer's cache entries (``{"k", "v"}``
    (B, S, KVH, Dh) or ``{"c_kv", "k_rope"}`` (B, S, ·)) to
    ``store(layer, entries)``, and return the last position's logits."""
    positions = _positions(tokens)
    acfg, attn = cfg.attn_config(), _forward_attn(cfg)
    x = _embed(params, cfg, tokens, positions, (0, tokens.shape[1] - 1))
    for i, (lp, use_moe) in enumerate(zip(params["layers"],
                                          cfg.layer_uses_moe())):
        h, kv = attn(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x),
                     positions, causal=cfg.causal, q_chunk=cfg.q_chunk,
                     return_cache=True)
        store(i, kv)
        x, _ = _ffn_block(cfg, use_moe, lp, x + h)
    h = rmsnorm(params["final_norm"], x[:, -1:])
    return _logits(params, cfg, h)[:, 0]


def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            max_seq: int) -> tuple[torch.Tensor, list]:
    """Run the full prompt; return last-position logits (B, V) and the
    filled dense cache, padded with zeros to ``max_seq``."""
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_seq, device=tokens.device)
    layers = _layer_caches(cfg, caches)

    def store(i, kv):
        for key, value in kv.items():
            layers[i][key][:, :s] = value

    return _prefill_trunk(params, cfg, tokens, store), caches


def decode_step(params: Params, cfg: TransformerConfig, caches: list,
                token: torch.Tensor, position: torch.Tensor
                ) -> tuple[torch.Tensor, list]:
    """One decode step over the dense cache.  token (B,), position (B,)
    → logits (B, V); the caches are updated in place and returned.  MoE
    layers route dropless."""
    acfg = cfg.attn_config()
    dec = mla_decode if cfg.attn_type == "mla" else gqa_decode
    x = _embed(params, cfg, token[:, None], position[:, None])
    for lp, lc, use_moe in zip(params["layers"], _layer_caches(cfg, caches),
                               cfg.layer_uses_moe()):
        h, _ = dec(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x), lc,
                   position)
        x, _ = _ffn_block(cfg, use_moe, lp, x + h, dropless=True)
    h = rmsnorm(params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0], caches


# -- serving over the page pool ------------------------------------------
def init_paged_cache(cfg: TransformerConfig, n_pages: int, page_size: int,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The two page pools over all layers in ``cfg.dtype``, zeros: K and
    V, (L, NP, KVH, PS, Dh) each (GQA), or the latent and the rope key,
    (L, NP, PS, kv_rank) and (L, NP, PS, rope_dim) (MLA)."""
    kw = dict(dtype=cfg.dtype, device=resolve_device(device))
    if cfg.attn_type == "mla":
        return (torch.zeros((cfg.n_layers, n_pages, page_size,
                             cfg.kv_lora_rank), **kw),
                torch.zeros((cfg.n_layers, n_pages, page_size,
                             cfg.qk_rope_dim), **kw))
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.d_head)
    return torch.zeros(shape, **kw), torch.zeros(shape, **kw)


def prefill_paged(params: Params, cfg: TransformerConfig,
                  tokens: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, pages: torch.Tensor
                  ) -> torch.Tensor:
    """Prefill one prompt (1, S) and write its cache rows into ``pages``
    (the pager's table for it, ceil(S / PS) page ids) of every layer's
    pools (``init_paged_cache``'s pair), in place: token t goes to page
    ``pages[t // PS]``, slot ``t % PS``.  Returns the last position's
    logits (1, V)."""
    s = tokens.shape[1]
    ps = k_pool.shape[-2]
    t = torch.arange(s, device=tokens.device)
    page, slot = pages.long()[t // ps], t % ps

    def store(i, kv):
        if cfg.attn_type == "mla":
            k_pool[i, page, slot] = kv["c_kv"][0]
            v_pool[i, page, slot] = kv["k_rope"][0]
        else:
            k_pool[i, page, :, slot] = kv["k"][0]
            v_pool[i, page, :, slot] = kv["v"][0]

    return _prefill_trunk(params, cfg, tokens, store)


def decode_paged(params: Params, cfg: TransformerConfig,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 token: torch.Tensor, position: torch.Tensor,
                 block_table: torch.Tensor, seq_lens: torch.Tensor
                 ) -> torch.Tensor:
    """One batched decode step over the page pools: token (B,), position
    (B,), block_table (B, PMAX), seq_lens (B,) = position + 1 →
    logits (B, V).  Each layer writes the new cache row into its pools
    in place; GQA then launches B8 once over all B sequences, MLA runs
    its absorbed decode over the gathered latent pages.  MoE layers
    route dropless.  With learned positions, ``position`` is read back
    once to check it (``check_positions``)."""
    acfg = cfg.attn_config()
    dec = mla_decode_paged if cfg.attn_type == "mla" else gqa_decode_paged
    x = _embed(params, cfg, token[:, None], position[:, None])
    for i, (lp, use_moe) in enumerate(zip(params["layers"],
                                          cfg.layer_uses_moe())):
        h = dec(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x), k_pool[i],
                v_pool[i], position, block_table, seq_lens)
        x, _ = _ffn_block(cfg, use_moe, lp, x + h, dropless=True)
    h = rmsnorm(params["final_norm"], x)
    return _logits(params, cfg, h)[:, 0]
