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

On a mesh (the parameters, batches and caches ``DTensor`` tensors under
their cells' specs, ``configs.common.lm_arch``) the same functions run
sharded.  The JAX package's ``constrain(x, DP, None, None)`` pins the
batch to the data axes at its three places (a layer's input, the trunk's
and the prefill's embeddings), and the head's input before the logits.
The token and position lookups are B1 on each rank's vocabulary rows
(``layers.embed``), the ids checked once a forward; FSDP-sharded weights
are gathered at use, layer by layer (``_at_use``); attention runs on
each rank's rows and heads, a dense decode on its own rows of a cache
sharded on S (``attention._at_cache``); MoE layers on its own experts
(``moe._moe_mesh``); the head's logits and the losses on its own
vocabulary columns (``layers.cross_entropy``).  The serving engine's
paged decode calls kernel B8 on one card's tensors through raw pointers
and is not a cell: it stays on one card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device, seeded_generator
from ..distributed import sharding as shd
from ..distributed.context import DP, constrain
from ..distributed.sharding import PartitionSpec as P
from ..kernels._mesh import checked_ids, id_spans
from .attention import (AttnConfig, gqa_decode, gqa_decode_paged,
                        gqa_forward, gqa_init, mla_decode, mla_decode_paged,
                        mla_forward, mla_init, store_prefix)
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
def _token_ids(cfg: TransformerConfig, tokens: torch.Tensor,
               span: tuple[int, int] | None = None) -> torch.Tensor:
    """``tokens`` as int32 rows of the embedding table, after the check
    that they lie in [0, vocab) (``IndexError``, as for positions in
    ROADMAP C12).  ``span`` is their (lowest, highest) where the caller
    has read it; else it is read here (one read back from the card,
    over every rank of a mesh)."""
    return checked_ids(tokens, what=f"{cfg.name}: token/item ids",
                       n_rows=cfg.vocab, span=span)


def _embed(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
           positions: torch.Tensor, span: tuple[int, int] | None = None,
           token_span: tuple[int, int] | None = None):
    """The token embeddings (B1: ``layers.embed``), plus the learned
    position embeddings where the configuration has them.  The ids, and
    the positions against the learned position table (ROADMAP C12), are
    checked before either table is read: against the spans given
    (``span`` the positions', ``token_span`` the tokens'), or else read
    here, both in one read: one check a forward, never one a layer."""
    if cfg.learned_pos and span is None and token_span is None:
        token_span, span = id_spans(tokens, positions)
    ids = _token_ids(cfg, tokens, token_span)
    if cfg.learned_pos:
        pos = checked_ids(positions, what=f"{cfg.name}: positions of its "
                          f"learned position table", n_rows=cfg.max_seq,
                          span=span)
    x = embed(params["embed"], ids).to(cfg.dtype)
    if cfg.learned_pos:
        x = x + embed(params["pos_embed"], pos).to(cfg.dtype)
    return x


def _at_use(tree):
    """A layer's parameters as it uses them: each FSDP-sharded weight
    gathered over the data axes (``sharding.at_use``), layer by layer."""
    if isinstance(tree, dict):
        return {k: _at_use(v) for k, v in tree.items()}
    return shd.at_use(tree)


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


def head_logits(params: Params, cfg: TransformerConfig, h: torch.Tensor):
    """The head's logits of ``h`` (B, ..., D), whose rows are first
    pinned to the batch axes and D made whole on a mesh: each rank then
    forms only its own vocabulary columns."""
    h = constrain(h, DP, *([None] * (h.ndim - 1)))
    if cfg.tied_embeddings:
        return unembed(params["embed"], h)
    return h @ shd.at_use(params["head"]["w"]).to(h.dtype)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    return shd.replicate_like(pos, tokens)


def _forward_attn(cfg: TransformerConfig):
    return mla_forward if cfg.attn_type == "mla" else gqa_forward


def _layer_apply(cfg: TransformerConfig, use_moe: bool, lp: Params,
                 x: torch.Tensor, positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: (its output, the MoE aux loss or None).  On a mesh its
    input is pinned to the batch axes and its weights gathered over the
    FSDP axes here, inside any recomputation."""
    lp = _at_use(lp)
    x = constrain(x, DP, None, None)
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
          positions: torch.Tensor | None = None,
          token_span: tuple[int, int] | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (hidden (B, S, D) after final norm, aux_loss, the
    MoE layers' summed).  ``token_span``: the tokens' (lowest, highest)
    where the caller has read it (``_embed``)."""
    span = None
    if positions is None:
        positions, span = _positions(tokens), (0, tokens.shape[1] - 1)
    x = _embed(params, cfg, tokens, positions, span, token_span)
    x = constrain(x, DP, None, None)
    aux = None
    remat = _needs_remat(cfg, params)
    for lp, use_moe in zip(params["layers"], cfg.layer_uses_moe()):
        if remat:
            x, a = checkpoint(_layer_apply, cfg, use_moe, lp, x, positions,
                              use_reentrant=False)
        else:
            x, a = _layer_apply(cfg, use_moe, lp, x, positions)
        if a is not None:
            aux = a if aux is None else aux + a
    if aux is None:
        aux = shd.replicate_like(torch.zeros((), dtype=torch.float32,
                                             device=x.device), x)
    return rmsnorm(params["final_norm"], x), aux


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            positions: torch.Tensor | None = None,
            token_span: tuple[int, int] | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V), aux_loss)."""
    h, aux = trunk(params, cfg, tokens, positions, token_span)
    return head_logits(params, cfg, h), aux


# -- training ----------------------------------------------------------------
def loss_fn(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor, mask: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """(cross-entropy of ``labels`` + the MoE aux loss + ``mtp_loss_weight``
    × the MTP loss where the configuration has it, {"ce", "aux",
    "mtp_ce"}), as the JAX package's ``loss_fn``.  The tokens and the
    labels are checked in one read back from the card, for every
    lookup and loss of the step (``_token_ids``, ``cross_entropy``)."""
    tok_span, lab_span = id_spans(tokens, labels)
    logits, aux = forward(params, cfg, tokens, token_span=tok_span)
    ce = cross_entropy(logits, labels, mask, label_span=lab_span)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        mtp_ce = _mtp_loss(params, cfg, tokens, labels, tok_span,
                           lab_span)
        loss = loss + cfg.mtp_loss_weight * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


def _mtp_loss(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
              labels: torch.Tensor,
              token_span: tuple[int, int] | None = None,
              label_span: tuple[int, int] | None = None) -> torch.Tensor:
    """DeepSeek-V3's depth-1 multi-token prediction as the JAX package
    writes it: the token's embedding and the next token's (``roll`` by
    one), each RMS-normed, concatenated and projected, one dense layer,
    the final norm and the tied unembedding, predicting the label after
    next (``roll`` of the labels); the last two positions are masked.
    The spans are ``loss_fn``'s, where it gives them: the rolled ids
    are the same ids."""
    b, s = tokens.shape
    positions = _positions(tokens)
    ids = _token_ids(cfg, tokens, token_span)
    x = embed(params["embed"], ids).to(cfg.dtype)
    nxt = shd.rowwise(_next_token, ids)
    mp = params["mtp"]
    hcat = torch.cat([
        rmsnorm(mp["norm_h"], x),
        rmsnorm(mp["norm_e"], embed(params["embed"], nxt).to(cfg.dtype)),
    ], dim=-1)
    h = hcat @ shd.at_use(mp["proj"]["w"]).to(cfg.dtype)
    h, _ = _layer_apply(cfg, False, mp["layer"], h, positions)
    h = rmsnorm(params["final_norm"], h)
    logits = unembed(params["embed"], constrain(h, DP, None, None))
    mtp_labels = shd.rowwise(_next_token, labels)
    mask = (torch.arange(s, device=tokens.device)[None, :] < s - 2).to(
        torch.float32).expand(b, s)
    return cross_entropy(logits, mtp_labels,
                         shd.replicate_like(mask, tokens), label_span)


def _next_token(t: torch.Tensor) -> torch.Tensor:
    """Each row rolled by one to the left (``torch.roll(t, -1, 1)``): run
    on each rank's own rows on a mesh (``rowwise``), since PyTorch 2.11
    has no ``DTensor`` rule for ``roll``."""
    return torch.roll(t, -1, dims=1)


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


def cache_specs(cfg: TransformerConfig, batch: int,
                axis_names: tuple) -> list:
    """The dense cache's specs on a mesh of ``axis_names``, the JAX decode
    lowering's: (L, B, S, ...) with B on the batch axes and S on
    "model" (``decode_32k``), or a batch of one with S on ("data",
    "model") (``long_500k``); one dict per layer group."""
    dpa = tuple(a for a in ("pod", "data") if a in axis_names)
    if batch == 1:
        b_ax = None
        s_ax = tuple(a for a in ("data", "model") if a in axis_names)
    else:
        b_ax, s_ax = dpa, "model"
    return [{key: P(None, b_ax, s_ax, *((None,) * (len(shape) - 2)))
             for key, shape in _cache_shapes(cfg, batch, 1).items()}
            for _ in cfg.layer_groups()]


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype: torch.dtype | None = None, device=None,
               device_mesh=None) -> list:
    """Dense decode cache, one dict per layer group stacked (L_group, B,
    S_max, ...): ``{"k", "v"}`` (GQA) or ``{"c_kv", "k_rope"}`` (MLA),
    zeros.  With ``device_mesh`` (a ``DeviceMesh``), ``DTensor`` zeros
    placed by ``cache_specs``, each rank allocating its own part."""
    dtype = dtype or cfg.dtype
    shapes = _cache_shapes(cfg, batch, max_seq)
    if device_mesh is not None:
        specs = cache_specs(cfg, batch, device_mesh.mesh_dim_names)
        return [{key: shd.placed_zeros((n, *shape), dtype, device_mesh,
                                       spec[key])
                 for key, shape in shapes.items()}
                for (n, _), spec in zip(cfg.layer_groups(), specs)]
    kw = dict(dtype=dtype, device=resolve_device(device))
    return [{key: torch.zeros((n, *shape), **kw)
             for key, shape in shapes.items()}
            for n, _ in cfg.layer_groups()]


def _layer_caches(cfg: TransformerConfig, caches: list) -> list[dict]:
    """Each layer's view of the dense cache, in execution order."""
    return [{key: c[j] for key, c in cache.items()}
            for (n, _), cache in zip(cfg.layer_groups(), caches)
            for j in range(n)]


def _prefill_trunk(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor, store,
                   token_span: tuple[int, int] | None = None
                   ) -> torch.Tensor:
    """Run the prompt, hand each layer's cache entries (``{"k", "v"}``
    (B, S, KVH, Dh) or ``{"c_kv", "k_rope"}`` (B, S, ·)) to
    ``store(layer, entries)``, and return the last position's logits.
    ``token_span`` as ``trunk``'s."""
    positions = _positions(tokens)
    acfg, attn = cfg.attn_config(), _forward_attn(cfg)
    x = _embed(params, cfg, tokens, positions, (0, tokens.shape[1] - 1),
               token_span)
    x = constrain(x, DP, None, None)
    for i, (lp, use_moe) in enumerate(zip(params["layers"],
                                          cfg.layer_uses_moe())):
        lp = _at_use(lp)
        h, kv = attn(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x),
                     positions, causal=cfg.causal, q_chunk=cfg.q_chunk,
                     return_cache=True)
        store(i, kv)
        x, _ = _ffn_block(cfg, use_moe, lp, x + h)
    h = rmsnorm(params["final_norm"], x[:, -1:])
    return head_logits(params, cfg, h)[:, 0]


def prefill(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            max_seq: int) -> tuple[torch.Tensor, list]:
    """Run the full prompt; return last-position logits (B, V) and the
    filled dense cache, padded with zeros to ``max_seq``.  On a mesh the
    cache is placed as the decode cell's (``cache_specs``) and each rank
    writes the prompt's rows it holds."""
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_seq, device=tokens.device,
                        device_mesh=getattr(tokens, "device_mesh", None))
    layers = _layer_caches(cfg, caches)

    def store(i, kv):
        for key, value in kv.items():
            store_prefix(layers[i][key], value)

    return _prefill_trunk(params, cfg, tokens, store), caches


def decode_step(params: Params, cfg: TransformerConfig, caches: list,
                token: torch.Tensor, position: torch.Tensor
                ) -> tuple[torch.Tensor, list]:
    """One decode step over the dense cache.  token (B,), position (B,)
    → logits (B, V); the caches are updated in place and returned.  MoE
    layers route dropless.  The tokens and positions are read back once
    and checked: a position outside the cache's [0, S_max) raises
    ``IndexError``, as do the tokens and learned positions that
    ``_embed`` checks."""
    acfg = cfg.attn_config()
    dec = mla_decode if cfg.attn_type == "mla" else gqa_decode
    tok_span, pos_span = id_spans(token, position)
    s_max = next(iter(caches[0].values())).shape[2]
    if pos_span is not None and (pos_span[0] < 0 or pos_span[1] >= s_max):
        raise IndexError(f"{cfg.name}: decode positions span {pos_span}, "
                         f"outside the [0, {s_max}) of its cache")
    x = _embed(params, cfg, token[:, None], position[:, None], pos_span,
               tok_span)
    for lp, lc, use_moe in zip(params["layers"], _layer_caches(cfg, caches),
                               cfg.layer_uses_moe()):
        lp = _at_use(lp)
        h, _ = dec(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x), lc,
                   position)
        x, _ = _ffn_block(cfg, use_moe, lp, x + h, dropless=True)
    h = rmsnorm(params["final_norm"], x)
    return head_logits(params, cfg, h)[:, 0], caches


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
                  v_pool: torch.Tensor, pages: torch.Tensor,
                  token_span: tuple[int, int] | None = None
                  ) -> torch.Tensor:
    """Prefill one prompt (1, S) and write its cache rows into ``pages``
    (the pager's table for it, ceil(S / PS) page ids) of every layer's
    pools (``init_paged_cache``'s pair), in place: token t goes to page
    ``pages[t // PS]``, slot ``t % PS``.  Returns the last position's
    logits (1, V).  ``token_span`` as ``trunk``'s (the engine's, from
    the prompt on the host)."""
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

    return _prefill_trunk(params, cfg, tokens, store, token_span)


def decode_paged(params: Params, cfg: TransformerConfig,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 token: torch.Tensor, position: torch.Tensor,
                 block_table: torch.Tensor, seq_lens: torch.Tensor,
                 token_span: tuple[int, int] | None = None
                 ) -> torch.Tensor:
    """One batched decode step over the page pools: token (B,), position
    (B,), block_table (B, PMAX), seq_lens (B,) = position + 1 →
    logits (B, V).  Each layer writes the new cache row into its pools
    in place; GQA then launches B8 once over all B sequences, MLA runs
    its absorbed decode over the gathered latent pages.  MoE layers
    route dropless.  The tokens are checked against ``token_span`` (the
    engine's, from its host copy of them), or else read back once, with
    the learned positions where there are any (``_embed``)."""
    acfg = cfg.attn_config()
    dec = mla_decode_paged if cfg.attn_type == "mla" else gqa_decode_paged
    x = _embed(params, cfg, token[:, None], position[:, None], None,
               token_span)
    for i, (lp, use_moe) in enumerate(zip(params["layers"],
                                          cfg.layer_uses_moe())):
        h = dec(lp["attn"], acfg, rmsnorm(lp["attn_norm"], x), k_pool[i],
                v_pool[i], position, block_table, seq_lens)
        x, _ = _ffn_block(cfg, use_moe, lp, x + h, dropless=True)
    h = rmsnorm(params["final_norm"], x)
    return head_logits(params, cfg, h)[:, 0]
