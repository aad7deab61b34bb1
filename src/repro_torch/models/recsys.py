"""RecSys models: the EmbeddingBag, DLRM (RM-2), DeepFM, two-tower
retrieval and BERT4Rec, and their training losses.

The embedding lookup is the hot path, and it is the paper's algorithm on
the (row, dim) table datacube: the ids plan the rows, and only those
bytes are read.  ``EmbeddingBag`` sums each bag of ids with kernel B6
(``gather_rows_bag``, routed by ``kernels.gather.ops``): one launch per
call over all tables, viewed as one (T·R, D) table.  On CPU tensors it
runs B6's plain version, which sums the slots in the same order as the
kernel.  Two-tower's user and item lookups are kernel B1
(``gather_rows``, through ``kernels.gather.ops``), whose ids are checked
on the host once a call: an id outside [0, N) raises ``IndexError``
(ROADMAP C12), where the JAX package's ``jnp.take`` would return a NaN
row for N and the last row for -1.  BERT4Rec is the decoder of
``models.transformer`` run without the causal mask, with learned
positions; its embedding lookup is ``layers.embed``, as the LMs' is.

On a mesh (DLRM, DeepFM and two-tower on ``DTensor`` parameters and
batches under ``recsys_rules``: tables sharded on their rows over
"model", MLPs replicated, the batch over the data axes) the lookups
stay on each rank's own rows (``kernels.gather.ops.sharded_rows``): the
ids of other ranks' rows are -1, which B6 drops and B1 reads as a zero
row, and the ranks' partial results are summed over "model".  No rank
holds or gathers another's rows.  The range check then spans every rank
(one host read), and the in-batch softmax of two-tower runs on each
rank's own rows (``layers.cross_entropy``).

Every parameter is trainable.  The gradients of B6 and B1 are plain
PyTorch (the backward ops of ``ops``' custom ops): ``grad_out`` added
into a dense zero table at the ids, as XLA takes the gradient of
``jnp.take`` in the JAX package, so an optimizer moves every row of a
table every step.
``dlrm_loss`` and ``deepfm_loss`` are the stable binary cross-entropy
of the logits, ``twotower_loss`` the in-batch softmax with the logQ
correction, ``bert4rec_loss`` the cloze objective through the chunked
tied cross-entropy (``layers.cross_entropy_tied_chunked``).  Serving
runs under ``torch.no_grad()``.

Parameters keep the JAX package's layouts (stacked ``(T, R, D)``
tables, ``w (d_in, d_out)`` dense weights), so ``repro_torch.carry``
loads a JAX parameter tree into these modules unchanged.  Matrix
products are ``torch.matmul``/``torch.bmm`` at whatever float32 matmul
precision the process has set (TF32 off by default): the models inherit
those settings and never set them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from .._device import resolve_device, seeded_generator
from ..distributed import sharding as shd
from ..kernels._casting import ensure_i32_addressable
from ..kernels._mesh import id_spans
from ..kernels.gather import ops as gather_ops
from . import transformer as tf
from .layers import (MLP, cross_entropy, cross_entropy_tied_chunked,
                     embedding_init)


class EmbeddingBag(nn.Module):
    """``n_tables`` stacked tables ``(T, rows, dim)``; ``bags (B, T, L)``
    with -1 padding → ``(B, T, dim)``."""

    def __init__(self, n_tables: int, rows: int, dim: int, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # Flat ids t·R + id are int32.
        ensure_i32_addressable(n_tables * rows, what="EmbeddingBag tables")
        tables = torch.empty((n_tables, rows, dim), dtype=dtype,
                             device=device)
        # One table at a time, in place: no second copy of the tables.
        scale = 1.0 / math.sqrt(dim)
        for t in range(n_tables):
            tables[t].normal_(0.0, scale, generator=generator)
        self.tables = nn.Parameter(tables)

    def forward(self, bags: torch.Tensor,
                combine: str = "sum") -> torch.Tensor:
        if combine not in ("sum", "mean"):
            raise ValueError(f"combine must be 'sum' or 'mean', got "
                             f"{combine!r}")
        n_tables, rows, dim = self.tables.shape
        if bags.dim() != 3 or bags.shape[1] != n_tables:
            raise ValueError(f"bags: shape {tuple(bags.shape)}, expected "
                             f"(B, {n_tables}, L)")
        # Each table's ids must lie in [-1, rows): past ``rows`` an id
        # would read the next table's row of the flattened view.  This is
        # the call's one range check (one read back from the card; on a
        # mesh, over every rank at once); it bounds every flat id below
        # T·R, so B6 is called past ``ops``.  Fake bags (the dry run's
        # trace) have no span.
        span, = id_spans(bags) if bags.numel() else (None,)
        if span is not None:
            lo, hi = span
            if lo < -1 or hi >= rows:
                raise IndexError(
                    f"EmbeddingBag: ids span [{lo}, {hi}], outside "
                    f"[-1, {rows}) of each table")
        if shd.is_dtensor(self.tables):
            # On a mesh: each rank sums its own rows of every table (the
            # ids of other ranks' rows as -1), and the ranks' sums add.
            out = gather_ops.sharded_rows(self.tables, bags, 1, _bag_sums)
        else:
            out = _bag_sums(self.tables, bags)
        if combine == "mean":
            count = (bags >= 0).sum(dim=2).clamp(min=1)
            out = out / count[..., None]
        return out


def _bag_sums(tables: torch.Tensor, bags: torch.Tensor) -> torch.Tensor:
    """One B6 launch over stacked (T, R, D) tables viewed as one (T·R, D)
    table: ``bags`` (B, T, L) in [-1, R) become flat ids t·R + id."""
    n_tables, rows, dim = tables.shape
    b, _, n_slots = bags.shape
    base = torch.arange(n_tables, device=bags.device,
                        dtype=torch.int32)[None, :, None] * rows
    # The caller's range check bounds every id below ``rows`` and the
    # constructor's ensure_i32_addressable bounds T·R below 2³¹.
    flat = torch.where(bags >= 0, bags.int() + base, -1)  # lint-ok: unchecked-i32-cast
    return gather_ops.gather_rows_bag_checked(
        tables.view(n_tables * rows, dim),
        flat.view(b * n_tables, n_slots)).view(b, n_tables, dim)


# ---------------------------------------------------------------------------
# DLRM (RM-2)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    rows: int = 1_000_000
    embed_dim: int = 64
    bot_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    bag_size: int = 1
    dtype: torch.dtype = torch.float32


class DLRM(nn.Module):
    """Bottom MLP over the dense features, one bag per sparse feature,
    the pairwise dot interaction, top MLP → logits."""

    def __init__(self, cfg: DLRMConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        kw = dict(generator=gen, device=dev, dtype=cfg.dtype)
        self.cfg = cfg
        self.bags = EmbeddingBag(cfg.n_sparse, cfg.rows, cfg.embed_dim, **kw)
        self.bot = MLP([cfg.n_dense, *cfg.bot_mlp], **kw)
        n_pairs = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        self.top = MLP([cfg.embed_dim + n_pairs, *cfg.top_mlp], **kw)
        for name, buf in self.buffers_for(cfg, dev).items():
            self.register_buffer(name, buf, persistent=False)

    @staticmethod
    def buffers_for(cfg: DLRMConfig, device) -> dict:
        """The interaction's pairs (i < j) in row-major order, as
        ``jnp.triu_indices(T + 1, k=1)``: ``pair_i`` and ``pair_j``."""
        iu, ju = torch.triu_indices(cfg.n_sparse + 1, cfg.n_sparse + 1, 1,
                                    device=device)
        return {"pair_i": iu, "pair_j": ju}

    def forward(self, dense: torch.Tensor,
                bags: torch.Tensor) -> torch.Tensor:
        """dense (B, n_dense), bags (B, n_sparse, L) → logits (B,)."""
        d = self.bot(dense.to(self.cfg.dtype))                 # (B, D)
        e = self.bags(bags)                                    # (B, T, D)
        z = torch.cat([d[:, None, :], e], dim=1)               # (B, T+1, D)
        inter = torch.bmm(z, z.transpose(1, 2))                # (B, T+1, T+1)
        # Each row's own pairs (on a mesh, on the rank holding the row).
        pi, pj = shd.whole(self.pair_i), shd.whole(self.pair_j)
        flat = shd.rowwise(lambda t: t[:, pi, pj], inter)      # (B, pairs)
        x = torch.cat([d, flat], dim=1)
        return self.top(x)[:, 0]


def dlrm_loss(model: DLRM, batch: dict) -> torch.Tensor:
    """Binary cross-entropy of ``batch``'s labels under the logits of its
    dense features and bags."""
    return _bce(model(batch["dense"], batch["bags"]), batch["labels"])


# ---------------------------------------------------------------------------
# DeepFM
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DeepFMConfig:
    name: str = "deepfm"
    n_sparse: int = 39
    rows: int = 1_000_000
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    dtype: torch.dtype = torch.float32


class DeepFM(nn.Module):
    """First-order (a D = 1 bag per field), FM second-order and deep
    terms over the field embeddings, plus a scalar bias → logits."""

    def __init__(self, cfg: DeepFMConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        kw = dict(generator=gen, device=dev, dtype=cfg.dtype)
        self.cfg = cfg
        self.bags = EmbeddingBag(cfg.n_sparse, cfg.rows, cfg.embed_dim, **kw)
        self.linear = EmbeddingBag(cfg.n_sparse, cfg.rows, 1, **kw)
        self.deep = MLP([cfg.n_sparse * cfg.embed_dim, *cfg.mlp_dims, 1],
                        **kw)
        self.bias = nn.Parameter(torch.zeros((), dtype=cfg.dtype,
                                             device=dev))

    def forward(self, bags: torch.Tensor) -> torch.Tensor:
        """bags (B, n_sparse, L) → logits (B,)."""
        v = self.bags(bags)                                    # (B, F, D)
        lin = self.linear(bags)[..., 0]                        # (B, F)
        # FM second order: ½[(Σv)² − Σv²]
        s = v.sum(dim=1)
        fm = 0.5 * (s.square() - v.square().sum(dim=1)).sum(dim=-1)
        deep = self.deep(v.reshape(v.shape[0], -1))[:, 0]
        return self.bias + lin.sum(dim=1) + fm + deep


def deepfm_loss(model: DeepFM, batch: dict) -> torch.Tensor:
    """Binary cross-entropy of ``batch``'s labels under its bags' logits."""
    return _bce(model(batch["bags"]), batch["labels"])


# ---------------------------------------------------------------------------
# Two-tower retrieval
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_users: int = 1_000_000
    n_items: int = 1_000_000
    embed_dim: int = 256
    tower: tuple[int, ...] = (1024, 512, 256)
    temperature: float = 0.05
    dtype: torch.dtype = torch.float32


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


class TwoTower(nn.Module):
    """User and item embedding tables (N, embed_dim), each looked up by
    B1 and fed through its tower (``MLP`` with biases), L2-normalised;
    a query scores its candidates by the dot product."""

    def __init__(self, cfg: TwoTowerConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        kw = dict(generator=gen, device=dev, dtype=cfg.dtype)
        self.cfg = cfg
        self.user_embed = nn.Parameter(embedding_init(
            cfg.n_users, cfg.embed_dim, **kw)["table"])
        self.item_embed = nn.Parameter(embedding_init(
            cfg.n_items, cfg.embed_dim, **kw)["table"])
        self.user_tower = MLP([cfg.embed_dim, *cfg.tower], **kw)
        self.item_tower = MLP([cfg.embed_dim, *cfg.tower], **kw)

    def user(self, user_ids) -> torch.Tensor:
        """user ids (B,), numpy or a tensor → (B, tower[-1])."""
        u = gather_ops.gather_rows(self.user_embed, user_ids)
        return _l2n(self.user_tower(u.to(self.cfg.dtype)))

    def item(self, item_ids) -> torch.Tensor:
        """item ids (N,), numpy or a tensor → (N, tower[-1])."""
        i = gather_ops.gather_rows(self.item_embed, item_ids)
        return _l2n(self.item_tower(i.to(self.cfg.dtype)))

    def score_candidates(self, user_ids, cand_item_ids) -> torch.Tensor:
        """(B,) users × (N,) candidates → scores (B, N): the
        ``retrieval_cand`` shape is one user and 2²⁰ candidates."""
        return self.user(user_ids) @ self.item(cand_item_ids).T


def twotower_loss(model: TwoTower, batch: dict) -> torch.Tensor:
    """In-batch sampled softmax with the logQ correction [Yi et al. '19]:
    row b's positive is item b among the batch's items, the (B, B)
    logits divided by the temperature, minus ``item_logq`` where the
    batch has it."""
    u = model.user(batch["user_ids"])                      # (B, D)
    i = model.item(batch["item_ids"])                      # (B, D)
    logits = (u @ i.T) / model.cfg.temperature             # (B, B)
    logq = batch.get("item_logq")
    if logq is not None:
        logits = logits - logq[None, :]
    return cross_entropy(logits, shd.row_ids(u),
                         label_span=(0, u.shape[0] - 1))


# ---------------------------------------------------------------------------
# BERT4Rec — bidirectional transformer over item sequences
# ---------------------------------------------------------------------------
def bert4rec_config(n_items: int = 50_000, seq_len: int = 200,
                    dtype: torch.dtype = torch.float32
                    ) -> tf.TransformerConfig:
    return tf.TransformerConfig(
        name="bert4rec", vocab=n_items + 2,     # +mask, +pad tokens
        d_model=64, n_layers=2, n_heads=2, n_kv_heads=2, d_head=32,
        d_ff=256, causal=False, learned_pos=True, max_seq=seq_len,
        dtype=dtype, q_chunk=None)


def bert4rec_init(cfg: tf.TransformerConfig, device=None, seed: int = 0
                  ) -> tf.Params:
    return tf.init_params(cfg, device=device, seed=seed)


MAX_MASKED = 48   # cloze positions kept per sequence (0.2 × 200 + slack)


def bert4rec_loss(params: tf.Params, cfg: tf.TransformerConfig,
                  batch: dict) -> torch.Tensor:
    """Masked-item prediction (cloze) over the item vocabulary, as the
    JAX package's ``bert4rec_loss``: the trunk's hidden states once, the
    top ``MAX_MASKED`` masked positions of each row (a stable sort of
    ``-mask``, ties by position), and the chunked tied cross-entropy
    over them (chunks of 4096 items), weighted by the mask; the
    (B, S, V) logits are never formed.  On a mesh the picks run on each
    rank's own rows and the cross-entropy on its own vocabulary rows."""
    h, _ = tf.trunk(params, cfg, batch["items"])          # (B, S, D)
    mask = batch["mask"]
    order = shd.rowwise(lambda m: torch.argsort(
        -m, dim=1, stable=True)[:, :MAX_MASKED], mask)
    h_m = shd.rowwise(lambda x, o: torch.take_along_dim(
        x, o[..., None], dim=1), h, order)
    lab_m, w_m = (shd.rowwise(lambda x, o: torch.take_along_dim(
        x, o, dim=1), t, order) for t in (batch["labels"], mask))
    return cross_entropy_tied_chunked(h_m, params["embed"]["table"], lab_m,
                                      w_m, chunk=4096)


def bert4rec_score(params: tf.Params, cfg: tf.TransformerConfig,
                   items: torch.Tensor) -> torch.Tensor:
    """Next-item scores at the last position: items (B, S) → (B, V).
    Only the final position is unembedded, (B, V) and not (B, S, V).
    An item id outside [0, V) raises ``IndexError`` (the trunk's one
    read back from the card, over every rank on a mesh), as a position
    outside the table does (ROADMAP C12).  On a mesh the scores are
    sharded on V."""
    h, _ = tf.trunk(params, cfg, items)
    return tf.head_logits(params, cfg, h[:, -1])


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits in float32, the stable form
    ``max(x, 0) - x·y + log1p(exp(-|x|))``."""
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
