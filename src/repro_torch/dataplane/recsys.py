"""RecSys data plane: synthetic click logs with a learnable CTR model.

Sparse ids are Zipf-distributed (like real categorical traffic); labels
come from a hidden low-rank logistic model so the recsys architectures
actually converge in the examples/tests.  Lookup traffic then flows
through the EmbeddingBag extraction path (the paper's categorical-axis
plan-then-gather).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ClickStream:
    n_sparse: int = 26
    n_dense: int = 13
    rows: int = 1_000_000
    bag_size: int = 1
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._field_w = rng.normal(0, 1.0, (self.n_sparse, 8))
        self._row_emb_seed = rng.integers(2 ** 31)
        self._dense_w = rng.normal(0, 0.5, self.n_dense)

    def _row_latent(self, field: int, ids: np.ndarray) -> np.ndarray:
        # hash-based pseudo-embedding of each sparse id (deterministic)
        h = (ids.astype(np.int64) * 2654435761 + field * 97) % 104729
        return np.stack([np.sin(h * (k + 1) * 1e-3) for k in range(8)],
                        axis=-1)

    def batch(self, step: int, batch_size: int, shard: int = 0,
              n_shards: int = 1) -> dict:
        rng = np.random.default_rng(step * 104_729 + shard + self.seed)
        rows = batch_size // n_shards
        # Zipf ids clipped to vocab
        bags = np.minimum(rng.zipf(1.3, (rows, self.n_sparse,
                                         self.bag_size)) - 1,
                          self.rows - 1).astype(np.int32)
        dense = rng.normal(0, 1, (rows, self.n_dense)).astype(np.float32)
        logit = dense @ self._dense_w
        for f in range(self.n_sparse):
            lat = self._row_latent(f, bags[:, f, 0])
            logit = logit + lat @ self._field_w[f] / self.n_sparse
        p = 1 / (1 + np.exp(-logit))
        labels = (rng.random(rows) < p).astype(np.float32)
        return {"dense": dense, "bags": bags, "labels": labels}


@dataclass
class InteractionStream:
    """User→item interactions for retrieval / sequence models."""

    n_users: int = 1_000_000
    n_items: int = 1_000_000
    n_clusters: int = 64
    seed: int = 0

    def pairs(self, step: int, batch_size: int) -> dict:
        """Positive (user, item) pairs with cluster structure + logQ."""
        rng = np.random.default_rng(step * 7 + self.seed)
        users = rng.integers(0, self.n_users, batch_size)
        cluster = users % self.n_clusters
        items = (cluster * (self.n_items // self.n_clusters)
                 + rng.integers(0, self.n_items // self.n_clusters,
                                batch_size))
        # Zipf sampling prob estimate for logQ correction
        logq = -np.log1p(items.astype(np.float64))
        return {"user_ids": users.astype(np.int32),
                "item_ids": items.astype(np.int32),
                "item_logq": logq.astype(np.float32)}

    def sequences(self, step: int, batch_size: int, seq_len: int,
                  mask_prob: float = 0.2,
                  mask_token: int | None = None) -> dict:
        """Cloze-masked item sequences for BERT4Rec (Markov browsing)."""
        rng = np.random.default_rng(step * 13 + self.seed)
        mask_token = mask_token if mask_token is not None else \
            self.n_items
        items = np.empty((batch_size, seq_len), np.int64)
        items[:, 0] = rng.integers(0, self.n_items, batch_size)
        for t in range(1, seq_len):
            stay = rng.random(batch_size) < 0.8
            items[:, t] = np.where(
                stay, (items[:, t - 1] * 31 + 7) % self.n_items,
                rng.integers(0, self.n_items, batch_size))
        labels = items.copy()
        mask = rng.random((batch_size, seq_len)) < mask_prob
        inputs = np.where(mask, mask_token, items)
        return {"items": inputs.astype(np.int32),
                "labels": labels.astype(np.int32),
                "mask": mask.astype(np.float32)}
