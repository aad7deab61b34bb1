"""Shapes the recsys models are served and trained at (batch sizes per
traffic kind), as in the JAX package's configuration."""

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    # 10⁶ candidates padded to 2²⁰ so the candidate axis shards evenly
    "retrieval_cand": dict(batch=1, n_cand=1_048_576, kind="retrieval"),
}
