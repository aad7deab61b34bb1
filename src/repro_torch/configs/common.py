"""Shapes the models are served at: the LM sequence and batch sizes,
the recsys batch sizes per traffic kind and NequIP's graph shapes, as in
the JAX package's configuration."""

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

LM_ACCUM = 8   # gradient-accumulation microbatches of the train shape

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    # 10⁶ candidates padded to 2²⁰ so the candidate axis shards evenly
    "retrieval_cand": dict(batch=1, n_cand=1_048_576, kind="retrieval"),
}

# Graph shapes NequIP is served at.  Extents are padded up to multiples
# of 512, as the JAX package pads them for its device count; the
# samplers pad with masked nodes and edges.  Real sizes in comments.
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=3072, n_edges=10752, d_feat=1433,
                          n_out=7, readout="node_class"),
    # real: 2708 nodes / 10556 edges (Cora)
    "minibatch_lg": dict(n_nodes=169_984, n_edges=168_960, d_feat=602,
                         n_out=41, readout="node_class", sampled=True),
    # sampled subgraph of Reddit (232 965 / 114 615 892): 1024 seeds,
    # fanout 15-10 → 1024+15 360+153 600 nodes, 168 960 edges (exact)
    "ogb_products": dict(n_nodes=2_449_408, n_edges=61_859_840,
                         d_feat=100, n_out=47, readout="node_class"),
    # real: 2 449 029 nodes / 61 859 140 edges
    "molecule": dict(n_nodes=4096, n_edges=8192, d_feat=16,
                     n_out=1, readout="energy", n_graphs=128,
                     forces=True),
    # real: 128 graphs × 30 nodes / 64 edges = 3840 / 8192
}
