"""Graph data plane: CSR graphs, neighbour sampling, molecule batches.

The neighbour sampler is the Polytope view of graph access: a node's
neighbourhood is a contiguous CSR row range (an ordered-axis run), and a
fanout sample reads exactly the sampled entries — never full adjacency
rows of untouched nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray       # (N+1,)
    indices: np.ndarray      # (E,)
    node_feat: np.ndarray    # (N, F)
    labels: np.ndarray       # (N,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)


def synthetic_graph(n_nodes: int, avg_degree: int, d_feat: int,
                    n_classes: int, seed: int = 0) -> CSRGraph:
    """Power-law-ish graph whose labels correlate with features —
    a GNN can actually learn on it."""
    rng = np.random.default_rng(seed)
    # heavy-tailed out-degrees
    deg = np.minimum(rng.zipf(1.7, n_nodes) + avg_degree // 2,
                     n_nodes - 1)
    scale = n_nodes * avg_degree / deg.sum()
    deg = np.maximum(1, (deg * scale).astype(np.int64))
    indptr = np.concatenate([[0], np.cumsum(deg)])
    centers = rng.normal(0, 1, (n_classes, d_feat))
    labels = rng.integers(0, n_classes, n_nodes)
    feat = centers[labels] + rng.normal(0, 1.0, (n_nodes, d_feat))
    # homophilous edges: mostly within-class
    indices = np.empty(indptr[-1], np.int64)
    class_nodes = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for v in range(n_nodes):
        k = deg[v]
        same = class_nodes[labels[v]]
        n_same = max(1, int(0.7 * k))
        pick_same = same[rng.integers(0, len(same), n_same)]
        pick_rand = rng.integers(0, n_nodes, k - n_same)
        indices[indptr[v]:indptr[v + 1]] = np.concatenate(
            [pick_same, pick_rand])
    return CSRGraph(indptr.astype(np.int64), indices,
                    feat.astype(np.float32), labels.astype(np.int64))


def full_graph_batch(g: CSRGraph, pad_nodes: int, pad_edges: int,
                     train_frac: float = 0.6, seed: int = 0) -> dict:
    """Full-batch training tensors, padded to static shapes."""
    rng = np.random.default_rng(seed)
    n, e = g.n_nodes, g.n_edges
    src = np.repeat(np.arange(n), np.diff(g.indptr))
    dst = g.indices
    ei = np.full((2, pad_edges), -1, np.int32)
    ei[0, :e] = src[:pad_edges] if e > pad_edges else src
    ei[1, :e] = dst[:pad_edges] if e > pad_edges else dst
    feat = np.zeros((pad_nodes, g.node_feat.shape[1]), np.float32)
    feat[:n] = g.node_feat
    labels = np.zeros(pad_nodes, np.int64)
    labels[:n] = g.labels
    mask = np.zeros(pad_nodes, np.float32)
    train = rng.random(n) < train_frac
    mask[:n] = train
    pos = rng.normal(0, 1.5, (pad_nodes, 3)).astype(np.float32)
    return {"node_feat": feat, "positions": pos,
            "edge_index": ei, "labels": labels.astype(np.int32),
            "label_mask": mask}


def sample_neighbors(g: CSRGraph, seeds: np.ndarray,
                     fanouts: list[int], rng: np.random.Generator
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Layer-wise uniform neighbour sampling (GraphSAGE style).

    Returns (nodes, edge_index) where edge_index references positions in
    ``nodes``.  Each hop reads only the sampled CSR entries — the
    extraction plan over the adjacency datacube."""
    nodes = list(seeds)
    node_pos = {int(v): i for i, v in enumerate(seeds)}
    edges_src, edges_dst = [], []
    frontier = seeds
    for fanout in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi == lo:
                continue
            take = rng.integers(lo, hi, min(fanout, hi - lo))
            for t in take:
                u = int(g.indices[t])
                if u not in node_pos:
                    node_pos[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                edges_src.append(node_pos[u])
                edges_dst.append(node_pos[int(v)])
        frontier = np.asarray(nxt, np.int64) if nxt else \
            np.empty(0, np.int64)
    ei = np.stack([np.asarray(edges_src, np.int64),
                   np.asarray(edges_dst, np.int64)])
    return np.asarray(nodes, np.int64), ei


def minibatch(g: CSRGraph, batch_nodes: int, fanouts: list[int],
              pad_nodes: int, pad_edges: int, step: int = 0) -> dict:
    rng = np.random.default_rng(step)
    seeds = rng.choice(g.n_nodes, batch_nodes, replace=False)
    nodes, ei = sample_neighbors(g, seeds, fanouts, rng)
    nodes = nodes[:pad_nodes]
    keep = (ei[0] < pad_nodes) & (ei[1] < pad_nodes)
    ei = ei[:, keep][:, :pad_edges]
    feat = np.zeros((pad_nodes, g.node_feat.shape[1]), np.float32)
    feat[:len(nodes)] = g.node_feat[nodes]
    labels = np.zeros(pad_nodes, np.int32)
    labels[:len(nodes)] = g.labels[nodes]
    mask = np.zeros(pad_nodes, np.float32)
    mask[:min(batch_nodes, pad_nodes)] = 1.0      # loss on seeds only
    ei_pad = np.full((2, pad_edges), -1, np.int32)
    ei_pad[:, :ei.shape[1]] = ei
    pos = np.random.default_rng(step + 1).normal(
        0, 1.5, (pad_nodes, 3)).astype(np.float32)
    return {"node_feat": feat, "positions": pos, "edge_index": ei_pad,
            "labels": labels, "label_mask": mask}


def molecule_batch(n_graphs: int, nodes_per: int = 30,
                   edges_per: int = 64, n_species: int = 16,
                   pad_nodes: int | None = None,
                   pad_edges: int | None = None, step: int = 0) -> dict:
    """Batched small molecules with a synthetic (smooth, E(3)-invariant)
    energy: sum of pairwise Morse-like terms — learnable target."""
    rng = np.random.default_rng(step)
    n_tot = n_graphs * nodes_per
    pad_nodes = pad_nodes or n_tot
    pad_edges = pad_edges or n_graphs * edges_per
    pos = rng.uniform(0, 4.0, (n_tot, 3)).astype(np.float32)
    species = rng.integers(0, n_species, n_tot)
    feat = np.eye(n_species, dtype=np.float32)[species]
    gid = np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32)

    src = np.concatenate([
        g * nodes_per + rng.integers(0, nodes_per, edges_per)
        for g in range(n_graphs)])
    dst = np.concatenate([
        g * nodes_per + rng.integers(0, nodes_per, edges_per)
        for g in range(n_graphs)])
    energy = np.zeros(n_graphs, np.float32)
    for g in range(n_graphs):
        sel = slice(g * nodes_per, (g + 1) * nodes_per)
        d = np.linalg.norm(pos[sel][:, None] - pos[sel][None], axis=-1)
        iu = np.triu_indices(nodes_per, 1)
        r = d[iu]
        energy[g] = np.sum(np.exp(-2 * (r - 1.5) ** 2) -
                           0.5 * np.exp(-(r - 2.5) ** 2))

    ei = np.full((2, pad_edges), -1, np.int32)
    ei[0, :len(src)] = src
    ei[1, :len(dst)] = dst
    node_feat = np.zeros((pad_nodes, n_species), np.float32)
    node_feat[:n_tot] = feat
    positions = np.zeros((pad_nodes, 3), np.float32)
    positions[:n_tot] = pos
    gids = np.zeros(pad_nodes, np.int32)
    gids[:n_tot] = gid
    return {"node_feat": node_feat, "positions": positions,
            "edge_index": ei, "graph_ids": gids, "energy": energy,
            "forces": None, "n_graphs": n_graphs}
