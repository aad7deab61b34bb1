"""LM token pipeline over a document datacube.

The corpus is a 2-D datacube (document × position); a training batch is
a Polytope extraction: a box request over one document × a position
window per row, planned by the slicer and read by the exact-byte path.
All rows of a batch are submitted as one
:class:`~repro_torch.serve.extraction.ExtractionService` batch, so
duplicate windows plan once and recurring windows across steps hit the
plan cache.  On the card (``device=None``, the default) the corpus lies
there as one int32 tensor and a batch's read, the union of its windows
and each row's slice of it, is one ``gather_union_slices`` launch;
``device="cpu"`` keeps the corpus in numpy and serves it through the
plain path.

Tokens are synthetic but learnable: a fixed-seed Markov chain (a random
permutation of the vocabulary, with 10% random tokens), drawn as the
JAX package's ``dataplane.tokens.TokenCube`` draws it, so both give the
same batches byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..core import Box, OrderedAxis, Request, TensorDatacube
from ..serve.extraction import ExtractionService


@dataclass
class TokenCube:
    vocab: int = 256
    n_docs: int = 1024
    doc_len: int = 2048
    seed: int = 0
    device: object = None
    _flat: object = field(default=None, init=False, repr=False)
    _payload: object = field(default=None, init=False, repr=False)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._next = rng.permutation(self.vocab)
        self._device = resolve_device(self.device)
        doc_axis = OrderedAxis("doc", np.arange(self.n_docs, dtype=float))
        pos_axis = OrderedAxis("pos", np.arange(self.doc_len, dtype=float))
        self.cube = TensorDatacube([doc_axis, pos_axis],
                                   dtype=np.dtype(np.int32))
        # Random windows mostly miss the cache; it pays off on exact-step
        # replay (a restore) and epoch revisits, so it stays small.
        self.service = ExtractionService(self.cube, capacity=512,
                                         device=self._device)

    def _doc(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100_003 + doc_id)
        toks = np.empty(self.doc_len, np.int32)
        toks[0] = rng.integers(self.vocab)
        flip = rng.random(self.doc_len) < 0.1
        rand = rng.integers(0, self.vocab, self.doc_len)
        for i in range(1, self.doc_len):
            toks[i] = rand[i] if flip[i] else self._next[toks[i - 1]]
        return toks

    def materialize(self) -> np.ndarray:
        """The flat corpus (documents one after another) as numpy."""
        if self._flat is None:
            self._flat = np.concatenate(
                [self._doc(d) for d in range(self.n_docs)])
        return self._flat

    def payload(self):
        """The corpus as the service reads it: numpy on the CPU, one int32
        tensor on the card (uploaded once)."""
        if self._device.type == "cpu":
            return self.materialize()
        if self._payload is None:
            self._payload = torch.from_numpy(self.materialize()).to(
                self._device)
        return self._payload

    def windows(self, step: int, batch_size: int, seq_len: int,
                shard: int = 0, n_shards: int = 1
                ) -> tuple[np.ndarray, np.ndarray]:
        """(documents, window starts) of a batch's rows, drawn from the
        step and the shard; row r reads tokens ``starts[r]`` to
        ``starts[r] + seq_len`` of document ``docs[r]``."""
        rng = np.random.default_rng(step * 7919 + shard)
        rows = batch_size // n_shards
        docs = rng.integers(0, self.n_docs, rows)
        starts = rng.integers(0, self.doc_len - seq_len - 1, rows)
        return docs, starts

    def batch(self, step: int, batch_size: int, seq_len: int,
              shard: int = 0, n_shards: int = 1) -> dict:
        """Step-addressable batch (deterministic replay for a restore):
        ``{"tokens", "labels"}`` (rows, seq_len) int32, the labels the
        tokens shifted by one.  Numpy on the CPU, tensors on the card."""
        docs, starts = self.windows(step, batch_size, seq_len, shard,
                                    n_shards)
        if len(docs) == 0:
            toks = np.empty((0, seq_len + 1), np.int32)
            if self._device.type != "cpu":
                toks = torch.from_numpy(toks).to(self._device)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        reqs = [Request([Box(("doc", "pos"), [d, s0], [d, s0 + seq_len])])
                for d, s0 in zip(docs, starts)]
        results = self.service.submit_batch(reqs, self.payload())
        if self._device.type == "cpu":
            toks = np.stack([res.values for res in results]).astype(
                np.int32)
        else:
            toks = torch.stack([res.values for res in results])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
