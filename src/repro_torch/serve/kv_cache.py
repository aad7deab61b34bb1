"""Paged KV cache — the Polytope algorithm applied to serving.

The cache is a datacube over (page, kv_head, slot, head_dim); a decode
step needs exactly the pages of the live sequences.  The *planner* here
is the serving-side analogue of the paper's index tree: per sequence it
yields the page list (= extraction plan), and the attention kernel
(``repro_torch.kernels.paged_attn``, B8) reads only the live slots of
those pages — never the dead ones (proved by the poisoning tests in
``tests/test_torch_lm.py`` and ``tests/test_torch_cuda.py``).

Carried from the JAX package with its logic unchanged.  ``slot()``
returns the page and slot of position ``lengths[seq_id]``; the engine
counts a token (``extend``) as soon as it is produced, before its K/V
is written, so at decode time that is one past the pending token.  The
engine writes at ``lengths - 1`` and does not call ``slot()`` (ROADMAP
C5).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class PagedKVCache:
    """Host-side page table manager (device arrays live in the engine)."""

    n_pages: int
    page_size: int
    max_pages_per_seq: int

    free_pages: list[int] = field(default_factory=list)
    tables: dict[int, list[int]] = field(default_factory=dict)
    lengths: dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        self.free_pages = list(range(self.n_pages))

    # -- allocation ------------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        need = (n_tokens + self.page_size - 1) // self.page_size
        if need > self.max_pages_per_seq:
            raise ValueError("sequence exceeds max pages")
        if need > len(self.free_pages):
            raise MemoryError("KV cache exhausted")
        pages = [self.free_pages.pop() for _ in range(need)]
        self.tables[seq_id] = pages
        self.lengths[seq_id] = n_tokens
        return pages

    def extend(self, seq_id: int) -> int | None:
        """Account one more token; allocate a page on boundary cross."""
        self.lengths[seq_id] += 1
        used = self.lengths[seq_id]
        have = len(self.tables[seq_id]) * self.page_size
        if used > have:
            if not self.free_pages:
                raise MemoryError("KV cache exhausted")
            page = self.free_pages.pop()
            self.tables[seq_id].append(page)
            return page
        return None

    def release(self, seq_id: int) -> None:
        self.free_pages.extend(self.tables.pop(seq_id))
        self.lengths.pop(seq_id)

    # -- extraction plan ---------------------------------------------------
    def plan(self, seq_ids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Block table + lengths for a decode batch — the Polytope
        extraction plan over the KV datacube."""
        bt = np.full((len(seq_ids), self.max_pages_per_seq), -1,
                     np.int32)
        lens = np.zeros(len(seq_ids), np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.tables[sid]
            bt[i, :len(pages)] = pages
            lens[i] = self.lengths[sid]
        return bt, lens

    def slot(self, seq_id: int) -> tuple[int, int]:
        """(page, in-page slot) of the *next* token write."""
        pos = self.lengths[seq_id]
        return self.tables[seq_id][pos // self.page_size], \
            pos % self.page_size

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free_pages) / self.n_pages
