"""Public entry point for paged decode attention.

The tensor's device decides the path: a CUDA ``q`` launches the CUDA
kernel (``kernel``, B8), a CPU ``q`` takes the plain PyTorch version
(``ref``).  There is no fallback between them: a failed build or launch
raises.  ``use_pallas``/``interpret`` keep the JAX package's signature
and are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LAUNCHES  # noqa: F401  (ops.LAUNCHES[name])
from .._casting import checked_cast_i32
from . import kernel, ref


def _route(t: torch.Tensor):
    """``kernel`` for a CUDA tensor, ``ref`` for a CPU tensor."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return ref
    raise ValueError(f"no paged attention path for a tensor on {t.device}")


def _i32(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a.to(device)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table, seq_lens,
                           use_pallas: bool = False,
                           interpret: bool = True) -> torch.Tensor:
    """One decode token's GQA attention per sequence over the pages its
    block table names (kernel B8 on the card).

    ``block_table`` entries are page ids in [0, n_pages) with ``-1``
    marking unused slots; ``seq_lens`` live KV lengths in [0, PMAX·PS].
    Both go through the bounds-checked int32 cast (offsets past 2³¹
    raise instead of truncating).  A ``-1`` among a sequence's live
    entries (the first ``ceil(seq_lens[b] / PS)``) raises: the kernel
    reads every live entry as a page id.
    """
    route = _route(q)
    n_pages, _, ps, _ = k_pages.shape
    pmax = block_table.shape[1]
    table = _i32(checked_cast_i32(block_table,
                                  what="paged_decode_attention block_table",
                                  n_elements=n_pages,
                                  allow_negative_one=True), q.device)
    lens = _i32(checked_cast_i32(seq_lens,
                                 what="paged_decode_attention seq_lens",
                                 n_elements=pmax * ps + 1), q.device)
    live = (torch.arange(pmax, device=q.device)[None, :]
            < (lens[:, None] + ps - 1) // ps)
    if bool(((table < 0) & live).any()):
        raise IndexError("paged_decode_attention block_table: a -1 entry "
                         "among a sequence's live pages")
    return route.paged_decode_attention(q, k_pages, v_pages, table, lens)
