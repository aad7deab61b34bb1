"""Plain PyTorch version of paged decode attention (GQA).

The CPU path of ``ops`` and the yardstick ``chip_smoke.py`` holds the
CUDA kernel (B8) against on the card.  Layouts, as in the JAX package:

  q           — (B, H, Dh)        one new token per sequence
  k_pages     — (NP, KVH, PS, Dh) global page pool
  v_pages     — (NP, KVH, PS, Dh)
  block_table — (B, PMAX) int32   page ids per sequence (-1 = unused)
  seq_lens    — (B,)    int32     live KV length per sequence

H = KVH * G (grouped-query attention).  This version gathers the dense
cache of every table entry (-1 as page 0), as the JAX package's oracle
does; the kernel reads only the live slots of the planned pages.
"""

from __future__ import annotations

import math

import torch


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """Softmax of ``q·k / sqrt(Dh)`` over each sequence's live slots
    (``pos < seq_lens[b]``) times V, in float32, cast to ``q``'s dtype.

    Two departures from the JAX oracle, neither of which changes the
    function on finite data: dead slots contribute zero to the V sum
    even where the gathered page holds NaN or inf (the JAX oracle's
    ``0 * NaN`` would leak them), and a sequence with ``seq_lens == 0``
    gets zeros where the JAX oracle gives NaN (its softmax over no live
    slot) and its Pallas kernel the mean of page 0's V.
    """
    b, h, dh = q.shape
    _, kvh, ps, _ = k_pages.shape
    pmax = block_table.shape[1]
    g = h // kvh

    table = block_table.clamp(min=0).long()                # (B, PMAX)
    k = k_pages[table]                          # (B, PMAX, KVH, PS, Dh)
    v = v_pages[table]
    k = k.movedim(2, 1).reshape(b, kvh, pmax * ps, dh)
    v = v.movedim(2, 1).reshape(b, kvh, pmax * ps, dh)

    pos = torch.arange(pmax * ps, device=q.device)[None, :]     # (1, S)
    live = pos < seq_lens.long()[:, None]                       # (B, S)

    qg = q.reshape(b, kvh, g, dh).float()
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) / math.sqrt(dh)
    scores = torch.where(live[:, None, None, :], scores, -torch.inf)
    p = torch.softmax(scores, dim=-1)
    p = torch.where(live[:, None, None, :], p, 0.0)   # NaN rows at len 0
    v = torch.where(live[:, None, :, None], v.float(), 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", p, v)
    return out.reshape(b, h, dh).to(q.dtype)
