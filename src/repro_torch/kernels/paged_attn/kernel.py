"""CUDA kernel for paged decode attention (``csrc/paged_attn.cu``).

* ``paged_decode_attention`` (B8) — q (B, H, Dh) against the page pool
  (NP, KVH, PS, Dh) through block_table (B, PMAX) and seq_lens (B,),
  bf16 or float32 → (B, H, Dh) in q's dtype; split-KV flash decoding.

The wrapper checks its tensors, picks the number of KV splits, allocates
the output and the split workspace with ``torch.empty``, launches on
PyTorch's current stream (the attention kernel, then the merge when
there is more than one split), raises if a launch is refused, and counts
one launch in ``LAUNCHES``.  The table and lengths arrive already
validated and cast by ``ops`` (``checked_cast_i32``).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .._build import LAUNCHES

# The fewest pages a split walks when the grid is split for occupancy.
MIN_SPLIT_PAGES = 8


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_for(b: int, kvh: int, pmax: int, device: torch.device) -> int:
    """KV splits per (sequence, KV head): enough CTAs for two per SM,
    with at least ``MIN_SPLIT_PAGES`` table entries per split."""
    want = -(-2 * _sm_count(device.index or 0) // max(b * kvh, 1))
    return max(1, min(want, -(-pmax // MIN_SPLIT_PAGES)))


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor,
                           n_split: int | None = None) -> torch.Tensor:
    """Decode attention over the planned pages on the card.

    q           — (B, H, Dh) bf16 or float32 CUDA tensor
    k_pages     — (NP, KVH, PS, Dh), v_pages the same, in q's dtype
    block_table — (B, PMAX) int32; entries below ceil(seq_lens / PS)
                  are pages in [0, NP), the rest are never read
    seq_lens    — (B,) int32 in [0, PMAX·PS]
    n_split     — KV splits per (sequence, KV head); ``split_for`` when
                  None (1 is the kernel without the merge pass)
    """
    dev = _build.cuda_device(q, "paged_decode_attention q")
    dtypes = (torch.bfloat16, torch.float32)
    _build.expect(q, "paged_decode_attention q", device=dev, dtype=dtypes,
                  shape=(None, None, None))
    b, h, dh = q.shape
    _build.expect(k_pages, "paged_decode_attention k_pages", device=dev,
                  dtype=q.dtype, shape=(None, None, None, dh))
    _build.expect(v_pages, "paged_decode_attention v_pages", device=dev,
                  dtype=q.dtype, shape=tuple(k_pages.shape))
    _, kvh, ps, _ = k_pages.shape
    if kvh == 0 or h % kvh:
        raise ValueError(f"paged_decode_attention: {h} query heads do not "
                         f"group over {kvh} KV heads")
    _build.expect(block_table, "paged_decode_attention block_table",
                  device=dev, dtype=torch.int32, shape=(b, None))
    _build.expect(seq_lens, "paged_decode_attention seq_lens", device=dev,
                  dtype=torch.int32, shape=(b,))
    pmax = block_table.shape[1]
    out = torch.empty_like(q)
    if b == 0 or h == 0 or dh == 0:
        return out
    if n_split is None:
        n_split = split_for(b, kvh, pmax, dev)
    if n_split < 1:
        raise ValueError(f"paged_decode_attention: n_split {n_split} < 1")
    part = None
    if n_split > 1:
        part = torch.empty(b * kvh * n_split * (h // kvh) * (dh + 2),
                           dtype=torch.float32, device=dev)
    lib = _build.library("paged_attn")
    status = lib.polytope_paged_decode_attention(
        dev.index or 0, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
        b, h, kvh, dh, ps, pmax, n_split, q.element_size(),
        part.data_ptr() if part is not None else None, out.data_ptr(),
        _build.stream_of(dev))
    _build.check(lib, status, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out
