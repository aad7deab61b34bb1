"""CUDA kernels for paged decode attention (``csrc/paged_attn_tc.cu``,
``csrc/paged_attn.cu``).

* ``paged_decode_attention`` (B8) — q (B, H, Dh) against the page pool
  (NP, KVH, PS, Dh) through block_table (B, PMAX) and seq_lens (B,),
  bf16 or float32 → (B, H, Dh) in q's dtype; split-KV flash decoding.

B8 has two kernels, and the wrapper picks one by dtype and shape (a
dispatch, not a fallback: each raises if its build or launch fails):

* the tensor-core kernel (``paged_attn_tc.cu``) for bf16 with Dh in
  ``TC_HEAD_DIMS``, G = H / KVH ≤ ``TC_MAX_GROUP`` and 16-byte aligned q
  and pages — every LM configuration of the repo at full width; counted
  as ``LAUNCHES["paged_decode_attention"]``;
* the CUDA-core kernel (``paged_attn.cu``, ``paged_decode_attention_simt``)
  for float32 (TF32 products would miss its 2e-5 bound) and every other
  bf16 shape; counted as ``LAUNCHES["paged_decode_attention_simt"]``.

The wrapper checks its tensors, picks the number of KV splits, allocates
the output and the split workspace with ``torch.empty``, launches on
PyTorch's current stream (the attention kernel, then the merge when
there is more than one split), raises if a launch is refused, and counts
one launch.  The table and lengths arrive already validated and cast by
``ops`` (``checked_cast_i32``).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .._build import LAUNCHES

# The fewest pages a split walks when the grid is split for occupancy.
MIN_SPLIT_PAGES = 8
# The tensor-core kernel's shapes: the G rows are one 16-row mma tile.
TC_HEAD_DIMS = (16, 32, 64, 128)
TC_MAX_GROUP = 16
# The fewest live pages a split of the tensor-core kernel walks (two
# 16-token steps for each of its 4 warps at PS = 16), and the most splits
# it is given: past 8, the merge pass's walk over the partials and the
# empty CTAs of short sequences cost more than the extra CTAs bring.
TC_MIN_SPLIT_PAGES = 8
TC_MAX_SPLITS = 8


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_for(b: int, kvh: int, pmax: int, device: torch.device) -> int:
    """KV splits per (sequence, KV head): enough CTAs for two per SM,
    with at least ``MIN_SPLIT_PAGES`` table entries per split."""
    want = -(-2 * _sm_count(device.index or 0) // max(b * kvh, 1))
    return max(1, min(want, -(-pmax // MIN_SPLIT_PAGES)))


def split_for_tc(b: int, kvh: int, pmax: int, device: torch.device) -> int:
    """KV splits per (sequence, KV head) of the tensor-core kernel: one
    CTA per SM, at most ``TC_MAX_SPLITS`` and ``ceil(PMAX /
    TC_MIN_SPLIT_PAGES)``.  The kernel gives each split at least
    ``TC_MIN_SPLIT_PAGES`` live pages, so a shorter sequence leaves its
    last splits empty.  Measured on the H100 (PERF.md §6): more splits
    were slower at the engine's rounds and at ``decode_32k``."""
    want = -(-_sm_count(device.index or 0) // max(b * kvh, 1))
    return max(1, min(want, TC_MAX_SPLITS, -(-pmax // TC_MIN_SPLIT_PAGES)))


def takes_tensor_cores(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor) -> bool:
    """Whether B8 on these tensors runs on the tensor-core kernel."""
    h, dh, kvh = q.shape[1], q.shape[2], k_pages.shape[1]
    return (q.dtype == torch.bfloat16 and dh in TC_HEAD_DIMS
            and kvh > 0 and h // kvh <= TC_MAX_GROUP
            and all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)))


def _checked(q, k_pages, v_pages, block_table, seq_lens) -> torch.device:
    dev = _build.cuda_device(q, "paged_decode_attention q")
    dtypes = (torch.bfloat16, torch.float32)
    _build.expect(q, "paged_decode_attention q", device=dev, dtype=dtypes,
                  shape=(None, None, None))
    b, h, dh = q.shape
    _build.expect(k_pages, "paged_decode_attention k_pages", device=dev,
                  dtype=q.dtype, shape=(None, None, None, dh))
    _build.expect(v_pages, "paged_decode_attention v_pages", device=dev,
                  dtype=q.dtype, shape=tuple(k_pages.shape))
    kvh = k_pages.shape[1]
    if kvh == 0 or h % kvh:
        raise ValueError(f"paged_decode_attention: {h} query heads do not "
                         f"group over {kvh} KV heads")
    _build.expect(block_table, "paged_decode_attention block_table",
                  device=dev, dtype=torch.int32, shape=(b, None))
    _build.expect(seq_lens, "paged_decode_attention seq_lens", device=dev,
                  dtype=torch.int32, shape=(b,))
    return dev


def _launch(tc: bool, q, k_pages, v_pages, block_table, seq_lens,
            n_split: int | None, dev: torch.device) -> torch.Tensor:
    b, h, dh = q.shape
    _, kvh, ps, _ = k_pages.shape
    pmax = block_table.shape[1]
    out = torch.empty_like(q)
    if b == 0 or h == 0 or dh == 0:
        return out
    if n_split is None:
        n_split = (split_for_tc if tc else split_for)(b, kvh, pmax, dev)
    if n_split < 1:
        raise ValueError(f"paged_decode_attention: n_split {n_split} < 1")
    part = None
    if n_split > 1:
        part = torch.empty(b * kvh * n_split * (h // kvh) * (dh + 2),
                           dtype=torch.float32, device=dev)
    args = (dev.index or 0, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_table.data_ptr(), seq_lens.data_ptr(),
            b, h, kvh, dh, ps, pmax, n_split)
    tail = (part.data_ptr() if part is not None else None, out.data_ptr(),
            _build.stream_of(dev))
    if tc:
        lib = _build.library("paged_attn_tc")
        status = lib.polytope_paged_decode_attention_tc(
            *args, TC_MIN_SPLIT_PAGES, *tail)
        _build.check(lib, status, "paged_decode_attention (tensor cores)")
        LAUNCHES["paged_decode_attention"] += 1
    else:
        lib = _build.library("paged_attn")
        status = lib.polytope_paged_decode_attention(
            *args, q.element_size(), *tail)
        _build.check(lib, status, "paged_decode_attention")
        LAUNCHES["paged_decode_attention_simt"] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor,
                           n_split: int | None = None) -> torch.Tensor:
    """Decode attention over the planned pages on the card: the
    tensor-core kernel where ``takes_tensor_cores``, else the CUDA-core
    kernel.

    q           — (B, H, Dh) bf16 or float32 CUDA tensor
    k_pages     — (NP, KVH, PS, Dh), v_pages the same, in q's dtype
    block_table — (B, PMAX) int32; entries below ceil(seq_lens / PS)
                  are pages in [0, NP), the rest are never read
    seq_lens    — (B,) int32 in [0, PMAX·PS]
    n_split     — KV splits per (sequence, KV head); ``split_for_tc`` or
                  ``split_for`` when None (1 is the kernel without the
                  merge pass); on the tensor cores each split walks at
                  least ``TC_MIN_SPLIT_PAGES`` live pages
    """
    dev = _checked(q, k_pages, v_pages, block_table, seq_lens)
    return _launch(takes_tensor_cores(q, k_pages, v_pages), q, k_pages,
                   v_pages, block_table, seq_lens, n_split, dev)


def paged_decode_attention_simt(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                block_table: torch.Tensor,
                                seq_lens: torch.Tensor,
                                n_split: int | None = None) -> torch.Tensor:
    """The same function on the CUDA-core kernel whatever the shape (the
    one ``paged_decode_attention`` takes where the tensor cores do not);
    ``chip_smoke.py`` times it beside the tensor-core kernel."""
    dev = _checked(q, k_pages, v_pages, block_table, seq_lens)
    return _launch(False, q, k_pages, v_pages, block_table, seq_lens,
                   n_split, dev)
