"""Public entry points for extraction gathers.

The tensor's device decides the path: a CUDA tensor launches the CUDA
kernel (``kernel``), a CPU tensor takes the plain PyTorch version
(``ref``).  There is no fallback between them: a failed build or launch
raises.  ``use_pallas``/``interpret`` of ``gather_rows`` and
``gather_plan_runs`` keep the JAX package's signatures for parity and
are ignored — on the port the device decides.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LAUNCHES  # noqa: F401  (ops.LAUNCHES[name])
from .._casting import checked_cast_i32
from . import kernel, ref

# Burst chunk width in elements: one copy per chunk; runs longer than
# this split into several wide copies, shorter ones over-read (masked)
# and compact afterwards.
BURST_BLOCK = 128


def _route(t: torch.Tensor):
    """``kernel`` for a CUDA tensor, ``ref`` for a CPU tensor."""
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return ref
    raise ValueError(f"no gather path for a tensor on {t.device}")


def _index_tensor(indices, device: torch.device, *, what: str,
                  n_elements: int,
                  allow_negative_one: bool = False) -> torch.Tensor:
    """Validate and cast offsets to int32 (host-side for numpy input),
    then place them beside the data."""
    idx = checked_cast_i32(indices, what=what, n_elements=n_elements,
                           allow_negative_one=allow_negative_one)
    if isinstance(idx, np.ndarray):
        idx = torch.from_numpy(idx)
    return idx.to(device)


def gather_rows(table: torch.Tensor, indices, use_pallas: bool = False,
                interpret: bool = True) -> torch.Tensor:
    """``table[indices]`` for an (N, D) table; kernel B1 on the card."""
    idx = _index_tensor(indices, table.device, what="gather_rows indices",
                        n_elements=table.shape[0])
    return _route(table).gather_rows(table, idx)


def gather_rows_bag(table: torch.Tensor, bags) -> torch.Tensor:
    """Fused EmbeddingBag(sum) over an (N, D) table: ``out[b] =
    sum_l table[bags[b, l]]`` for (B, L) bags padded with -1 (the only
    negative value allowed); kernel B6 on the card."""
    idx = _index_tensor(bags, table.device, what="gather_rows_bag bags",
                        n_elements=table.shape[0], allow_negative_one=True)
    return _route(table).gather_rows_bag(table, idx)


def chunk_runs(run_starts: np.ndarray, run_lengths: np.ndarray,
               block: int = BURST_BLOCK
               ) -> tuple[np.ndarray, np.ndarray]:
    """Split coalesced plan runs into ≤``block``-element copy chunks.

    Pure numpy (host side — plan post-processing, not kernel work).
    Returns (chunk_starts (C,) int64, gather_idx (N,) int64): chunk c
    covers elements [chunk_starts[c], chunk_starts[c] + block) of the
    payload, and ``gather_idx`` compacts the (C·block,) chunk lattice
    back to the plan's N points in offset order.
    """
    starts = np.asarray(run_starts, np.int64)
    lens = np.asarray(run_lengths, np.int64)
    if starts.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    n_chunks = -(-lens // block)
    tot = int(n_chunks.sum())
    ends = np.cumsum(n_chunks)
    ordinal = np.arange(tot) - np.repeat(ends - n_chunks, n_chunks)
    chunk_starts = np.repeat(starts, n_chunks) + ordinal * block
    chunk_lens = np.minimum(block, np.repeat(lens, n_chunks)
                            - ordinal * block)
    cends = np.cumsum(chunk_lens)
    n = int(cends[-1])
    ramp = np.arange(n) - np.repeat(cends - chunk_lens, chunk_lens)
    gather_idx = np.repeat(np.arange(tot) * block, chunk_lens) + ramp
    return chunk_starts, gather_idx


def gather_plan_runs(flat: torch.Tensor, run_starts: np.ndarray,
                     run_lengths: np.ndarray, block: int = BURST_BLOCK,
                     use_pallas: bool = False,
                     interpret: bool = True) -> torch.Tensor:
    """Run-length-aware burst gather of an extraction plan.

    Reads every planned element of the flat (n,) payload as wide
    contiguous copies — one ≤``block``-element chunk of each coalesced
    run per copy (kernel B2 on the card) — then compacts the chunk
    lattice back to the plan's point order with a ``gather_rows`` (B1 on
    the card).  Byte-equal to ``flat[plan.offsets]``.
    """
    chunk_starts, gather_idx = chunk_runs(run_starts, run_lengths, block)
    if chunk_starts.size == 0:
        return flat.new_zeros((0,))
    cs = _index_tensor(chunk_starts, flat.device,
                       what="burst gather chunk starts",
                       n_elements=flat.shape[0])
    out = _route(flat).gather_runs(flat, cs, block)
    return gather_rows(out.reshape(-1, 1), gather_idx)[:, 0]
