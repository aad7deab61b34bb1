"""Bounds-checked int32 casts for offset-carrying arrays.

The CUDA kernels take int32 indices and plan buffers, so every kernel
entry point casts its offsets/indices down from the planner's int64.  On
a >2³¹-element datacube that cast silently truncates — the exact
byte-exactness bug the paper's contract forbids, and one no small-cube
test ever catches.  This module is the single place the cast is allowed
to happen: validation runs before the cast and raises a clear error
naming the cube size instead of reading the wrong bytes.

Accepts numpy arrays and torch tensors; a tensor is validated where it
lies (a CUDA tensor's min/max cost one small device reduction and a
synchronising read) and cast on its own device.  A fake tensor
(``is_fake``) has no values to validate: it is cast unread.
"""

from __future__ import annotations

import numpy as np
import torch

I32_LIMIT = 2 ** 31


def ensure_i32_addressable(n_elements: int, what: str = "datacube") -> None:
    """Raise unless every offset in ``[0, n_elements)`` fits in int32.

    Call with static sizes before launching kernels whose index
    arithmetic ends in int32 outputs.
    """
    if n_elements > I32_LIMIT:
        raise OverflowError(
            f"{what} has {n_elements} elements; offsets up to "
            f"{n_elements - 1} do not fit in int32 (limit {I32_LIMIT - 1}). "
            f"Shard the cube or keep offsets int64 host-side before "
            f"kernels consume them.")


def is_fake(x) -> bool:
    """``x`` is a fake tensor (``torch._subclasses.FakeTensor``: a shape,
    a dtype and a device, no values), or a ``DTensor`` whose local
    tensor is one.  The dry run's trace (``launch.cost``) runs the
    cells on such tensors: the id checks read none of one (they have
    nothing to read), and ``configs.common.model_fn`` keeps the
    constants it builds for them apart from real ones."""
    from torch._subclasses.fake_tensor import FakeTensor

    local = getattr(x, "_local_tensor", x)
    return isinstance(local, FakeTensor)


def checked_cast_i32(indices, *, what: str = "offsets",
                     n_elements: int | None = None,
                     allow_negative_one: bool = False):
    """Cast ``indices`` to int32 after validating they fit.

    ``n_elements``        — when given, offsets must be < n_elements
                            (and the cube itself must be i32-addressable).
    ``allow_negative_one`` — permit ``-1`` padding slots.

    Returns the same kind of array it was given: a numpy int32 array for
    numpy input, an int32 tensor on the input's device for a tensor.
    """
    if n_elements is not None:
        ensure_i32_addressable(n_elements, what=f"{what}: index space")
    is_tensor = isinstance(indices, torch.Tensor)
    arr = indices if is_tensor else np.asarray(indices)
    n = arr.numel() if is_tensor else arr.size
    if n and not (is_tensor and is_fake(arr)):
        hi = int(arr.max())
        lo = int(arr.min())
        if hi >= I32_LIMIT:
            space = (f" (index space has {n_elements} elements)"
                     if n_elements is not None else "")
            raise OverflowError(
                f"{what}: max offset {hi} does not fit in int32 "
                f"(limit {I32_LIMIT - 1}){space} — the int32 cast before "
                f"the gather kernel would silently read the wrong bytes.")
        if n_elements is not None and hi >= n_elements:
            raise IndexError(
                f"{what}: offset {hi} out of bounds for an index space "
                f"of {n_elements} elements.")
        floor = -1 if allow_negative_one else 0
        if lo < floor:
            raise IndexError(
                f"{what}: negative offset {lo} "
                f"({'only -1 padding is' if allow_negative_one else 'none'}"
                f" allowed).")
    if is_tensor:
        return arr.to(torch.int32)
    return arr.astype(np.int32)
