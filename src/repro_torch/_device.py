"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"``, and a
machine without a CUDA device raises instead of quietly planning and
reading on the host.  ``device="cpu"`` is the explicit request for the
plain PyTorch versions of the kernels (the CPU tests pass it).
``upload`` places host arrays beside the data in one copy.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the host")
    return dev


def seeded_generator(device: torch.device, seed: int
                     ) -> "torch.Generator | None":
    """A generator on ``device`` seeded with ``seed``; None on the
    ``meta`` device, where nothing is drawn (a model built there has its
    shapes and dtypes, and allocates nothing)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def upload(device: torch.device, *arrays: np.ndarray) -> list:
    """The host ``arrays`` (any dtype torch has) as tensors of their own
    shapes on ``device``, packed into one buffer (each at an 8-byte
    aligned offset) that moves in one copy: pinned and non-blocking to
    the card.  The caching host allocator keeps a pinned block from reuse
    until the copy that read it has run, so the buffer is never rewritten
    in flight."""
    if not arrays:
        return []
    arrays = [np.ascontiguousarray(a) for a in arrays]
    at = np.concatenate([[0], np.cumsum([-(-a.nbytes // 8) * 8
                                         for a in arrays])])
    host = torch.empty(int(at[-1]), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    staging = host.numpy()
    for a, lo in zip(arrays, at):
        staging[lo:lo + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True)
    return [buf[lo:lo + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .reshape(a.shape) for a, lo in zip(arrays, at)]
