"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means ``"cuda"``, and a
machine without a CUDA device raises instead of quietly planning and
reading on the host.  ``device="cpu"`` is the explicit request for the
plain PyTorch versions of the kernels (the CPU tests pass it).
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the host")
    return dev
