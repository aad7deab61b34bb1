"""Shared dense layers as ``nn.Module``s.

The weight keeps the JAX layout ``w (d_in, d_out)`` beside the bias
``b``, so a layer computes ``x @ w + b`` exactly as the JAX package
writes it, and a carried parameter tree loads without transposes.
Initialisers draw from an explicit ``torch.Generator`` on the target
device; nothing reads PyTorch's global generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Dense(nn.Module):
    """``x @ w + b``: ``w`` drawn normal · 1/√d_in, ``b`` zeros."""

    def __init__(self, d_in: int, d_out: int, *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        w = torch.empty((d_in, d_out), dtype=dtype, device=device)
        self.w = nn.Parameter(w.normal_(0.0, 1.0 / math.sqrt(d_in),
                                        generator=generator))
        self.b = nn.Parameter(torch.zeros((d_out,), dtype=dtype,
                                          device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class MLP(nn.Module):
    """Dense layers over ``dims`` with ReLU between them and no final
    activation."""

    def __init__(self, dims: "list[int] | tuple[int, ...]", *,
                 generator: torch.Generator, device: torch.device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(d_in, d_out, generator=generator, device=device,
                  dtype=dtype)
            for d_in, d_out in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last:
                x = torch.relu(x)
        return x
