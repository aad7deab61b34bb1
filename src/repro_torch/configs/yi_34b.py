"""Yi-34B [arXiv:2403.04652]: 60L d=7168, 56-head GQA (kv=8),
d_ff 20480, vocab 64000 — llama-architecture."""

import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig
from .common import cut_layers, lm_arch

ID = "yi-34b"


def _cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ID, vocab=64_000, d_model=7168, n_layers=60, n_heads=56,
        n_kv_heads=8, d_head=128, d_ff=20_480, rope_theta=5_000_000.0,
        dtype=torch.bfloat16, q_chunk=1024)


def _smoke() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke", vocab=256, d_model=56, n_layers=2, n_heads=7,
        n_kv_heads=1, d_head=8, d_ff=160, dtype=torch.float32,
        q_chunk=None)


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=1.5e-4, warmup_steps=2000,
                           total_steps=100_000)


def get(layers: int | None = None):
    """The architecture's ``ArchDef``, with the JAX module's arguments
    (with ``layers``, each layer group cut to at most that many layers:
    ``common.cut_layers``)."""
    return lm_arch(ID, cut_layers(_cfg(), layers), _smoke(), _opt(),
                   fsdp=True)
