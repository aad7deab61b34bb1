"""IBM Granite-3 8B [hf:ibm-granite/granite-3.0]: 40L d=4096,
32-head GQA (kv=8), d_ff 12800, vocab 49155."""

import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig
from .common import lm_arch

ID = "granite-3-8b"


def _cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ID, vocab=49_155, d_model=4096, n_layers=40, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=12_800,
        dtype=torch.bfloat16, q_chunk=1024)


def _smoke() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke", vocab=256, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, dtype=torch.float32,
        q_chunk=None)


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=3e-4, warmup_steps=2000,
                           total_steps=100_000)


def get():
    """The architecture's ``ArchDef``, with the JAX module's arguments."""
    return lm_arch(ID, _cfg(), _smoke(), _opt(), fsdp=False)
