"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: 35L
d=7168, 56-head GQA (kv=8), dense-MoE hybrid: 128-expert top-2 MoE in
parallel with a dense residual FFN (d_ff 4864)."""

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig
from .common import cut_layers, lm_arch

ID = "arctic-480b"


def _cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ID, vocab=32_000, d_model=7168, n_layers=35, n_heads=56,
        n_kv_heads=8, d_head=128, d_ff=4864,
        moe=MoEConfig(d_model=7168, d_ff=4864, n_experts=128, top_k=2,
                      n_groups=32),
        dense_residual=True, dense_d_ff=4864,
        dtype=torch.bfloat16, q_chunk=1024)


def _smoke() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke", vocab=256, d_model=64, n_layers=3, n_heads=8,
        n_kv_heads=2, d_head=8, d_ff=96,
        moe=MoEConfig(d_model=64, d_ff=96, n_experts=8, top_k=2,
                      capacity_factor=2.0),
        dense_residual=True, dense_d_ff=96,
        dtype=torch.float32, q_chunk=None)


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adafactor", lr=3e-4, warmup_steps=2000,
                           total_steps=100_000)


def get(layers: int | None = None):
    """The architecture's ``ArchDef``, with the JAX module's arguments
    (with ``layers``, each layer group cut to at most that many layers:
    ``common.cut_layers``)."""
    return lm_arch(ID, cut_layers(_cfg(), layers), _smoke(), _opt(),
                   fsdp=True)
