"""GLM-4 9B [hf:THUDM/glm-4-9b]: 40L d=4096, 32-head GQA (kv=2),
d_ff 13696, vocab 151552, RoPE."""

import torch

from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig
from .common import lm_arch

ID = "glm4-9b"


def _cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ID, vocab=151_552, d_model=4096, n_layers=40, n_heads=32,
        n_kv_heads=2, d_head=128, d_ff=13_696,
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
    # 9B dense: pure TP within the pod (no FSDP), AdamW states ZeRO-1.
    return lm_arch(ID, _cfg(), _smoke(), _opt(), fsdp=False)
