"""DeepSeek-V3 671B [arXiv:2412.19437]: 61L d=7168, 128-head MLA,
MoE 256 experts top-8 + 1 shared (d_ff 2048), 3 leading dense layers,
multi-token prediction."""

import torch

from ..models.moe import MoEConfig
from ..models.transformer import TransformerConfig
from ..train.optimizer import OptimizerConfig
from .common import cut_layers, lm_arch

ID = "deepseek-v3-671b"


def _cfg() -> TransformerConfig:
    return TransformerConfig(
        name=ID, vocab=129_280, d_model=7168, n_layers=61, n_heads=128,
        n_kv_heads=128, d_head=128,
        d_ff=2048,
        attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        moe=MoEConfig(d_model=7168, d_ff=2048, n_experts=256, top_k=8,
                      n_shared=1, n_groups=32),
        n_dense_layers=3, dense_d_ff=18_432,
        mtp=True, dtype=torch.bfloat16, q_chunk=1024)


def _smoke() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke", vocab=256, d_model=64, n_layers=4, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=64,
        attn_type="mla", q_lora_rank=32, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2,
                      n_shared=1, capacity_factor=2.0),
        n_dense_layers=1, dense_d_ff=128, mtp=True,
        dtype=torch.float32, q_chunk=None)


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adafactor", lr=2.2e-4, warmup_steps=2000,
                           total_steps=100_000)


def get(layers: int | None = None):
    """The architecture's ``ArchDef``, with the JAX module's arguments
    (with ``layers``, each layer group cut to at most that many layers:
    ``common.cut_layers``)."""
    # 671B params: Adafactor (factored states) + full FSDP×TP sharding.
    return lm_arch(ID, cut_layers(_cfg(), layers), _smoke(), _opt(),
                   fsdp=True, accum=8)
