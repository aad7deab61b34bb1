"""DLRM RM-2 [arXiv:1906.00091]: 13 dense + 26 sparse features,
embed_dim 64, bottom MLP 13-512-256-64, top MLP 512-512-256-1, dot
interaction.  Tables: 26 × 10⁶ rows (Criteo-scale), 6.66 GB in
float32."""

from ..models.recsys import DLRMConfig
from ..train.optimizer import OptimizerConfig
from .common import recsys_arch

ID = "dlrm-rm2"


def _cfg() -> DLRMConfig:
    return DLRMConfig(name=ID, n_dense=13, n_sparse=26, rows=1_000_000,
                      embed_dim=64, bot_mlp=(512, 256, 64),
                      top_mlp=(512, 512, 256, 1), bag_size=1)


def _smoke() -> DLRMConfig:
    return DLRMConfig(name=ID + "-smoke", n_dense=13, n_sparse=4,
                      rows=128, embed_dim=8, bot_mlp=(16, 8),
                      top_mlp=(16, 1), bag_size=1)


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=100,
                           total_steps=300_000)


def get():
    """The architecture's ``ArchDef``, with the JAX module's arguments."""
    return recsys_arch(ID, "dlrm", _cfg(), _smoke(), _opt())
