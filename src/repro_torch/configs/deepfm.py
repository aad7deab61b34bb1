"""DeepFM [arXiv:1703.04247]: 39 sparse fields, embed_dim 10,
deep MLP 400-400-400, FM second-order interaction.  Tables: 39 × 10⁶
rows of 10 (1.56 GB in float32) and a first-order table of width 1."""

from ..models.recsys import DeepFMConfig
from ..train.optimizer import OptimizerConfig
from .common import recsys_arch

ID = "deepfm"


def _cfg() -> DeepFMConfig:
    return DeepFMConfig(name=ID, n_sparse=39, rows=1_000_000,
                        embed_dim=10, mlp_dims=(400, 400, 400))


def _smoke() -> DeepFMConfig:
    return DeepFMConfig(name=ID + "-smoke", n_sparse=6, rows=64,
                        embed_dim=4, mlp_dims=(16, 16))


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=100,
                           total_steps=300_000)


def get():
    """The architecture's ``ArchDef``, with the JAX module's arguments."""
    return recsys_arch(ID, "deepfm", _cfg(), _smoke(), _opt())
