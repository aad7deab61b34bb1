"""Two-tower retrieval [Yi et al., RecSys'19]: embed_dim 256, tower
MLPs 1024-512-256, dot scoring.  ``retrieval_cand`` is one query × 10⁶
candidates (padded to 2²⁰) scored as one matrix product.  Tables: 10⁶
users and 10⁶ items × 256, 2.05 GB in float32."""

from ..models.recsys import TwoTowerConfig
from ..train.optimizer import OptimizerConfig
from .common import recsys_arch

ID = "two-tower-retrieval"


def _cfg() -> TwoTowerConfig:
    return TwoTowerConfig(name=ID, n_users=1_000_000, n_items=1_000_000,
                          embed_dim=256, tower=(1024, 512, 256))


def _smoke() -> TwoTowerConfig:
    return TwoTowerConfig(name=ID + "-smoke", n_users=128, n_items=128,
                          embed_dim=16, tower=(32, 16))


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=100,
                           total_steps=300_000)


def get():
    """The architecture's ``ArchDef``, with the JAX module's arguments."""
    return recsys_arch(ID, "twotower", _cfg(), _smoke(), _opt())
