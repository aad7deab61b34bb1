"""NequIP [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 Bessel
RBFs, 5 Å cutoff, E(3)-equivariant tensor products.  One trunk serves
every graph shape of ``GNN_SHAPES``; ``for_shape`` sets the input
width, the output width and the readout of each."""

import dataclasses

from ..models.nequip import NequIPConfig
from ..train.optimizer import OptimizerConfig
from .common import GNN_SHAPES, gnn_arch

ID = "nequip"


def _cfg() -> NequIPConfig:
    return NequIPConfig(name=ID, n_layers=5, channels=32, l_max=2,
                        n_rbf=8, cutoff=5.0)


def _smoke() -> NequIPConfig:
    return NequIPConfig(name=ID + "-smoke", n_layers=2, channels=8,
                        l_max=2, n_rbf=4, cutoff=5.0)


def for_shape(shape: str, smoke: bool = False) -> NequIPConfig:
    """The configuration at ``GNN_SHAPES[shape]``: its ``d_feat``,
    ``n_out`` and ``readout`` on the published (or smoke) trunk."""
    info = GNN_SHAPES[shape]
    return dataclasses.replace(_smoke() if smoke else _cfg(),
                               d_feat=info["d_feat"], n_out=info["n_out"],
                               readout=info["readout"])


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=100,
                           total_steps=50_000)


def get():
    """The architecture's ``ArchDef``, with the JAX module's arguments."""
    return gnn_arch(ID, _cfg(), _smoke(), _opt())
