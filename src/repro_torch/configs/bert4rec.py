"""BERT4Rec [arXiv:1904.06690]: bidirectional 2-block transformer over
item sequences (embed 64, 2 heads of 32, d_ff 256, seq 200), RMSNorm,
RoPE and learned positions.

The item vocabulary is sized so that V = n_items + 2 = 2²⁰: the
``retrieval_cand`` shape (scoring 10⁶ candidates) is the model's own
softmax head.  The JAX configuration also sets ``scan_unroll``, which
only XLA's lowering reads (the port runs its layers in a Python loop),
so the port's configuration has no such field."""

import dataclasses

from ..models.recsys import bert4rec_config
from ..train.optimizer import OptimizerConfig
from .common import recsys_arch

ID = "bert4rec"


def _cfg():
    return bert4rec_config(n_items=1_048_574, seq_len=200)


def _smoke():
    c = bert4rec_config(n_items=500, seq_len=16)
    return dataclasses.replace(c, name=ID + "-smoke", d_model=32,
                               n_layers=2, d_ff=64, n_heads=2,
                               n_kv_heads=2, d_head=16)


def _opt() -> OptimizerConfig:
    """The training optimizer, as the JAX module's ``get()`` sets it."""
    return OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=100,
                           total_steps=300_000)


def get():
    """The architecture's ``ArchDef``, with the JAX module's arguments."""
    return recsys_arch(ID, "bert4rec", _cfg(), _smoke(), _opt())
