"""Training set-ups of every architecture: the port of the JAX package's
``lm_arch``, ``gnn_arch`` and ``recsys_arch`` ``.smoke()`` (its
``configs/common.py``).

``smoke(arch_id)`` builds the smoke configuration's model (seeded
weights on ``device``), its train state with the configuration's
optimizer (``_opt()``), the train step of its loss and the smoke batch,
drawn as the JAX package draws it (``numpy``'s ``default_rng(0)``; the
LMs' tokens, which the JAX package draws with ``jax.random``, from
``default_rng(0)`` too).  ``train(arch_id, cfg)`` does the same for any
configuration of those models, such as the published ones.

Five kinds of model: the recsys modules (``dlrm``, ``deepfm``,
``twotower``), ``nequip`` (an ``nn.Module`` whose parameters
``carry.model_params`` keys by the JAX paths) and the decoders (``lm``,
``bert4rec``), whose parameters are one flat dict keyed by the JAX
tree's paths with each group's layers stacked (``carry.decoder_params``):
that dict is both the "model" and the train state's ``params``, and the
loss runs on ``carry.decoder_tree`` of it.  The LM smoke step runs the
schedule of the JAX smoke (``warmup_steps=2, total_steps=10``).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

from .. import carry
from ..models import nequip as nq
from ..models import recsys as rs
from ..models import transformer as tf
from ..train.train_state import init_train_state, make_train_step
from . import _MODULES

FAMILIES = {"deepseek-v3-671b": "lm", "arctic-480b": "lm",
            "glm4-9b": "lm", "granite-3-8b": "lm", "yi-34b": "lm",
            "nequip": "gnn", "dlrm-rm2": "recsys", "deepfm": "recsys",
            "two-tower-retrieval": "recsys", "bert4rec": "recsys"}
# The model kind of each architecture.
KINDS = {**{a: "lm" for a, f in FAMILIES.items() if f == "lm"},
         "nequip": "nequip", "dlrm-rm2": "dlrm", "deepfm": "deepfm",
         "two-tower-retrieval": "twotower", "bert4rec": "bert4rec"}
SMOKE_BATCH = 8
LM_SMOKE_TOKENS = (2, 16)       # the JAX LM smoke batch's (rows, seq)
GNN_SMOKE = dict(d_feat=8, n_out=3, nodes=16, edges=40)
_MODELS = {"dlrm": rs.DLRM, "deepfm": rs.DeepFM, "twotower": rs.TwoTower,
           "nequip": nq.NequIP}
_LOSSES = {"dlrm": rs.dlrm_loss, "deepfm": rs.deepfm_loss,
           "twotower": rs.twotower_loss, "nequip": nq.nequip_loss}


def kind_of(arch_id: str) -> str:
    """The model kind of ``arch_id``."""
    if arch_id not in KINDS:
        raise KeyError(f"unknown arch {arch_id!r}")
    return KINDS[arch_id]


def module_of(arch_id: str):
    return importlib.import_module(f"{__package__}.{_MODULES[arch_id]}")


def loss_for(kind: str, model, cfg=None):
    """``loss_fn(params, batch) → (loss, metrics)`` of ``model``, whose
    parameters are ``params`` (``carry.model_params(model)``; for a
    decoder, the flat dict itself, and ``cfg`` its configuration)."""
    if kind == "lm":
        def lm_loss(params, batch):
            return tf.loss_fn(carry.decoder_tree(params, cfg), cfg,
                              batch["tokens"], batch["labels"])
        return lm_loss
    if kind == "bert4rec":
        return lambda params, batch: (rs.bert4rec_loss(
            carry.decoder_tree(params, cfg), cfg, batch), {})
    loss = _LOSSES[kind]
    return lambda params, batch: (loss(model, batch), {})


def smoke_batch(kind: str, cfg) -> dict:
    """The JAX smoke batch as numpy arrays."""
    rng = np.random.default_rng(0)
    bsz = SMOKE_BATCH
    if kind == "dlrm":
        return {"dense": rng.normal(size=(bsz, cfg.n_dense)).astype(
                    np.float32),
                "bags": rng.integers(0, cfg.rows, (bsz, cfg.n_sparse,
                                                   cfg.bag_size)).astype(
                    np.int32),
                "labels": rng.integers(0, 2, bsz).astype(np.float32)}
    if kind == "deepfm":
        return {"bags": rng.integers(0, cfg.rows, (bsz, cfg.n_sparse,
                                                   1)).astype(np.int32),
                "labels": rng.integers(0, 2, bsz).astype(np.float32)}
    if kind == "twotower":
        return {"user_ids": np.arange(bsz, dtype=np.int32),
                "item_ids": np.arange(bsz, dtype=np.int32),
                "item_logq": np.zeros((bsz,), np.float32)}
    if kind == "bert4rec":
        items = rng.integers(0, cfg.vocab - 2, (bsz, 16)).astype(np.int32)
        return {"items": items, "labels": items,
                "mask": np.ones((bsz, 16), np.float32)}
    if kind == "nequip":
        n, e = GNN_SMOKE["nodes"], GNN_SMOKE["edges"]
        return {"node_feat": rng.normal(size=(n, cfg.d_feat)).astype(
                    np.float32),
                "positions": rng.uniform(0, 3, (n, 3)).astype(np.float32),
                "edge_index": rng.integers(0, n, (2, e)).astype(np.int32),
                "labels": rng.integers(0, cfg.n_out, n).astype(np.int32),
                "label_mask": np.ones((n,), np.float32)}
    toks = rng.integers(0, cfg.vocab, LM_SMOKE_TOKENS).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def smoke_cfg(arch_id: str):
    """The configuration ``smoke`` trains: the module's ``_smoke()``; for
    NequIP its trunk with the JAX smoke's node-class head
    (``GNN_SMOKE``)."""
    cfg = module_of(arch_id)._smoke()
    if kind_of(arch_id) == "nequip":
        cfg = dataclasses.replace(cfg, d_feat=GNN_SMOKE["d_feat"],
                                  n_out=GNN_SMOKE["n_out"],
                                  readout="node_class")
    return cfg


def train(arch_id: str, cfg, device=None, seed: int = 0,
          opt_cfg=None) -> dict:
    """``{"model", "state", "step", "kind", "opt"}`` for ``arch_id`` at
    configuration ``cfg``: seeded weights on ``device`` (None = the
    card), the train state with ``opt_cfg`` (the configuration module's
    ``_opt()`` by default) and the train step of the model's loss.  A
    decoder's "model" is its flat parameters (``carry.decoder_params``)."""
    kind = kind_of(arch_id)
    opt_cfg = opt_cfg or module_of(arch_id)._opt()
    if kind in ("lm", "bert4rec"):
        model = carry.decoder_params(
            tf.init_params(cfg, device=device, seed=seed), cfg)
    else:
        model = _MODELS[kind](cfg, device=device, seed=seed)
    state = init_train_state(carry.model_params(model), opt_cfg)
    step = make_train_step(loss_for(kind, model, cfg), opt_cfg)
    return {"model": model, "state": state, "kind": kind, "opt": opt_cfg,
            "step": step}


def smoke(arch_id: str, device=None, seed: int = 0) -> dict:
    """``train`` at the smoke configuration, with the smoke batch
    (numpy) under ``"batch"`` and the family under ``"family"``."""
    kind = kind_of(arch_id)
    cfg = smoke_cfg(arch_id)
    opt = module_of(arch_id)._opt()
    if kind == "lm":    # the JAX LM smoke's short schedule
        opt = dataclasses.replace(opt, warmup_steps=2, total_steps=10)
    out = train(arch_id, cfg, device=device, seed=seed, opt_cfg=opt)
    return {**out, "family": FAMILIES[arch_id], "cfg": cfg,
            "batch": smoke_batch(kind, cfg)}
