"""Training set-ups of the recsys models: the port of the recsys branch
of the JAX package's ``recsys_arch(...).smoke()`` (its
``configs/common.py``) for DLRM-RM2, DeepFM and two-tower.

``smoke(arch_id)`` builds the smoke configuration's model (seeded
weights on ``device``), its train state with the configuration's
optimizer (``_opt()``), the train step of its loss and the smoke batch
of 8 rows, drawn as the JAX package draws it (``numpy``'s
``default_rng(0)``).  ``train(arch_id, cfg)`` does the same for any
configuration of those models, such as the published ones.  BERT4Rec's,
the LMs' and NequIP's training wait for the next slice (ROADMAP §A,
A10d-2) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

import numpy as np

from .. import carry
from ..models import recsys as rs
from ..train.train_state import init_train_state, make_train_step
from . import _MODULES

# The model kind of each recsys architecture the port trains.
KINDS = {"dlrm-rm2": "dlrm", "deepfm": "deepfm",
         "two-tower-retrieval": "twotower"}
FAMILIES = {"deepseek-v3-671b": "lm", "arctic-480b": "lm",
            "glm4-9b": "lm", "granite-3-8b": "lm", "yi-34b": "lm",
            "nequip": "gnn", "dlrm-rm2": "recsys", "deepfm": "recsys",
            "two-tower-retrieval": "recsys", "bert4rec": "recsys"}
SMOKE_BATCH = 8
_MODELS = {"dlrm": rs.DLRM, "deepfm": rs.DeepFM, "twotower": rs.TwoTower}
_LOSSES = {"dlrm": rs.dlrm_loss, "deepfm": rs.deepfm_loss,
           "twotower": rs.twotower_loss}


def kind_of(arch_id: str) -> str:
    """The model kind of ``arch_id``; ``NotImplementedError`` for an
    architecture whose training is not ported yet."""
    if arch_id not in FAMILIES:
        raise KeyError(f"unknown arch {arch_id!r}")
    if arch_id not in KINDS:
        raise NotImplementedError(
            f"{arch_id} ({FAMILIES[arch_id]}): training is not ported yet "
            f"(ROADMAP §A, A10d-2); the port trains {sorted(KINDS)}")
    return KINDS[arch_id]


def module_of(arch_id: str):
    return importlib.import_module(f"{__package__}.{_MODULES[arch_id]}")


def loss_for(kind: str, model):
    """``loss_fn(params, batch) → (loss, {})`` of ``model``, whose
    parameters are ``params`` (``carry.model_params(model)``)."""
    loss = _LOSSES[kind]
    return lambda params, batch: (loss(model, batch), {})


def smoke_batch(kind: str, cfg) -> dict:
    """The JAX smoke batch of ``SMOKE_BATCH`` rows as numpy arrays."""
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
    return {"user_ids": np.arange(bsz, dtype=np.int32),
            "item_ids": np.arange(bsz, dtype=np.int32),
            "item_logq": np.zeros((bsz,), np.float32)}


def train(arch_id: str, cfg, device=None, seed: int = 0,
          opt_cfg=None) -> dict:
    """``{"model", "state", "step", "kind", "opt"}`` for ``arch_id`` at
    configuration ``cfg``: seeded weights on ``device`` (None = the
    card), the train state with ``opt_cfg`` (the configuration module's
    ``_opt()`` by default) and the train step of the model's loss."""
    kind = kind_of(arch_id)
    opt_cfg = opt_cfg or module_of(arch_id)._opt()
    model = _MODELS[kind](cfg, device=device, seed=seed)
    state = init_train_state(carry.model_params(model), opt_cfg)
    return {"model": model, "state": state, "kind": kind, "opt": opt_cfg,
            "step": make_train_step(loss_for(kind, model), opt_cfg)}


def smoke(arch_id: str, device=None, seed: int = 0) -> dict:
    """``train`` at the smoke configuration, with the smoke batch
    (numpy) under ``"batch"`` and the family under ``"family"``."""
    kind = kind_of(arch_id)
    cfg = module_of(arch_id)._smoke()
    out = train(arch_id, cfg, device=device, seed=seed)
    return {**out, "family": FAMILIES[arch_id], "cfg": cfg,
            "batch": smoke_batch(kind, cfg)}
