"""Architecture definitions of the port: the shapes each model is served
and trained at, and for every (architecture × shape) cell its lowering:
the arguments of the function the cell runs as ``meta`` tensors and their
PartitionSpec trees, the JAX package's ``configs/common.py`` over the
port's models.

``lowering(shape, mesh)`` gives the cell's kind (the train step, the
prefill, the decode step or the serving forward), that function's
arguments in the JAX lowering's tree with its shapes and dtypes (nothing
allocated), and the spec trees of those arguments, the JAX lowering's
own: what the dry run (``launch.dryrun``) reads.

``fn`` is the cell's function and ``donate`` the arguments it updates in
place, the JAX lowering's, for all 40 cells: the train step ``fn(state,
batch)`` (``donate=(0,)``: the port's optimizer writes the state in
place; the LMs' with ``accum`` microbatches), the serving forward
``fn(params, batch)`` (two-tower's and BERT4Rec's ``retrieval_cand``:
``fn(params, user_ids, cand_ids)``, ``fn(params, items)``), an LM's
``prefill`` ``fn(params, tokens)`` and its ``decode_step`` ``fn(params,
caches, token, position)`` (``donate=(1,)``: the dense cache written in
place).  A decoder's ``params`` are its flat train-state dict
(``carry.decoder_params``), run through ``carry.decoder_tree``.  ``fn``
takes the ``args`` tree as real tensors or as ``DTensor`` tensors under
``in_specs`` (``carry.distribute_state``; inside
``distributed.context.mesh_context``), and runs the hand-written kernels
B1, B6 and B7 on each rank's own shards: the decoders' token and
position lookups B1 on each rank's vocabulary rows, their heads and
losses on its vocabulary columns, MoE layers on its own experts and the
decode on its own rows of a cache sharded on S.

``probes`` stays None: the JAX package's cost probes exist because XLA's
``cost_analysis`` counts a scan body once; the port's layers run in a
Python loop and no whole-program cost is read.

Three families: "lm" (5 transformer archs × train/prefill/decode/500k),
"gnn" (NequIP × 4 graph regimes), "recsys" (4 archs × 4 serving
regimes).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch import nn

from .. import carry
from ..distributed import sharding as shd
from ..distributed.sharding import PartitionSpec as P
from ..kernels._casting import is_fake
from ..models import nequip as nq
from ..models import recsys as rs
from ..models import transformer as tf
from ..train.optimizer import OptimizerConfig, make_optimizer
from ..train.train_state import make_train_step
from . import train as train_cfgs

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

LM_ACCUM = 8   # gradient-accumulation microbatches of the train shape

RECSYS_SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    # 10⁶ candidates padded to 2²⁰ so the candidate axis shards evenly
    "retrieval_cand": dict(batch=1, n_cand=1_048_576, kind="retrieval"),
}

# Graph shapes NequIP is served at.  Extents are padded up to multiples
# of 512, as the JAX package pads them for its device count; the
# samplers pad with masked nodes and edges.  Real sizes in comments.
GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=3072, n_edges=10752, d_feat=1433,
                          n_out=7, readout="node_class"),
    # real: 2708 nodes / 10556 edges (Cora)
    "minibatch_lg": dict(n_nodes=169_984, n_edges=168_960, d_feat=602,
                         n_out=41, readout="node_class", sampled=True),
    # sampled subgraph of Reddit (232 965 / 114 615 892): 1024 seeds,
    # fanout 15-10 → 1024+15 360+153 600 nodes, 168 960 edges (exact)
    "ogb_products": dict(n_nodes=2_449_408, n_edges=61_859_840,
                         d_feat=100, n_out=47, readout="node_class"),
    # real: 2 449 029 nodes / 61 859 140 edges
    "molecule": dict(n_nodes=4096, n_edges=8192, d_feat=16,
                     n_out=1, readout="energy", n_graphs=128,
                     forces=True),
    # real: 128 graphs × 30 nodes / 64 edges = 3840 / 8192
}


@dataclass
class Lowering:
    fn: Callable                # the step, forward, prefill or decode
    args: tuple                 # meta tensors, in the JAX lowering's tree
    in_specs: tuple             # matching PartitionSpec trees
    donate: tuple = ()          # arguments ``fn`` updates in place
    kind: str = "train"         # train | prefill | decode | serve


@dataclass
class ArchDef:
    arch_id: str
    family: str                 # lm | gnn | recsys
    shapes: tuple[str, ...]
    lowering: Callable[[str, Any], Lowering]
    smoke: Callable[..., dict]  # configs.train.smoke of the architecture
    describe: Callable[[], dict]
    probes: Callable[[str, Any], dict] | None = None
    correction: Callable[[], dict] | None = None


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """An abstract argument: a ``meta`` tensor of ``shape``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def dp(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)


def _opt_specs(opt_kind: str, params: dict, pspecs: dict) -> dict:
    """Spec tree for the optimizer state, mirroring its structure."""
    if opt_kind == "adamw":
        mv = shd.opt_state_specs(pspecs, params)
        return {"m": mv, "v": mv, "step": P()}

    # adafactor: vr drops the last dim, vc the second-to-last
    def fspec(spec, leaf):
        shape = tuple(leaf.shape)
        spec = shd.add_data_axis(spec, shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        if len(shape) >= 2:
            return {"vr": P(*dims[:-1]), "vc": P(*dims[:-2], dims[-1])}
        return {"v": P(*dims)}

    return {"f": shd.tree_map(fspec, pspecs, params), "step": P()}


def _abstract_opt(opt_cfg: OptimizerConfig, params: dict) -> dict:
    opt_init, _ = make_optimizer(opt_cfg)
    return opt_init(params)


def _train_lowering(params: dict, pspecs: dict, opt_cfg: OptimizerConfig,
                    batch: dict, bspecs: dict, step: Callable) -> Lowering:
    """The train step's lowering: ``step(state, batch)`` over
    ``({"params", "opt"}, batch)``, the state donated (updated in
    place)."""
    state = {"params": params, "opt": _abstract_opt(opt_cfg, params)}
    sspecs = {"params": pspecs,
              "opt": _opt_specs(opt_cfg.kind, params, pspecs)}
    return Lowering(step, (state, batch), (sspecs, bspecs), donate=(0,),
                    kind="train")


def _bind(module: nn.Module, tensors: dict) -> None:
    """Rebind ``module``'s parameters and buffers named in ``tensors``
    (dotted names) to those tensors themselves, as plain attributes."""
    for name, t in tensors.items():
        owner, _, attr = name.rpartition(".")
        mod = module.get_submodule(owner)
        mod._parameters.pop(attr, None)
        mod._buffers.pop(attr, None)
        setattr(mod, attr, t)


def model_fn(cls, cfg, body: Callable) -> Callable:
    """``f(params, *args) = body(model, *args)``, ``model`` a ``cls(cfg)``
    that holds ``params`` (keyed by the JAX paths, ``carry.model_params``;
    plain tensors or ``DTensor`` tensors) and its constant buffers
    (``cls.buffers_for``) on their device, replicated on their mesh
    (fake where the parameters are: the dry run's trace).  No
    model is allocated: a ``meta`` skeleton's parameters are rebound to
    the given tensors at each call, so gradients reach them, and stay
    bound after it, where a recomputing backward (``remat``) reads
    them."""
    model = cls(cfg, device="meta")
    names = {carry.jax_path(model, n): n for n, _ in model.named_parameters()}
    make_buffers = getattr(cls, "buffers_for", None)
    cache: dict = {}

    def f(params: dict, *args):
        some = next(iter(params.values()))
        key = (str(some.device), id(getattr(some, "device_mesh", None)),
               is_fake(some))
        if key not in cache:
            cache.clear()
            cache[key] = {} if make_buffers is None else {
                k: shd.replicate_like(v, some)
                for k, v in make_buffers(cfg, some.device).items()}
        _bind(model, {**{names[k]: v for k, v in params.items()},
                      **cache[key]})
        return body(model, *args)

    return f


def _serving(fn: Callable) -> Callable:
    """``fn`` run under ``torch.no_grad()``, as the port serves."""
    def serve(*args):
        with torch.no_grad():
            return fn(*args)
    return serve


# =====================================================================
# LM family
# =====================================================================
def _decoder_params(cfg: tf.TransformerConfig) -> dict:
    """A decoder's train-state parameters (flat, groups stacked) on
    ``meta``."""
    return carry.decoder_params(tf.init_params(cfg, device="meta"), cfg)


def cut_layers(cfg: tf.TransformerConfig,
               layers: int | None) -> tf.TransformerConfig:
    """``cfg`` with each of its layer groups (``layer_groups``: a
    decoder's leading dense layers, then its MoE layers) cut to at most
    ``layers`` layers; ``None`` keeps it whole.  The dry run's trace of
    a cut decoder (``launch.dryrun --layers``)."""
    if layers is None:
        return cfg
    groups = cfg.layer_groups()
    dense = min(cfg.n_dense_layers, layers) if len(groups) == 2 else \
        cfg.n_dense_layers
    return dataclasses.replace(
        cfg, n_layers=sum(min(n, layers) for n, _ in groups),
        n_dense_layers=dense)


def lm_arch(arch_id: str, cfg: tf.TransformerConfig,
            smoke_cfg: tf.TransformerConfig, opt_cfg: OptimizerConfig,
            fsdp: bool = True, accum: int = LM_ACCUM) -> ArchDef:
    rules = shd.fsdp_rules(shd.lm_rules) if fsdp else shd.lm_rules

    def lowering(shape: str, mesh) -> Lowering:
        info = LM_SHAPES[shape]
        b, s = info["batch"], info["seq"]
        dpa = dp(mesh)
        params = _decoder_params(cfg)
        pspecs = shd.param_specs(params, rules)

        if info["kind"] == "train":
            batch = {"tokens": _sds((b, s), torch.int32),
                     "labels": _sds((b, s), torch.int32)}
            bspecs = {"tokens": P(dpa, None), "labels": P(dpa, None)}
            step = make_train_step(train_cfgs.loss_for("lm", None, cfg),
                                   opt_cfg, accum_steps=accum)
            return _train_lowering(params, pspecs, opt_cfg, batch, bspecs,
                                   step)

        if info["kind"] == "prefill":
            def prefill(flat, tokens):
                return tf.prefill(carry.decoder_tree(flat, cfg), cfg,
                                  tokens, max_seq=s)

            return Lowering(_serving(prefill),
                            (params, _sds((b, s), torch.int32)),
                            (pspecs, P(dpa, None)), kind="prefill")

        # decode: one new token against an S-token cache, updated in place
        caches = tf.init_cache(cfg, b, s, device="meta")
        cspecs = tf.cache_specs(cfg, b, mesh.axis_names)
        tspec = P(dpa) if b > 1 else P()

        def decode(flat, caches, token, position):
            return tf.decode_step(carry.decoder_tree(flat, cfg), cfg,
                                  caches, token, position)

        return Lowering(_serving(decode),
                        (params, caches, _sds((b,), torch.int32),
                         _sds((b,), torch.int32)),
                        (pspecs, cspecs, tspec, tspec), donate=(1,),
                        kind="decode")

    def correction() -> dict:
        groups = cfg.layer_groups()
        return {"groups": [n for n, _ in groups],
                "two_groups": len(groups) > 1,
                "accum": accum, "opt_kind": opt_cfg.kind,
                "n_params": tf.count_params(
                    tf.init_params(cfg, device="meta"))}

    def describe() -> dict:
        return {"arch": arch_id, "family": "lm",
                "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                "vocab": cfg.vocab, "moe": cfg.moe is not None}

    return ArchDef(arch_id, "lm", tuple(LM_SHAPES), lowering,
                   functools.partial(train_cfgs.smoke, arch_id), describe,
                   correction=correction)


# =====================================================================
# GNN family (NequIP)
# =====================================================================
def gnn_arch(arch_id: str, base: nq.NequIPConfig,
             smoke_base: nq.NequIPConfig,
             opt_cfg: OptimizerConfig) -> ArchDef:
    def lowering(shape: str, mesh) -> Lowering:
        info = GNN_SHAPES[shape]
        cfg = dataclasses.replace(base, d_feat=info["d_feat"],
                                  n_out=info["n_out"],
                                  readout=info["readout"])
        n, e = info["n_nodes"], info["n_edges"]
        axes = all_axes(mesh)
        params = carry.model_params(nq.NequIP(cfg, device="meta"))
        pspecs = shd.param_specs(params, shd.gnn_rules)
        f32, i32 = torch.float32, torch.int32
        batch = {"node_feat": _sds((n, info["d_feat"]), f32),
                 "positions": _sds((n, 3), f32),
                 "edge_index": _sds((2, e), i32)}
        bspecs = {"node_feat": P(axes, None), "positions": P(axes, None),
                  "edge_index": P(None, axes)}
        if info["readout"] == "node_class":
            batch["labels"] = _sds((n,), i32)
            batch["label_mask"] = _sds((n,), f32)
            bspecs["labels"] = P(axes)
            bspecs["label_mask"] = P(axes)
        else:
            ng = info["n_graphs"]
            batch.update({"graph_ids": _sds((n,), i32),
                          "energy": _sds((ng,), f32),
                          "forces": _sds((n, 3), f32)})
            bspecs.update({"graph_ids": P(axes), "energy": P(),
                           "forces": P(axes, None)})
        # n_graphs is static: closed over, as the JAX step does.
        extra = {} if info["readout"] == "node_class" else \
            {"n_graphs": info["n_graphs"]}
        loss = model_fn(nq.NequIP, cfg, lambda m, bt: nq.nequip_loss(
            m, {**bt, **extra}))
        step = make_train_step(lambda p, bt: (loss(p, bt), {}), opt_cfg)
        return _train_lowering(params, pspecs, opt_cfg, batch, bspecs, step)

    def describe() -> dict:
        return {"arch": arch_id, "family": "gnn",
                "channels": base.channels, "l_max": base.l_max,
                "n_layers": base.n_layers}

    return ArchDef(arch_id, "gnn", tuple(GNN_SHAPES), lowering,
                   functools.partial(train_cfgs.smoke, arch_id), describe)


# =====================================================================
# RecSys family
# =====================================================================
# The serving forward of each recsys model kind on a cell's batch.
_SERVE = {
    "dlrm": lambda m, bt: m(bt["dense"], bt["bags"]),
    "deepfm": lambda m, bt: m(bt["bags"]),
    "twotower": lambda m, bt: m.score_candidates(bt["user_ids"],
                                                 bt["item_ids"]),
}


def recsys_arch(arch_id: str, kind: str, cfg: Any, smoke_cfg: Any,
                opt_cfg: OptimizerConfig) -> ArchDef:
    """kind ∈ {dlrm, deepfm, twotower, bert4rec}."""
    f32, i32 = torch.float32, torch.int32

    def batch_of(b: int) -> dict:
        if kind == "dlrm":
            return {"dense": _sds((b, cfg.n_dense), f32),
                    "bags": _sds((b, cfg.n_sparse, cfg.bag_size), i32)}
        if kind == "deepfm":
            return {"bags": _sds((b, cfg.n_sparse, 1), i32)}
        if kind == "twotower":
            return {"user_ids": _sds((b,), i32),
                    "item_ids": _sds((b,), i32),
                    "item_logq": _sds((b,), f32)}
        return {"items": _sds((b, 200), i32)}

    def lowering(shape: str, mesh) -> Lowering:
        info = RECSYS_SHAPES[shape]
        b = info["batch"]
        dpa = dp(mesh)
        model_cls = train_cfgs._MODELS.get(kind)
        if kind == "bert4rec":
            params = _decoder_params(cfg)
        else:
            params = carry.model_params(model_cls(cfg, device="meta"))
        pspecs = shd.param_specs(params, shd.recsys_rules)

        def batch_specs(batch):
            return shd.tree_map(
                lambda a: P(dpa, *([None] * (a.ndim - 1))), batch)

        if info["kind"] == "train":
            batch = batch_of(b)
            bspecs = batch_specs(batch)
            if kind in ("dlrm", "deepfm"):
                batch["labels"] = _sds((b,), f32)
                bspecs["labels"] = P(dpa)
            if kind == "bert4rec":
                batch["labels"] = _sds((b, 200), i32)
                batch["mask"] = _sds((b, 200), f32)
                bspecs["labels"] = P(dpa, None)
                bspecs["mask"] = P(dpa, None)
                step = make_train_step(train_cfgs.loss_for(
                    "bert4rec", None, cfg), opt_cfg)
                return _train_lowering(params, pspecs, opt_cfg, batch,
                                       bspecs, step)
            loss = model_fn(model_cls, cfg, train_cfgs._LOSSES[kind])
            step = make_train_step(lambda p, bt: (loss(p, bt), {}), opt_cfg)
            return _train_lowering(params, pspecs, opt_cfg, batch, bspecs,
                                   step)

        if info["kind"] == "retrieval":
            if kind == "twotower":
                return Lowering(
                    _serving(model_fn(model_cls, cfg, lambda m, u, c:
                                      m.score_candidates(u, c))),
                    (params, _sds((1,), i32), _sds((info["n_cand"],), i32)),
                    (pspecs, P(), P(tuple(mesh.axis_names))), kind="serve")
            if kind == "bert4rec":
                return Lowering(_serving(lambda flat, items: rs.bert4rec_score(
                                    carry.decoder_tree(flat, cfg), cfg, items)),
                                (params, _sds((1, 200), i32)),
                                (pspecs, P(None, None)), kind="serve")
            # dlrm / deepfm: bulk-score 10⁶ candidate rows for one user
            b = info["n_cand"]
        batch = batch_of(b)
        if kind == "bert4rec":
            fn = _serving(lambda flat, bt: rs.bert4rec_score(
                carry.decoder_tree(flat, cfg), cfg, bt["items"]))
        else:
            fn = _serving(model_fn(model_cls, cfg, _SERVE[kind]))
        return Lowering(fn, (params, batch), (pspecs, batch_specs(batch)),
                        kind="serve")

    def describe() -> dict:
        return {"arch": arch_id, "family": "recsys", "kind": kind}

    return ArchDef(arch_id, "recsys", tuple(RECSYS_SHAPES), lowering,
                   functools.partial(train_cfgs.smoke, arch_id), describe)
