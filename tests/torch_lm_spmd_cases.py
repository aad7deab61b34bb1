"""SPMD cases of the port's decoders on the CPU: the five LMs and BERT4Rec
on gloo process groups of several ranks (one process a rank), rank 0
writing what it found.  Not a test module: ``tests/test_torch_lm_mesh.py``
runs

    python tests/torch_lm_spmd_cases.py CASE WORLD DIR [ARCH]

in a subprocess with a time limit, so that a hung collective fails one
test and not the suite.  The ranks start with
``torch.multiprocessing.spawn`` and meet through a ``FileStore`` under
DIR; they import neither ``jax`` nor ``repro``.  The parameters the test
drew with the JAX initialisers are read from ``DIR/params/<arch>.npz``
(the JAX tree's paths, which are the port's flat train-state keys), each
cell's results go to ``DIR/<arch>|<shape>.npz`` (``plain/...`` and
``dist/...``) and the case's findings to ``DIR/result.json``.

Every cell runs at its architecture's smoke width and at the smoke sizes
of ``SMOKE_SHAPES`` (``configs.common.LM_SHAPES`` and ``CELL_ROWS`` are
the published ones); the lowering is the port's ``lm_arch`` or
``recsys_arch`` of the smoke configuration, with ``MODEL_OPT``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
LM_IDS = ("deepseek-v3-671b", "arctic-480b", "glm4-9b", "yi-34b",
          "granite-3-8b")
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# GLM-4 and Granite train without FSDP (their modules' ``get()``).
NO_FSDP = ("glm4-9b", "granite-3-8b")
FSDP_ARCHS = ("yi-34b", "deepseek-v3-671b", "arctic-480b")
# The LM cells' sizes at smoke scale (seq: the cache's S for a decode,
# the prefill's max_seq); a prefill's prompt is PROMPT tokens.  A train
# batch of 16 rows is 8 microbatches of 2, one row a data rank.
SMOKE_SHAPES = {
    "train_4k": dict(seq=8, batch=16, kind="train"),
    "prefill_32k": dict(seq=8, batch=4, kind="prefill"),
    "decode_32k": dict(seq=64, batch=4, kind="decode"),
    "long_500k": dict(seq=64, batch=1, kind="decode"),
}
PROMPT = 6
BERT_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
BERT_ROWS = {"train_batch": 8, "serve_p99": 4, "serve_bulk": 8,
             "retrieval_cand": 1}
BERT_SEQ = 16
# The train cells' optimizer: AdamW with a short warmup, so one step
# moves every parameter well off its start, and an ``eps`` of 1e-3.
# AdamW's first update is lr·g / (|g| + eps): with the default 1e-8 an
# element whose gradient is ~1e-9 (an expert few tokens reach) moves by
# lr·O(1) on a change of its gradient in the last float32 bits, so two
# runs that sum the same gradient in another order land 1e-5 apart;
# with 1e-3 each parameter moves in proportion to its gradient, and
# the parameters compare at the gradients' own precision.
MODEL_OPT = dict(kind="adamw", lr=1e-3, eps=1e-3, warmup_steps=2,
                 total_steps=10)
MODEL_WORLD = 4
# The production mesh's sizes at smoke scale: each train microbatch one
# row a data rank, caches whose S splits over "model" (16) and over
# ("data", "model") (256).
PRODUCTION_SHAPES = {
    "train_4k": dict(seq=8, batch=128, kind="train"),
    "prefill_32k": dict(seq=32, batch=16, kind="prefill"),
    "decode_32k": dict(seq=32, batch=16, kind="decode"),
    "long_500k": dict(seq=256, batch=1, kind="decode"),
}
PRODUCTION_BERT_ROWS = {"train_batch": 16, "serve_p99": 16,
                        "serve_bulk": 16, "retrieval_cand": 1}


def lm_batch(cfg, shape: str, sizes: dict | None = None) -> dict:
    """A numpy batch of an LM cell, drawn from the seed: a train cell's
    tokens and labels, a prefill's prompt, a decode's caches (normal
    values, one dict a layer group), token and position."""
    from repro_torch.models import transformer as tf

    info = (sizes or SMOKE_SHAPES)[shape]
    b, s = info["batch"], info["seq"]
    rng = np.random.default_rng(SEED)
    if info["kind"] == "train":
        toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        return {"batch": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
    if info["kind"] == "prefill":
        return {"tokens": rng.integers(0, cfg.vocab, (b, min(PROMPT, s)))
                .astype(np.int32)}
    caches = [{k: rng.normal(size=tuple(v.shape)).astype(np.float32)
               for k, v in group.items()}
              for group in tf.init_cache(cfg, b, s, device="meta")]
    return {"caches": caches,
            "token": rng.integers(0, cfg.vocab, b).astype(np.int32),
            "position": rng.integers(0, s, b).astype(np.int32)}


def bert_batch(cfg, shape: str, rows: dict | None = None) -> dict:
    """A numpy batch of a BERT4Rec cell: items, and for training the
    cloze labels and a mask with a few positions off."""
    rng = np.random.default_rng(SEED)
    b = (rows or BERT_ROWS)[shape]
    items = rng.integers(0, cfg.vocab - 2, (b, BERT_SEQ)).astype(np.int32)
    if shape == "retrieval_cand":
        return {"items": items}
    out = {"batch": {"items": items}}
    if shape == "train_batch":
        out["batch"]["labels"] = rng.integers(0, cfg.vocab - 2,
                                              (b, BERT_SEQ)).astype(np.int32)
        out["batch"]["mask"] = (rng.random((b, BERT_SEQ)) < 0.7).astype(
            np.float32)
    return out


def arch_of(arch_id: str, sizes: dict | None = None):
    """(the port's ``ArchDef`` of ``arch_id``'s smoke configuration with
    ``MODEL_OPT``, that configuration); the LM shapes' sizes set to
    ``sizes`` (``SMOKE_SHAPES``) in ``configs.common``."""
    from repro_torch.configs import common
    from repro_torch.configs import train as tc
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = tc.module_of(arch_id)._smoke()
    opt = OptimizerConfig(**MODEL_OPT)
    if arch_id == "bert4rec":
        return common.recsys_arch(arch_id, "bert4rec", cfg, cfg, opt), cfg
    common.LM_SHAPES.update(copy.deepcopy(sizes or SMOKE_SHAPES))
    return common.lm_arch(arch_id, cfg, cfg, opt,
                          fsdp=arch_id not in NO_FSDP), cfg


def cell_args(arch_id: str, cfg, shape: str, sizes=None, rows=None):
    """The numpy arguments of a cell's ``fn`` after its parameters or
    state, in order."""
    if arch_id == "bert4rec":
        b = bert_batch(cfg, shape, rows)
        return (b["items"],) if "items" in b else (b["batch"],)
    b = lm_batch(cfg, shape, sizes)
    if "caches" in b:
        return (b["caches"], b["token"], b["position"])
    return (b["batch"],) if "batch" in b else (b["tokens"],)


def load_params(d: Path, arch_id: str) -> dict:
    """The flat parameters the test saved (JAX paths) as CPU tensors."""
    arrays = np.load(d / "params" / f"{arch_id}.npz")
    return {k: torch.from_numpy(arrays[k]) for k in arrays.files}


def seeded_params(arch_id: str, cfg) -> dict:
    """The port's own seeded smoke parameters, flat."""
    from repro_torch import carry
    from repro_torch.models import transformer as tf

    return carry.decoder_params(tf.init_params(cfg, device="cpu",
                                               seed=SEED), cfg)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _full(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _flat(prefix: str, tree) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(f"{prefix}/{k}", v))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(f"{prefix}/{i}", v))
        return out
    return {prefix: _full(tree)}


def results(low, out) -> dict:
    """A cell's result as {name: numpy}: a train cell's parameters after
    the step, AdamW's first moment, loss and ``grad_norm``; a prefill's
    and decode's logits and caches; a serving cell's output."""
    if low.kind == "train":
        new, metrics = out
        res = _flat("params", new["params"])
        res.update(_flat("m", new["opt"]["m"]))
        res["loss"] = _full(metrics["loss"])
        res["grad_norm"] = _full(metrics["grad_norm"])
        return res
    if low.kind in ("prefill", "decode"):
        logits, caches = out
        return {"out": _full(logits), **_flat("caches", caches)}
    return {"out": _full(out)}


def run_cell(low, params: dict, args: tuple, mesh, specs=None,
             mesh_hooks=contextlib.nullcontext, launches: dict | None = None
             ) -> tuple[dict, dict, tuple]:
    """``low.fn`` on ``params`` (for a train cell, a fresh AdamW state of
    them) and ``args`` (numpy trees), on plain tensors and then as
    ``DTensor`` tensors under ``specs`` (``low.in_specs``) on ``mesh``,
    each from its own copy: the two ``results`` and the mesh run's
    output.  ``mesh_hooks()`` is entered around the mesh run only; with
    ``launches``, each run's kernel launches."""
    from repro_torch import carry
    from repro_torch.distributed.context import mesh_context
    from repro_torch.kernels import LAUNCHES
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_state import init_train_state

    specs = specs or low.in_specs

    def fresh():
        p = {k: v.detach().clone() for k, v in params.items()}
        head = init_train_state(p, OptimizerConfig(**MODEL_OPT)) \
            if low.kind == "train" else p
        return (head,) + tuple(_to_torch(a) for a in args)

    out = []
    for run in ("plain", "mesh"):
        run_args = fresh()
        ctx = contextlib.nullcontext()
        hooks = contextlib.nullcontext()
        if run == "mesh":
            run_args = tuple(carry.distribute_state(a, mesh, s)
                             for a, s in zip(run_args, specs))
            ctx, hooks = mesh_context(mesh), mesh_hooks()
        before = dict(LAUNCHES)
        with ctx, hooks:
            got = low.fn(*run_args)
        if launches is not None:
            launches[run] = {k: v - before.get(k, 0)
                             for k, v in LAUNCHES.items()
                             if v != before.get(k, 0)}
        out.append((results(low, got), got, run_args))
    return out[0][0], out[1][0], (out[1][1], out[1][2])


def _write(d: Path, rank: int, name: str, plain: dict, dist_: dict) -> None:
    if rank == 0:
        np.savez(d / f"{name}.npz", **{f"plain/{k}": v
                                       for k, v in plain.items()},
                 **{f"dist/{k}": v for k, v in dist_.items()})


# -- what each rank holds and moves -------------------------------------------
class Seen:
    """While entered: the table rows each B1 call is handed (its plain
    version), the vocabulary columns of each cross-entropy's logits and
    of each tied cross-entropy's table (local), the experts of each
    grouped GEMM, and the global shape of every tensor ``DTensor``
    redistributes between placements."""

    def __init__(self):
        self.b1, self.ce_cols, self.tied_rows, self.experts = [], [], [], []
        self.moved = []

    @contextlib.contextmanager
    def __call__(self):
        from torch.distributed.tensor import _api, _dispatch, _redistribute

        from repro_torch.kernels.gather import ref
        from repro_torch.models import layers, moe

        real_rows = ref.gather_rows
        real_nll, real_tied = layers._NLL, layers._TiedChunkedNLL
        real_routed = moe._routed
        real_redist = _redistribute.redistribute_local_tensor

        def rows(table, ids):
            self.b1.append(int(table.shape[0]))
            return real_rows(table, ids)

        class NLL:
            @staticmethod
            def apply(logits, *rest):
                self.ce_cols.append(int(logits.shape[-1]))
                return real_nll.apply(logits, *rest)

        class Tied:
            @staticmethod
            def apply(h, table, *rest):
                self.tied_rows.append(int(table.shape[0]))
                return real_tied.apply(h, table, *rest)

        def routed(router, w_gate, *rest):
            self.experts.append(int(w_gate.shape[0]))
            return real_routed(router, w_gate, *rest)

        def redist(local, current, target, *a, **kw):
            if tuple(current.placements) != tuple(target.placements):
                self.moved.append(tuple(current.shape))
            return real_redist(local, current, target, *a, **kw)

        mods = (_api, _dispatch, _redistribute)
        try:
            ref.gather_rows = rows
            layers._NLL, layers._TiedChunkedNLL = NLL, Tied
            moe._routed = routed
            for m in mods:
                m.redistribute_local_tensor = redist
            yield self
        finally:
            ref.gather_rows = real_rows
            layers._NLL, layers._TiedChunkedNLL = real_nll, real_tied
            moe._routed = real_routed
            for m in mods:
                m.redistribute_local_tensor = real_redist


def _gathered(per_rank: list) -> list:
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, per_rank)
    return everyone


# -- the cases --------------------------------------------------------------
def case_lm_cells(rank: int, world: int, d: Path, arch_id: str,
                  *shapes: str) -> dict:
    """Cells of one LM (``shapes``, by default all four) on the (2, 2)
    mesh and on plain tensors (``DIR/<arch>|<shape>.npz``), and what each
    rank held and moved on the mesh: B1's table rows, the
    cross-entropy's and the head's vocabulary columns, the grouped
    GEMMs' experts, and the shapes ``DTensor`` redistributed during each
    decode beside the caches'."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=2, model=2)
    arch, cfg = arch_of(arch_id)
    params = load_params(d, arch_id)
    out = {}
    for shape in shapes or LM_SHAPES:
        low = arch.lowering(shape, mesh)
        seen = Seen()
        launches: dict = {}
        plain, on_mesh, (got, placed) = run_cell(
            low, params, cell_args(arch_id, cfg, shape), mesh,
            mesh_hooks=seen, launches=launches)
        _write(d, rank, f"{arch_id}|{shape}", plain, on_mesh)
        rec = {"b1": sorted(set(seen.b1)), "ce_cols": sorted(set(
            seen.ce_cols)), "experts": sorted(set(seen.experts)),
            "launches": launches}
        if low.kind in ("prefill", "decode"):
            logits, caches = got
            rec["logits_local"] = list(logits.to_local().shape)
            rec["cache_local"] = [[list(t.to_local().shape)
                                   for t in g.values()] for g in caches]
        if low.kind == "decode":
            shapes = {tuple(t.shape) for g in placed[1] for t in g.values()}
            shapes |= {s[1:] for s in shapes}
            rec["moved_cache"] = sorted({str(s) for s in seen.moved
                                         if s in shapes})
            rec["n_moved"] = len(seen.moved)
        out[shape] = _gathered(rec)
    return out


def _fsdp_specs(low, mesh) -> tuple:
    """``low.in_specs`` with the data axis added on the first open dim of
    every weight of two or more dims, whatever its size
    (``add_data_axis(..., min_size=1)``), so that a smoke model's weights
    are FSDP-sharded; as ``fsdp_rules`` places them, the embedding table
    is exempt and a group's stacked layer dim is not a weight's (its
    extent, 3, 58, 60 or 35 layers at published size, never divides the
    data axes), and AdamW's moments follow their parameters."""
    from repro_torch.distributed import sharding as shd

    data = dict(zip(mesh.axis_names, mesh.axis_sizes))["data"]
    sspecs, bspecs = low.in_specs
    shapes = {k: tuple(v.shape) for k, v in low.args[0]["params"].items()}

    def add(path, spec):
        shape = shapes[path]
        if "embed" in path.split("/"):
            return spec
        if path.startswith("groups/"):
            inner = shd.add_data_axis(shd.P(*spec[1:]), shape[1:],
                                      min_size=1, data_size=data)
            return shd.P(spec[0], *inner)
        return shd.add_data_axis(spec, shape, min_size=1, data_size=data)

    params = {k: add(k, v) for k, v in sspecs["params"].items()}
    opt = {**sspecs["opt"], "m": params, "v": params}
    return ({"params": params, "opt": opt}, bspecs)


def case_lm_fsdp(rank: int, world: int, d: Path, arch_id: str) -> dict:
    """One train step of an FSDP architecture on the (2, 2) mesh with
    "data" on every parameter of two or more dims (``_fsdp_specs``)
    against the plain step (``DIR/<arch>|fsdp.npz``), and each rank's
    parameters' placements and local shapes before and after."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=2, model=2)
    arch, cfg = arch_of(arch_id)
    low = arch.lowering("train_4k", mesh)
    specs = _fsdp_specs(low, mesh)
    plain, on_mesh, (got, placed) = run_cell(
        low, load_params(d, arch_id), cell_args(arch_id, cfg, "train_4k"),
        mesh, specs=specs)
    _write(d, rank, f"{arch_id}|fsdp", plain, on_mesh)
    data_sharded = sorted(
        k for k, s in shd.sanitize_specs(specs[0]["params"],
                                         low.args[0]["params"], mesh).items()
        if "data" in [a for e in s for a in shd.entry_axes(e)])
    new = got[0]["params"]
    want = shd.named(mesh, shd.sanitize_specs(specs[0]["params"],
                                              low.args[0]["params"], mesh))
    return {"data_sharded": data_sharded,
            "want": {k: str(tuple(want[k].placements))
                     for k in data_sharded},
            "layout": _gathered({k: [str(tuple(new[k].placements)),
                                     list(new[k].to_local().shape)]
                                 for k in data_sharded})}


def case_bert4rec_cells(rank: int, world: int, d: Path) -> dict:
    """Every BERT4Rec cell on the (2, 2) mesh and on plain tensors, and
    what each rank's B1 calls, scores and tied cross-entropy held."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=2, model=2)
    arch, cfg = arch_of("bert4rec")
    params = load_params(d, "bert4rec")
    out = {}
    for shape in BERT_SHAPES:
        low = arch.lowering(shape, mesh)
        seen = Seen()
        plain, on_mesh, (got, _) = run_cell(
            low, params, cell_args("bert4rec", cfg, shape), mesh,
            mesh_hooks=seen)
        _write(d, rank, f"bert4rec|{shape}", plain, on_mesh)
        rec = {"b1": sorted(set(seen.b1)),
               "tied_rows": sorted(set(seen.tied_rows))}
        if low.kind == "serve":
            rec["scores_local"] = list(got.to_local().shape)
        out[shape] = _gathered(rec)
    return out


def case_uneven_heads(rank: int, world: int, d: Path, arch_id: str
                      ) -> dict:
    """GLM-4 (2 KV heads) or Yi (7 heads, 1 KV head) on a (1, 4) mesh,
    where its heads do not split over "model": every cell against the
    plain run (``DIR/<arch>|<shape>|1x4.npz``)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=1, model=4)
    arch, cfg = arch_of(arch_id)
    params = load_params(d, arch_id)
    for shape in LM_SHAPES:
        plain, on_mesh, _ = run_cell(arch.lowering(shape, mesh), params,
                                     cell_args(arch_id, cfg, shape), mesh)
        _write(d, rank, f"{arch_id}|{shape}|1x4", plain, on_mesh)
    return {"arch": arch_id}


# (rows, seq, n_groups) of the MoE capacity cases on the (2, 2) mesh:
# groups on the data shards; groups that straddle them (3 rows split 2,
# 1); and t % g != 0 (the one-group fallback).
MOE_CASES = {"aligned": (4, 6, 4), "straddling": (3, 4, 4),
             "fallback": (4, 5, 3)}


def case_moe_capacity(rank: int, world: int, d: Path) -> dict:
    """``moe_ffn`` of Arctic's smoke MoE (capacity 2.0 made 0.5, so slots
    drop) at ``MOE_CASES`` on the (2, 2) mesh against the plain run: the
    outputs, the aux loss, the gradient of both with respect to the
    input and to the router, and each path's kept slots (a hook on
    ``moe.route``)."""
    import dataclasses

    from repro_torch.configs import train as tc
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import mesh_context
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    mesh = make_host_mesh(data=2, model=2)
    out = {}
    for name, (b, s, groups) in MOE_CASES.items():
        cfg = dataclasses.replace(tc.module_of("arctic-480b")._smoke().moe,
                                  n_groups=groups, capacity_factor=0.5)
        gen = torch.Generator().manual_seed(SEED)
        params = moe.moe_init(cfg, generator=gen, device=torch.device("cpu"),
                              dtype=torch.float32)
        x = torch.randn(b, s, cfg.d_model, generator=gen)
        specs = shd.param_specs({"moe": params}, shd.lm_rules)["moe"]
        res, kept = {}, {}
        for run in ("plain", "mesh"):
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            xi = x.clone().requires_grad_(True)
            args = (p, xi)
            real = moe.route
            kept[run] = []

            def route(logits, c, dropless, real=real, run=run):
                r = real(logits, c, dropless)
                kept[run].append(int(r.keep.sum()))
                return r

            moe.route = route
            try:
                if run == "mesh":
                    from repro_torch import carry
                    pd = carry.distribute_state(p, mesh, specs)
                    xd = carry.distribute_state(xi, mesh,
                                                shd.P("data", None, None))
                    with mesh_context(mesh):
                        y, aux = moe.moe_ffn(pd, cfg, xd)
                        (y.square().mean() + aux).backward()
                    res[run] = {"y": _full(y), "aux": _full(aux),
                                "dx": _full(xd.grad),
                                "drouter": _full(pd["router"].grad),
                                "dw_up": _full(pd["w_up"].grad)}
                else:
                    y, aux = moe.moe_ffn(*args[:1], cfg, args[1])
                    (y.square().mean() + aux).backward()
                    res[run] = {"y": _full(y), "aux": _full(aux),
                                "dx": _full(xi.grad),
                                "drouter": _full(p["router"].grad),
                                "dw_up": _full(p["w_up"].grad)}
            finally:
                moe.route = real
        _write(d, rank, f"moe|{name}", res["plain"], res["mesh"])
        out[name] = {"plain_kept": kept["plain"],
                     "mesh_kept": _gathered(kept["mesh"])}
    return out


ONE_RANK_CELLS = tuple((a, s) for a in LM_IDS for s in LM_SHAPES) + \
    tuple(("bert4rec", s) for s in BERT_SHAPES)


def case_one_rank_lm(rank: int, world: int, d: Path, arch_id: str
                     ) -> dict:
    """Every cell of one LM or of BERT4Rec (seeded smoke weights) on a
    (1, 1) mesh of one rank and on plain tensors: the cells whose
    results differ in any bit (a mesh of one reduces nothing)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=1, model=1)
    differ = {}
    cells = [c for c in ONE_RANK_CELLS if c[0] == arch_id]
    for arch_id, shape in cells:
        arch, cfg = arch_of(arch_id)
        plain, on_mesh, _ = run_cell(arch.lowering(shape, mesh),
                                     seeded_params(arch_id, cfg),
                                     cell_args(arch_id, cfg, shape), mesh)
        bad = sorted(k for k in plain
                     if plain[k].tobytes() != on_mesh[k].tobytes())
        if bad:
            differ[f"{arch_id}|{shape}"] = bad
    return {"cells": [f"{a}|{s}" for a, s in cells], "differ": differ}


def case_production_lm(rank: int, world: int, d: Path) -> dict:
    """Every LM and BERT4Rec cell's ``fn`` at smoke width on the JAX
    production mesh (16, 16), as rank 0 of a fake process group of 256
    (collectives move nothing, so no value is checked): each cell's
    batch padded to the data extent (``PRODUCTION_SHAPES``), the
    arguments placed by the cell's sanitized specs.  Each result's
    global shapes against the plain run's, by cell."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import carry
    from repro_torch.distributed.context import mesh_context
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_state import init_train_state

    sizes = make_production_mesh().axis_sizes
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(sizes)))
    out = {}
    try:
        mesh = make_host_mesh(*sizes)
        for arch_id, shape in ONE_RANK_CELLS:
            arch, cfg = arch_of(arch_id, PRODUCTION_SHAPES)
            low = arch.lowering(shape, mesh)
            params = seeded_params(arch_id, cfg)
            head = init_train_state(params, OptimizerConfig(**MODEL_OPT)) \
                if low.kind == "train" else params
            args = (head,) + tuple(_to_torch(a) for a in cell_args(
                arch_id, cfg, shape, PRODUCTION_SHAPES,
                PRODUCTION_BERT_ROWS))
            shapes = []
            for run in ("plain", "mesh"):
                run_args = copy.deepcopy(args)
                ctx = contextlib.nullcontext()
                if run == "mesh":
                    run_args = tuple(carry.distribute_state(a, mesh, s)
                                     for a, s in zip(run_args,
                                                     low.in_specs))
                    ctx = mesh_context(mesh)
                with ctx:
                    got = low.fn(*run_args)
                shapes.append(_shapes(got))
            out[f"{arch_id}|{shape}"] = shapes[0] == shapes[1]
    finally:
        dist.destroy_process_group()
    return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return list(tree.shape) if isinstance(tree, torch.Tensor) else tree


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
# Cases that set up their own process groups.
OWN_GROUPS = ("production_lm",)


def _rank(rank: int, case: str, world: int, d: str, extra: tuple) -> None:
    torch.set_num_threads(1)
    if case in OWN_GROUPS:
        result = CASES[case](rank, world, Path(d), *extra)
        (Path(d) / "result.json").write_text(json.dumps(result))
        return
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        result = CASES[case](rank, world, Path(d), *extra)
        dist.barrier()
        if rank == 0:
            (Path(d) / "result.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    """Run the case; add to its result the seconds from here to its
    ranks' end."""
    import time

    start = time.monotonic()
    case, world, d, *extra = argv
    torch.multiprocessing.spawn(_rank, args=(case, int(world), d,
                                             tuple(extra)),
                                nprocs=int(world), join=True)
    path = Path(d) / "result.json"
    result = json.loads(path.read_text())
    result["seconds"] = time.monotonic() - start
    path.write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
