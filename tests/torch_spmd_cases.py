"""SPMD cases of the port on the CPU: each runs on a gloo process group
of several ranks (one process a rank) and rank 0 writes what it found as
JSON.  Not a test module: ``tests/test_torch_distributed.py`` runs

    python tests/torch_spmd_cases.py CASE WORLD DIR

in a subprocess with a time limit, so that a hung collective fails one
test and not the suite.  The ranks start with
``torch.multiprocessing.spawn`` and meet through a ``FileStore`` under
DIR (no TCP port is chosen); they import neither ``jax`` nor ``repro``,
and the result is ``DIR/result.json``.  The cases are the port's
counterparts of ``tests/test_distributed.py::TestSPMDExecution``.
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
# The JAX test's linear model: w (16, 8), x (32, 16), y (32, 8).
LINEAR = dict(d_in=16, d_out=8, rows=32)
PSUM_ROWS, PSUM_COLS = 8, 8


def linear_inputs() -> dict:
    rng = np.random.default_rng(SEED)
    return {"w": rng.normal(size=(LINEAR["d_in"], LINEAR["d_out"])),
            "x": rng.normal(size=(LINEAR["rows"], LINEAR["d_in"])),
            "y": rng.normal(size=(LINEAR["rows"], LINEAR["d_out"]))}


def psum_inputs() -> list[np.ndarray]:
    """The inputs ``quantized_psum`` reduces, one row a rank: the JAX
    test's ``arange(64).reshape(8, 8) / 7`` and a seeded normal draw."""
    rng = np.random.default_rng(SEED)
    return [(np.arange(PSUM_ROWS * PSUM_COLS, dtype=np.float32)
             .reshape(PSUM_ROWS, PSUM_COLS) / np.float32(7.0)),
            rng.normal(size=(PSUM_ROWS, 64)).astype(np.float32)]


def checkpoint_array() -> np.ndarray:
    return np.arange(256.0, dtype=np.float32).reshape(16, 16)


def _hex(t: torch.Tensor) -> list[str]:
    return [float(v).hex() for v in t.reshape(-1).tolist()]


# -- the cases --------------------------------------------------------------
def case_train_step(rank: int, world: int, d: Path) -> dict:
    """One AdamW step of the linear model, its state DTensors on a
    (2, 4) mesh — params P(None, "model"), moments P("data", "model"),
    the batch P("data", None) — inside the mesh's context, against the
    same step on plain tensors; also with 2 microbatches, whose split
    ``constrain`` keeps on the data axis."""
    from repro_torch.dataplane.pipeline import device_put_sharded
    from repro_torch.distributed.context import DP, constrain, mesh_context
    from repro_torch.distributed.sharding import P, named
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    cfg = OptimizerConfig(kind="adamw", lr=0.05, weight_decay=0.0,
                          warmup_steps=0, total_steps=10_000)
    host = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in linear_inputs().items()}
    mesh = make_host_mesh(data=2, model=4)
    sspec = {"params": {"w": P(None, "model")},
             "opt": {"m": {"w": P("data", "model")},
                     "v": {"w": P("data", "model")}, "step": P()}}
    bspec = {"x": P("data", None), "y": P("data", None)}
    out = {}
    for accum in (1, 2):
        step = make_train_step(loss_fn, cfg, accum_steps=accum)
        ref, _ = step(init_train_state({"w": host["w"].clone()}, cfg),
                      {"x": host["x"], "y": host["y"]})
        state = device_put_sharded(
            init_train_state({"w": host["w"].clone()}, cfg),
            named(mesh, sspec))
        batch = device_put_sharded({"x": host["x"], "y": host["y"]},
                                   named(mesh, bspec))
        with mesh_context(mesh):
            got, metrics = step(state, batch)
            micro = constrain(batch["x"].reshape(2, -1, LINEAR["d_in"]),
                              None, DP, None)
        w = got["params"]["w"]
        m = got["opt"]["m"]["w"]
        out[f"accum{accum}"] = {
            "err": float(torch.max(torch.abs(
                w.full_tensor() - ref["params"]["w"]).detach())),
            "m_err": float(torch.max(torch.abs(
                m.full_tensor() - ref["opt"]["m"]["w"]))),
            "placements": [str(p) for p in w.placements],
            "local_shape": list(w.to_local().shape),
            "m_local_shape": list(m.to_local().shape),
            "grad_norm": float(metrics["grad_norm"].full_tensor())}
    out["micro_placements"] = [str(p) for p in micro.placements]
    out["micro_local_shape"] = list(micro.to_local().shape)
    return out


def case_quantized_psum(rank: int, world: int, d: Path) -> dict:
    """``quantized_psum`` over the group, rank r holding row r of each
    input; its bits, and its error against the exact sum."""
    from repro_torch.distributed.compression import quantized_psum

    out = {"hex": [], "rel": []}
    for x in psum_inputs():
        mine = torch.from_numpy(x[rank:rank + 1])
        got = quantized_psum(mine)
        exact = torch.from_numpy(x.sum(axis=0, dtype=np.float64))
        err = float(torch.max(torch.abs(got[0].double() - exact)))
        out["hex"].append(_hex(got))
        out["rel"].append(err / float(torch.max(torch.abs(exact))))
        same = [torch.empty_like(got) for _ in range(world)]
        dist.all_gather(same, got)
        out.setdefault("ranks_agree", []).append(
            all(torch.equal(s, got) for s in same))
    return out


def case_embedding_lookup(rank: int, world: int, d: Path) -> dict:
    """A row-sharded table (P("model", None) on an (8,) mesh) read at
    ids through ``F.embedding``, against the dense lookup."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed.sharding import P, named
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=1, model=world)
    table = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(64, 16)).astype(np.float32))
    ids = torch.tensor([0, 5, 63, 17, 33])
    tsh = distribute_tensor(table, *named(mesh, P("model", None)))
    idd = distribute_tensor(ids, mesh.device_mesh,
                            [Replicate()] * len(mesh.axis_names))
    out = torch.nn.functional.embedding(idd, tsh).full_tensor()
    return {"err": float(torch.max(torch.abs(out - table[ids]))),
            "local_rows": int(tsh.to_local().shape[0])}


def case_elastic_reshard(rank: int, world: int, d: Path) -> dict:
    """Save a (16, 16) state sharded P("data", "model") on a (4, 2) mesh
    (with a replicated leaf and a plain step counter beside it), restore
    it onto (2, 4): every element back exactly, on all 8 devices; a
    restore that does not fit leaves its DTensor target as it was."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, named
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

    w = torch.from_numpy(checkpoint_array())
    b = torch.arange(16, dtype=torch.float32)
    m1 = make_host_mesh(data=4, model=2)
    m2 = make_host_mesh(data=2, model=4)
    state = {"w": distribute_tensor(w, *named(m1, P("data", "model"))),
             "b": distribute_tensor(b, *named(m1, P())),
             "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(d / "ckpt", 1, state)
    target = {"w": torch.empty((16, 16), device="meta"),
              "b": torch.empty((16,), device="meta"),
              "step": torch.zeros((), dtype=torch.int32)}
    out = restore_checkpoint(d / "ckpt", 1, target,
                             {"w": named(m2, P("data", "model")),
                              "b": named(m2, P("model")), "step": None})
    files = sorted(f.name for f in (d / "ckpt" / "step_000000001").iterdir())
    # A DTensor target restored in place, a later leaf of another shape:
    # refused before the first leaf is written.
    bad = {"b": distribute_tensor(torch.zeros(16), *named(m2, P("model"))),
           "w": torch.empty((16, 8), device="meta")}
    try:
        restore_checkpoint(d / "ckpt", 1, bad)
        refused = False
    except ValueError:
        refused = True
    return {"err": float(torch.max(torch.abs(out["w"].full_tensor() - w))),
            "refused_untouched": refused and
            not bool(bad["b"].to_local().any()),
            "b_err": float(torch.max(torch.abs(out["b"].full_tensor() - b))),
            "step": int(out["step"]),
            "ndev": out["w"].device_mesh.size(),
            "mesh": list(out["w"].device_mesh.shape),
            "local_shape": list(out["w"].to_local().shape),
            "files": files}


def case_supervisor(rank: int, world: int, d: Path) -> dict:
    """``Supervisor.run`` of the linear model's DTensor state on a
    (2, 4) mesh, checkpoints written asynchronously every 2 steps, a
    fault at step 3 (restored with ``shardings``, replayed from step 2):
    the same parameters as 6 clean steps on plain tensors."""
    from repro_torch.dataplane.pipeline import device_put_sharded
    from repro_torch.distributed.context import mesh_context
    from repro_torch.distributed.sharding import P, named
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.fault import FaultConfig, Supervisor
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_state import (init_train_state,
                                               make_train_step)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}

    cfg = OptimizerConfig(kind="adamw", lr=0.05, weight_decay=0.0,
                          warmup_steps=0, total_steps=10_000)
    host = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in linear_inputs().items()}
    step = make_train_step(loss_fn, cfg)
    batch = {"x": host["x"], "y": host["y"]}
    ref = init_train_state({"w": host["w"].clone()}, cfg)
    for _ in range(6):
        ref, _ = step(ref, batch)

    mesh = make_host_mesh(data=2, model=4)
    shardings = named(mesh, {"params": {"w": P(None, "model")},
                             "opt": {"m": {"w": P("data", "model")},
                                     "v": {"w": P("data", "model")},
                                     "step": P()}})
    placed = device_put_sharded(batch, named(mesh, {"x": P("data", None),
                                                    "y": P("data", None)}))
    faults = {3}

    def inject(i):
        if i in faults:
            faults.discard(i)
            raise RuntimeError("planted fault")

    sup = Supervisor(FaultConfig(ckpt_dir=str(d / "ck"), ckpt_every=2,
                                 async_ckpt=True), step, lambda i: placed,
                     fault_injector=inject)
    state = device_put_sharded(init_train_state({"w": host["w"].clone()},
                                                cfg), shardings)
    with mesh_context(mesh):
        out = sup.run(state, 6, shardings=shardings)
    w = out["params"]["w"]
    return {"err": float(torch.max(torch.abs(
                w.full_tensor() - ref["params"]["w"]).detach())),
            "restarts": sup.restarts, "step": int(
                out["opt"]["step"].full_tensor()),
            "placements": [str(p) for p in w.placements]}


def case_restore_foreign(rank: int, world: int, d: Path) -> dict:
    """Restore ``DIR/foreign`` (a checkpoint another program wrote of
    ``checkpoint_array()`` under "w") onto a (2, 4) mesh."""
    from repro_torch.distributed.sharding import P, named
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import latest_step, restore_checkpoint

    mesh = make_host_mesh(data=2, model=4)
    out = restore_checkpoint(
        d / "foreign", latest_step(d / "foreign"),
        {"w": torch.empty((16, 16), device="meta")},
        {"w": named(mesh, P("data", "model"))})
    w = torch.from_numpy(checkpoint_array())
    return {"equal": bool(torch.equal(out["w"].full_tensor(), w)),
            "local_shape": list(out["w"].to_local().shape)}


def case_save_for_foreign(rank: int, world: int, d: Path) -> dict:
    """Save ``checkpoint_array()`` sharded P("data", "model") on a (4, 2)
    mesh into ``DIR/port`` for another program to read."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import P, named
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.checkpoint import save_checkpoint

    mesh = make_host_mesh(data=4, model=2)
    w = torch.from_numpy(checkpoint_array())
    save_checkpoint(d / "port", 3,
                    {"params": {"w": distribute_tensor(
                        w, *named(mesh, P("data", "model")))},
                     "step": torch.tensor(3, dtype=torch.int32)})
    return {"saved": True}


# -- the models on the mesh --------------------------------------------------
# DLRM-RM2, DeepFM and two-tower (B6, B1) and NequIP (B7) at their smoke
# configurations, every cell's ``Lowering.fn`` run once on a (2, 2)
# ("data", "model") mesh of 4 ranks and once on plain tensors in the
# same process, from parameters the test drew with the JAX initialisers
# (``DIR/params/<name>.npz``, keyed by the JAX paths).  Rank 0 writes
# both results of each cell to ``DIR/<arch>|<shape>.npz``.
MODEL_WORLD = 4
RECSYS_KINDS = {"dlrm-rm2": "dlrm", "deepfm": "deepfm",
                "two-tower-retrieval": "twotower"}
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# The rows of each recsys cell's batch (the candidates of
# ``retrieval_cand``), and the nodes and edges of each graph.
CELL_ROWS = {"train_batch": 8, "serve_p99": 8, "serve_bulk": 16,
             "retrieval_cand": 16}
GRAPH_NODES, GRAPH_EDGES = 32, 64
# The train cells' optimizer: AdamW with a short warmup, so one step
# moves every parameter well off its start.
MODEL_OPT = dict(kind="adamw", lr=1e-3, warmup_steps=2, total_steps=10)


def recsys_batch(kind: str, cfg, shape: str) -> dict:
    """A numpy batch of a recsys cell, drawn from the seed; for two-tower
    ``retrieval_cand``, ``user_ids`` (1,) and ``cand_ids``."""
    rng = np.random.default_rng(SEED)
    b = CELL_ROWS[shape]
    if kind == "twotower":
        if shape == "retrieval_cand":
            return {"user_ids": rng.integers(0, cfg.n_users, 1).astype(
                        np.int32),
                    "cand_ids": rng.integers(0, cfg.n_items, b).astype(
                        np.int32)}
        out = {"user_ids": rng.integers(0, cfg.n_users, b).astype(np.int32),
               "item_ids": rng.integers(0, cfg.n_items, b).astype(np.int32)}
        out["item_logq"] = -np.log1p(out["item_ids"]).astype(np.float32)
        return out
    n_slots = getattr(cfg, "bag_size", 1)
    out = {"bags": rng.integers(0, cfg.rows, (b, cfg.n_sparse, n_slots))
           .astype(np.int32)}
    if kind == "dlrm":
        out["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    if shape == "train_batch":
        out["labels"] = rng.integers(0, 2, b).astype(np.float32)
    return out


def graph_batch(info: dict) -> dict:
    """A numpy batch of a NequIP cell (``GNN_SHAPES[shape]``), drawn from
    the seed: ``GRAPH_NODES`` nodes, ``GRAPH_EDGES`` edges of which the
    last 5 are padding (-1), and the shape's readout's targets (an
    energy cell's nodes in graphs of 4, its ``n_graphs`` kept)."""
    rng = np.random.default_rng(SEED)
    n, e = GRAPH_NODES, GRAPH_EDGES
    out = {"node_feat": rng.normal(size=(n, info["d_feat"])).astype(
               np.float32),
           "positions": rng.uniform(0, 3, (n, 3)).astype(np.float32),
           "edge_index": rng.integers(0, n, (2, e)).astype(np.int32)}
    out["edge_index"][:, -5:] = -1
    if info["readout"] == "node_class":
        out["labels"] = rng.integers(0, info["n_out"], n).astype(np.int32)
        out["label_mask"] = (rng.random(n) < 0.8).astype(np.float32)
    else:
        out["graph_ids"] = (np.arange(n) // 4).astype(np.int32)
        out["energy"] = rng.normal(size=(info["n_graphs"],)).astype(
            np.float32)
        out["forces"] = rng.normal(size=(n, 3)).astype(np.float32)
    return out


def _load_model(cls, cfg, path: Path):
    """A model on the CPU holding the parameters of ``path`` (JAX paths)."""
    from repro_torch import carry

    model = cls(cfg, device="cpu")
    arrays = np.load(path)
    params = carry.model_params(model)
    assert set(arrays.files) == set(params), (sorted(arrays.files),
                                              sorted(params))
    with torch.no_grad():
        for key, p in params.items():
            p.copy_(torch.from_numpy(arrays[key]))
    return model


def _full(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _run_cell(low, model, args: tuple, mesh, seen: list | None = None,
              launches: dict | None = None) -> tuple[dict, dict]:
    """``low.fn`` on ``model``'s parameters (for a train cell, its fresh
    AdamW state) and ``args``, on plain tensors and then as DTensors
    under ``low.in_specs`` on ``mesh``: the two results as {name: numpy}
    (a train cell's parameters after the step and its loss; a serving
    cell's output).  A train cell's result also holds the step's
    ``grad_norm`` and AdamW's first moment ``m/<name>`` of each parameter,
    which a gradient scaled by a rank count would move.  With ``seen``,
    the rows B1 and B6 are handed in the mesh run (``_rows_seen``); with
    ``launches``, each run's kernel launches (``"plain"``, ``"mesh"``)."""
    from repro_torch.kernels import LAUNCHES

    import copy

    from repro_torch import carry
    from repro_torch.distributed.context import mesh_context
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_state import init_train_state

    params = {k: v.detach().clone()
              for k, v in carry.model_params(model).items()}
    if low.kind == "train":
        # The same start for both runs, sharing no storage with each
        # other or with the model.
        state = init_train_state(params, OptimizerConfig(**MODEL_OPT))
        placed = carry.distribute_state(copy.deepcopy(state), mesh,
                                        low.in_specs[0])
        args = (state,) + args
        dargs = (placed,) + tuple(carry.distribute_state(a, mesh, s) for a, s
                                  in zip(args[1:], low.in_specs[1:]))
    else:
        args = (params,) + args
        dargs = tuple(carry.distribute_state(a, mesh, s)
                      for a, s in zip(args, low.in_specs))
    results = []
    for run, run_args, ctx in (("plain", args, contextlib.nullcontext()),
                               ("mesh", dargs, mesh_context(mesh))):
        before = dict(LAUNCHES)
        with ctx, (_rows_seen(seen) if seen is not None and
                   run_args is dargs else contextlib.nullcontext()):
            out = low.fn(*run_args)
        if launches is not None:
            launches[run] = {k: v - before[k] for k, v in LAUNCHES.items()
                             if v != before[k]}
        if low.kind == "train":
            new, metrics = out
            res = {f"params/{k}": _full(v) for k, v in new["params"].items()}
            # AdamW's first step moves each element by lr·sign(g): the
            # gradient's norm and first moment see its magnitude.
            res.update({f"m/{k}": _full(v)
                        for k, v in new["opt"]["m"].items()})
            res["loss"] = _full(metrics["loss"])
            res["grad_norm"] = _full(metrics["grad_norm"])
        else:
            res = {"out": _full(out)}
        results.append(res)
    return results[0], results[1]


@contextlib.contextmanager
def _rows_seen(seen: list):
    """Record the rows of each table B1 and B6 are handed (their plain
    versions on the CPU) while the block runs."""
    from repro_torch.kernels.gather import ref

    real = {name: getattr(ref, name) for name in ("gather_rows",
                                                  "gather_rows_bag")}

    def wrap(name):
        def rec(table, ids):
            seen.append((name, int(table.shape[0])))
            return real[name](table, ids)
        return rec

    try:
        for name in real:
            setattr(ref, name, wrap(name))
        yield seen
    finally:
        for name, fn in real.items():
            setattr(ref, name, fn)


def _write(d: Path, rank: int, name: str, plain: dict, dist_: dict) -> None:
    if rank == 0:
        np.savez(d / f"{name}.npz", **{f"plain/{k}": v
                                       for k, v in plain.items()},
                 **{f"dist/{k}": v for k, v in dist_.items()})


def case_recsys_models(rank: int, world: int, d: Path) -> dict:
    """Every cell of DLRM-RM2, DeepFM and two-tower on the (2, 2) mesh
    and on plain tensors; the rows each rank's B1 and B6 calls were
    handed on the mesh, and each table's local shape."""
    from repro_torch import carry
    from repro_torch.configs import common
    from repro_torch.configs import train as tc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.optimizer import OptimizerConfig

    mesh = make_host_mesh(data=2, model=2)
    opt = OptimizerConfig(**MODEL_OPT)
    out = {"rows_seen": {}, "local_tables": {}}
    for arch_id, kind in RECSYS_KINDS.items():
        cfg = tc.module_of(arch_id)._smoke()
        arch = common.recsys_arch(arch_id, kind, cfg, cfg, opt)
        model = _load_model(tc._MODELS[kind], cfg,
                            d / "params" / f"{arch_id}.npz")
        seen: list = []
        for shape in RECSYS_SHAPES:
            low = arch.lowering(shape, mesh)
            batch = {k: torch.from_numpy(v)
                     for k, v in recsys_batch(kind, cfg, shape).items()}
            args = (batch["user_ids"], batch["cand_ids"]) \
                if "cand_ids" in batch else (batch,)
            plain, dist_ = _run_cell(low, model, args, mesh, seen)
            _write(d, rank, f"{arch_id}|{shape}", plain, dist_)
        everyone = [None] * world
        dist.all_gather_object(everyone, sorted(set(seen)))
        out["rows_seen"][arch_id] = everyone
        low = arch.lowering("train_batch", mesh)
        placed = carry.distribute_state(
            {k: v.detach() for k, v in carry.model_params(model).items()},
            mesh, low.in_specs[0]["params"])
        out["local_tables"][arch_id] = {
            k: list(v.to_local().shape) for k, v in placed.items()
            if "table" in k}
    return out


def case_nequip_models(rank: int, world: int, d: Path) -> dict:
    """Every NequIP cell (one train step each) on the (2, 2) mesh and on
    plain tensors; the segment plans' local edge counts."""
    from repro_torch.configs import common
    from repro_torch.configs import nequip as nqc
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import nequip as nq
    from repro_torch.train.optimizer import OptimizerConfig

    mesh = make_host_mesh(data=2, model=2)
    smoke = nqc._smoke()
    arch = common.gnn_arch("nequip", smoke, smoke,
                           OptimizerConfig(**MODEL_OPT))
    for shape in GNN_SHAPES:
        model = _load_model(nq.NequIP, nqc.for_shape(shape, smoke=True),
                            d / "params" / f"nequip|{shape}.npz")
        low = arch.lowering(shape, mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in graph_batch(common.GNN_SHAPES[shape]).items()}
        plain, dist_ = _run_cell(low, model, (batch,), mesh)
        _write(d, rank, f"nequip|{shape}", plain, dist_)
    return {"shapes": list(GNN_SHAPES), "uneven": _uneven_rows(mesh)}


def _uneven_rows(mesh) -> dict:
    """``segment_gather`` then ``segment_sum`` over 7 segments, rows that
    split 2, 2, 2, 1 over the 4 ranks (as a readout's per-graph sums
    may), and 36 edges, in float64; the mean square of the sums
    differentiated with ``create_graph`` and the gradient's square sum
    differentiated again.  The largest difference of each of the three
    from the plain run."""
    from repro_torch.distributed.sharding import P, named
    from repro_torch.kernels.segment import ops as sops
    from torch.distributed.tensor import distribute_tensor

    gen = torch.Generator().manual_seed(SEED)
    n, e = 7, 36
    ids = torch.randint(-1, n, (e,), generator=gen, dtype=torch.int32)
    values = torch.randn(n, 3, generator=gen, dtype=torch.float64)

    def run(v, i):
        plan = sops.segment_plan(i, n)
        out = sops.segment_sum(sops.segment_gather(v, plan, n) ** 2,
                               plan, n)
        (gv,) = torch.autograd.grad(out.square().mean(), v,
                                    create_graph=True)
        (ggv,) = torch.autograd.grad(gv.square().sum(), v)
        return out, gv, ggv

    axes = ("data", "model")
    plain = run(values.clone().requires_grad_(True), ids)
    v = distribute_tensor(values, *named(mesh, P(axes, None)))
    got = run(v.requires_grad_(True),
              distribute_tensor(ids, *named(mesh, P(axes))))
    return {name: float((g.full_tensor() - w).abs().max())
            for name, g, w in zip(("sums", "grad", "grad_grad"), got, plain)}


# The graphs run at their published sizes on the production meshes: one
# of each readout.  full_graph_sm's layout is minibatch_lg's (node rows
# that split evenly, a node-class readout), and ogb_products' 2.4 M node
# rows, summed whole on one process, would take gigabytes of memory.
PRODUCTION_GRAPHS = ("minibatch_lg", "molecule")


def _local_leaf(key: str, spec, meta: torch.Tensor, mesh, info: dict,
                gen: torch.Generator):
    """A ``DTensor`` of ``meta``'s global shape and dtype placed under
    ``spec`` on ``mesh``, holding only this rank's part, drawn for the
    leaf ``key`` of a NequIP cell's (state, batch): node ids of its graph
    for ``edge_index``, each node's graph for ``graph_ids``, classes for
    ``labels``, zeros for the optimizer's state, else normal values."""
    from repro_torch.distributed.sharding import named, shard_ranges
    from torch.distributed.tensor import DTensor

    sharding = named(mesh, spec)
    ranges = [shard_ranges(size, sharding.device_mesh, sharding.placements,
                           dim)[-1] for dim, size in enumerate(meta.shape)]
    shape = tuple(hi - lo for lo, hi in ranges)
    leaf = key.rsplit("/", 1)[-1]
    if leaf == "edge_index":
        local = torch.randint(0, info["n_nodes"], shape, generator=gen,
                              dtype=meta.dtype)
    elif leaf == "graph_ids":
        lo, hi = ranges[0]
        local = (torch.arange(lo, hi) * info["n_graphs"]
                 // info["n_nodes"]).to(meta.dtype)
    elif leaf == "labels":
        local = torch.randint(0, info["n_out"], shape, generator=gen,
                              dtype=meta.dtype)
    elif key.startswith("opt/") or not meta.dtype.is_floating_point:
        local = torch.zeros(shape, dtype=meta.dtype)
    else:
        local = 0.1 * torch.randn(shape, generator=gen, dtype=meta.dtype)
    stride = torch.empty(meta.shape, device="meta").stride()
    return DTensor.from_local(local, sharding.device_mesh,
                              sharding.placements, run_check=False,
                              shape=meta.shape, stride=stride)


def _placed_tree(tree, specs, leaf_fn, path: str = ""):
    """``leaf_fn(path, spec, leaf)`` for each leaf of a nested dict, its
    path the keys joined by "/"."""
    if isinstance(tree, dict):
        return {k: _placed_tree(v, specs[k], leaf_fn,
                                f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return leaf_fn(path, specs, tree)


def case_production_graphs(rank: int, world: int, d: Path) -> dict:
    """Each graph of ``PRODUCTION_GRAPHS``: one train step of its cell's
    ``fn`` (smoke trunk, published node and edge counts and readout) on
    the JAX production meshes, (16, 16) and (2, 16, 16), as rank 0 of a
    fake process group of the mesh's size (collectives move nothing, so
    no value is checked: what runs is the layout, every rank's shard
    shapes, the uneven ones included).  The new parameters' local
    shapes and placements against the given ones, and the loss's and
    ``grad_norm``'s shapes, by mesh and graph."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import common
    from repro_torch.configs import nequip as nqc
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.train.optimizer import OptimizerConfig

    smoke = nqc._smoke()
    arch = common.gnn_arch("nequip", smoke, smoke,
                           OptimizerConfig(**MODEL_OPT))
    out = {}
    for multi_pod in (False, True):
        sizes = make_production_mesh(multi_pod=multi_pod).axis_sizes
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(sizes)))
        try:
            mesh = make_host_mesh(*sizes[-2:],
                                  pod=sizes[0] if multi_pod else None)
            for shape in PRODUCTION_GRAPHS:
                low = arch.lowering(shape, mesh)
                gen = torch.Generator().manual_seed(SEED)
                specs = shd.sanitize_specs(low.in_specs, low.args, mesh)
                placed = [_placed_tree(
                    t, s, lambda k, sp, m: _local_leaf(
                        k, sp, m, mesh, common.GNN_SHAPES[shape], gen))
                    for t, s in zip(low.args, specs)]
                before = {k: (tuple(v.to_local().shape), str(v.placements))
                          for k, v in placed[0]["params"].items()}
                new, metrics = low.fn(*placed)
                after = {k: (tuple(v.to_local().shape), str(v.placements))
                         for k, v in new["params"].items()}
                out[f"{sizes}|{shape}"] = {
                    "same_layout": before == after,
                    "loss": list(metrics["loss"].shape),
                    "grad_norm": list(metrics["grad_norm"].shape)}
        finally:
            dist.destroy_process_group()
    return out


ONE_RANK_CELLS = tuple((a, s) for a in RECSYS_KINDS for s in RECSYS_SHAPES) \
    + tuple(("nequip", s) for s in GNN_SHAPES)


def smoke_cell(arch_id: str, shape: str, mesh, device: str = "cpu"):
    """(the cell's lowering, a model of its smoke configuration with
    seeded weights on ``device``, the arguments of its ``fn`` after the
    parameters or state): the cells of ``ONE_RANK_CELLS``, with this
    module's batches and ``MODEL_OPT``."""
    from repro_torch.configs import common
    from repro_torch.configs import nequip as nqc
    from repro_torch.configs import train as tc
    from repro_torch.models import nequip as nq
    from repro_torch.train.optimizer import OptimizerConfig

    opt = OptimizerConfig(**MODEL_OPT)
    if arch_id == "nequip":
        smoke = nqc._smoke()
        arch = common.gnn_arch("nequip", smoke, smoke, opt)
        model = nq.NequIP(nqc.for_shape(shape, smoke=True), device=device,
                          seed=SEED)
        host = graph_batch(common.GNN_SHAPES[shape])
    else:
        kind = RECSYS_KINDS[arch_id]
        cfg = tc.module_of(arch_id)._smoke()
        arch = common.recsys_arch(arch_id, kind, cfg, cfg, opt)
        model = tc._MODELS[kind](cfg, device=device, seed=SEED)
        host = recsys_batch(kind, cfg, shape)
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    args = (batch["user_ids"], batch["cand_ids"]) if "cand_ids" in batch \
        else (batch,)
    return arch.lowering(shape, mesh), model, args


def case_one_rank_models(rank: int, world: int, d: Path) -> dict:
    """Every cell of the four models (seeded smoke weights) on a (1, 1)
    mesh of one rank and on plain tensors: the cells whose results
    differ in any bit (a mesh of one reduces nothing)."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=1, model=1)
    differ = {}
    for arch_id, shape in ONE_RANK_CELLS:
        plain, on_mesh = _run_cell(*smoke_cell(arch_id, shape, mesh), mesh)
        bad = sorted(k for k in plain
                     if plain[k].tobytes() != on_mesh[k].tobytes())
        if bad:
            differ[f"{arch_id}|{shape}"] = bad
    return {"cells": [f"{a}|{s}" for a, s in ONE_RANK_CELLS],
            "differ": differ}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


# Cases that set up their own process groups.
OWN_GROUPS = ("production_graphs",)


def _rank(rank: int, case: str, world: int, d: str) -> None:
    torch.set_num_threads(1)
    if case in OWN_GROUPS:
        result = CASES[case](rank, world, Path(d))
        (Path(d) / "result.json").write_text(json.dumps(result))
        return
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        result = CASES[case](rank, world, Path(d))
        dist.barrier()
        if rank == 0:
            (Path(d) / "result.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    case, world, d = argv[0], int(argv[1]), argv[2]
    torch.multiprocessing.spawn(_rank, args=(case, world, d), nprocs=world,
                                join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
