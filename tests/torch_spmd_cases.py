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


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def _rank(rank: int, case: str, world: int, d: str) -> None:
    torch.set_num_threads(1)
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
