"""The dry run's trace (``repro_torch.launch.cost``) on the CPU: FLOPs,
bytes accessed, collectives and temporary, output and alias bytes per
device, from a cell's ``fn`` run on fake tensors over a fake process
group.

Each expectation is derived by hand here and stated beside its test:
- a fake trace takes the path of a real run: on a (1, 1) mesh at smoke
  size, one cell of each family traced on fake tensors and run for real
  (CPU tensors, a gloo group of one, the same mesh and specs) under the
  same counting mode give the same FLOPs and the same temporary bytes,
  exactly;
- the collectives of DLRM-RM2 ``serve_p99`` and of a decoder's
  ``train_4k`` on a fake (2, 2) mesh are those their sharded lookups and
  vocabulary-parallel loss imply, by kind, count and bytes;
- GLM-4 ``train_4k``'s FLOPs on the (16, 16) mesh, cut to one layer,
  fall within 2% of a closed form;
- a decoder's cost grows by the same amount from depth 1 to 2 as from 2
  to 3 (what the JAX package's cost probes extrapolate);
- a toy function pins ``temp_bytes``, ``output_bytes`` and
  ``alias_bytes``;
- a real id out of range still raises after a fake trace;
- ``python -m repro_torch.launch.dryrun --cost`` records every JAX key
  for one cell of each family on both production meshes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.configs import common, get_arch  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.context import mesh_context  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.train_state import init_train_state  # noqa: E402

import torch_lm_spmd_cases as lm_cases  # noqa: E402
import torch_spmd_cases as cases  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
KINDS = cost.COLLECTIVES


# -- helpers ------------------------------------------------------------------
@pytest.fixture
def smoke_lm_shapes(monkeypatch):
    """``configs.common.LM_SHAPES`` at the LM cases' smoke sizes for the
    test, restored after it."""
    for name, info in lm_cases.SMOKE_SHAPES.items():
        monkeypatch.setitem(common.LM_SHAPES, name, dict(info))


def _smoke_cell(arch_id: str, shape: str, mesh):
    """(lowering, the arguments of its ``fn`` as plain CPU tensors) of a
    smoke cell: the SPMD cases' seeded weights, batches and optimizer."""
    if arch_id in lm_cases.LM_IDS:
        arch, cfg = _lm_arch(arch_id)
        low = arch.lowering(shape, mesh)
        first = lm_cases.seeded_params(arch_id, cfg)
        rest = lm_cases._to_torch(lm_cases.cell_args(arch_id, cfg, shape))
        opt = OptimizerConfig(**lm_cases.MODEL_OPT)
    else:
        low, model, rest = cases.smoke_cell(arch_id, shape, mesh)
        first = {k: v.detach().clone()
                 for k, v in carry.model_params(model).items()}
        opt = OptimizerConfig(**cases.MODEL_OPT)
    if low.kind == "train":
        first = init_train_state(first, opt)
    return low, (first,) + tuple(rest)


def _lm_arch(arch_id: str, n_layers: int | None = None):
    """The smoke decoder's ``ArchDef`` (``LM_SHAPES`` as the test set
    them), with ``n_layers`` layers where given."""
    from repro_torch.configs import train as tc

    cfg = tc.module_of(arch_id)._smoke()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return common.lm_arch(arch_id, cfg, cfg,
                          OptimizerConfig(**lm_cases.MODEL_OPT),
                          fsdp=arch_id not in lm_cases.NO_FSDP), cfg


def _placed(tree):
    """Each ``DTensor`` leaf as (local tensor, placements, shape,
    stride), plain leaves as they are."""
    return shd.tree_map(
        lambda x: (x.to_local(), tuple(x.placements), tuple(x.shape),
                   x.stride()) if shd.is_dtensor(x) else x, tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))


def _faked(tree, mesh, fake_mode):
    """``_placed``'s leaves as fake ``DTensor`` leaves on ``mesh``: the
    same local shapes, dtypes and placements, no values."""
    from torch.distributed.tensor import DTensor

    def leaf(x):
        if isinstance(x, tuple):
            local, placements, shape, stride = x
            return DTensor.from_local(fake_mode.from_tensor(local),
                                      mesh.device_mesh, placements,
                                      run_check=False, shape=shape,
                                      stride=stride)
        return fake_mode.from_tensor(x)

    return shd.tree_map(leaf, tree, is_leaf=lambda x: isinstance(
        x, (tuple, torch.Tensor)))


def _real_then_fake(arch_id: str, shape: str) -> tuple[dict, dict, int]:
    """The cell at smoke size on a (1, 1) mesh: ``cost.trace`` of its
    ``fn`` run for real (a gloo group of one), then of the same ``fn``
    on fake tensors of the same shards (a fake group of one); and, but
    for NequIP, ``FlopCounterMode``'s own count of another real run
    (else None: its module hooks refuse the ``autograd.grad`` of a
    force's double backward)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        counted = None
        if arch_id != "nequip":
            low, args = _smoke_cell(arch_id, shape, mesh)
            counter = FlopCounterMode(display=False,
                                      custom_mapping=cost.custom_formulas())
            with mesh_context(mesh), counter:
                low.fn(*(carry.distribute_state(a, mesh, s)
                         for a, s in zip(args, low.in_specs)))
            counted = counter.get_total_flops()
        low, args = _smoke_cell(arch_id, shape, mesh)
        placed = tuple(carry.distribute_state(a, mesh, s)
                       for a, s in zip(args, low.in_specs))
        shards = [_placed(a) for a in placed]
        with mesh_context(mesh):
            real = cost.trace(low.fn, placed, low.donate)
        del placed
    finally:
        dist.destroy_process_group()
    with cost.fake_process_group(1):
        mesh = make_host_mesh(1, 1)
        low, _ = _smoke_cell(arch_id, shape, mesh)
        fake_mode = FakeTensorMode()
        args = tuple(_faked(a, mesh, fake_mode) for a in shards)
        with mesh_context(mesh), fake_mode:
            fake = cost.trace(low.fn, args, low.donate)
    return real, fake, counted


# -- a fake trace takes the real run's path ----------------------------------
@pytest.mark.parametrize("arch_id,shape", (("glm4-9b", "train_4k"),
                                           ("nequip", "molecule"),
                                           ("dlrm-rm2", "train_batch")))
def test_fake_trace_matches_a_real_run(smoke_lm_shapes, arch_id, shape):
    """Expected: the same counts, exactly.  The same ops run on the same
    shapes whether the tensors hold values or not, so FlopCounterMode's
    formulas give the same FLOPs, and FlopCounterMode itself counts as
    many over a real run (on one rank a DTensor op's shapes are its
    local op's); and every storage is created and ends at the same op
    in both runs (the garbage collector is off in a trace), so the peak
    of live bytes, less the same arguments and outputs, is the same.
    The real run's id checks read values back (an all-reduce of spans
    and a host read); the fake run skips them, so only FLOPs and
    temporary bytes are held, not the collectives."""
    real, fake, counted = _real_then_fake(arch_id, shape)
    assert fake["cost"]["flops_per_device"] > 0
    assert fake["cost"]["flops_per_device"] == \
        real["cost"]["flops_per_device"]
    if counted is not None:
        assert fake["cost"]["flops_per_device"] == counted
    assert fake["memory"]["temp_bytes"] > 0
    assert fake["memory"]["temp_bytes"] == real["memory"]["temp_bytes"]
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert fake["memory"][key] == real["memory"][key], key


# -- collectives on a fake (2, 2) mesh ----------------------------------------
def _trace_log(low, mesh) -> cost.CostMode:
    """The counting mode after ``low.fn`` ran once on fake shards of
    ``low.args`` on ``mesh`` (its ``collective_log`` kept)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = FakeTensorMode()
    args = cost.fake_args(low, mesh, fake_mode)
    mode = cost.CostMode()
    with mesh_context(mesh), fake_mode, mode.entered():
        low.fn(*args)
    return mode


def test_dlrm_serve_collectives_on_a_2x2_mesh():
    """DLRM-RM2 ``serve_p99`` (512 rows, 26 tables of 10⁶ rows × 64) on
    (data 2, model 2).  Derived: the batch is split over "data" and
    replicated over "model"; each table is split over "model" by rows
    (``recsys_rules``), the MLPs replicated.  ``sharded_rows`` makes the
    ids whole over each mesh dim that splits the table's rows: over
    "model" they already are, so no ids move; each rank sums its own
    rows of its 256 rows' bags, and the partial sums (256, 26, 64)
    float32 are reduced over "model": one all-reduce of 256 × 26 × 64 ×
    4 = 1,703,936 bytes.  The MLPs and the interaction run on each
    rank's rows.  Nothing else."""
    with cost.fake_process_group(4):
        mesh = make_host_mesh(2, 2)
        mode = _trace_log(get_arch("dlrm-rm2").lowering("serve_p99", mesh),
                          mesh)
    assert mode.collective_log == [
        ("_c10d_functional::all_reduce", "all-reduce", 256 * 26 * 64 * 4)]
    rec = cost.collectives_record(mode)
    assert rec["total_bytes"] == 1_703_936
    assert all(rec[k]["count"] == 0 for k in KINDS if k != "all-reduce")


def test_decoder_train_loss_collectives_on_a_2x2_mesh(smoke_lm_shapes):
    """GLM-4's smoke ``train_4k`` (16 rows of 8 tokens, 8 microbatches,
    vocabulary 256) on (data 2, model 2).  Derived for its
    vocabulary-parallel loss: each microbatch's logits (2, 8, 256) are
    split by rows over "data" (one row of 8 tokens a rank) and by the
    vocabulary over "model"; ``_NLL`` reduces three statistics of each
    of its 8 rows over "model" (the maximum, the sum of exponentials,
    the gold logit): three ``torch.distributed`` all-reduces of 8 × 4 =
    32 bytes a microbatch, 24 in the step, and no other
    ``torch.distributed`` call runs in it (the id checks read nothing
    of fake tensors).  Everything else the step moves is DTensor's own
    (``_c10d_functional``), and the record's totals are the log's."""
    arch, _ = _lm_arch("glm4-9b")
    with cost.fake_process_group(4):
        mesh = make_host_mesh(2, 2)
        mode = _trace_log(arch.lowering("train_4k", mesh), mesh)
    direct = [e for e in mode.collective_log if e[0].startswith("c10d::")]
    assert direct == [("c10d::allreduce_", "all-reduce", 32)] * 24
    rec = cost.collectives_record(mode)
    for kind in KINDS:
        logged = [n for _, k, n in mode.collective_log if k == kind]
        assert rec[kind] == {"bytes": sum(logged), "count": len(logged)}
    assert rec["all-reduce"]["count"] > 24      # the gradients' too


# -- GLM-4's FLOPs against a closed form -------------------------------------
def test_glm4_train_flops_match_a_closed_form():
    """GLM-4 ``train_4k`` (256 rows of 4096 tokens, 8 microbatches) on
    the (16, 16) mesh, cut to one layer (``--layers 1``).  Per device:
    T = 256 / 16 × 4096 = 65,536 tokens (its 16 rows), D = 4096.  The
    layer's input and its FFN's are whole over "model"; each weight is
    split over "model" by columns (wq, wk, wv, w_gate, w_up) or rows
    (wo, w_down), so each device multiplies its T tokens by 4096 / 16 =
    256 columns of wq and rows of wo, 256 / 16 = 16 columns each of wk
    and wv (2 KV heads of 128, split like any columns) and 13,696 / 16 =
    856 of each FFN weight: 2·T·D FLOPs a column.  Attention: 2 KV heads
    do not split 16 ways, so every device attends over all 32 heads of
    its 16 rows, each 1024-query chunk against all 4096 keys, masked (the
    port forms the masked scores): 2 products of 2·B·H·S²·dh.  A layer
    runs 4 times its forward (its forward, its recomputation, and a
    backward of two products a product), less one w_down product: the
    recomputation stops once it has rebuilt what the backward saved, and
    nothing saves w_down's output.  The head (V / 16 = 9472 columns)
    runs forward and backward: 3 times.  The embedding is B1 (0 FLOPs)
    and its backward adds T·D.  Elementwise FLOPs are not counted."""
    t, d, s, b, h, dh = 65_536, 4096, 4096, 16, 32, 128
    per_col = 2 * t * d
    layer = per_col * (256 + 16 + 16 + 256 + 3 * 856) \
        + 2 * (2 * b * h * s * s * dh)
    head = per_col * 9472
    want = 4 * layer - per_col * 856 + 3 * head + t * d
    rec = cost.trace_cell(get_arch("glm4-9b", layers=1), "train_4k",
                          (16, 16))
    got = rec["cost"]["flops_per_device"]
    assert abs(got - want) / want < 0.02, (got, want)


# -- the cost grows by a layer's each layer ----------------------------------
def test_decoder_cost_grows_linearly_with_depth(smoke_lm_shapes):
    """GLM-4's smoke ``train_4k`` on a fake (2, 2) mesh at depth 1, 2
    and 3: every layer runs the same ops on the same shapes and moves
    the same collectives, so the FLOPs, the bytes accessed and each
    collective's count and bytes grow by the same amount from depth 1
    to 2 as from 2 to 3 (the per-layer cost the JAX package's probes
    extrapolate from their unrolled copies)."""
    recs = []
    for n in (1, 2, 3):
        arch, _ = _lm_arch("glm4-9b", n_layers=n)
        recs.append(cost.trace_cell(arch, "train_4k", (2, 2)))

    def numbers(r):
        out = {"flops": r["cost"]["flops_per_device"],
               "bytes": r["cost"]["bytes_accessed_per_device"]}
        for k in KINDS:
            out[k] = (r["collectives"][k]["count"],
                      r["collectives"][k]["bytes"])
        return out

    one, two, three = map(numbers, recs)
    for key in one:
        if isinstance(one[key], tuple):
            first = tuple(b - a for a, b in zip(one[key], two[key]))
            second = tuple(b - a for a, b in zip(two[key], three[key]))
        else:
            first, second = two[key] - one[key], three[key] - two[key]
        assert first == second, (key, one[key], two[key], three[key])
    assert two["flops"] > one["flops"]


# -- memory of a toy function ------------------------------------------------
def _toy(x, w):
    a = x @ w               # (4, 8) float32: 128 bytes
    b = a * 2               # 128 bytes, while a lives
    del a
    x.add_(1)               # the donated argument, written in place
    return x, b


@pytest.mark.parametrize("fake", (False, True))
def test_toy_memory_and_cost(fake):
    """x (4, 8) and w (8, 8) float32: 128 + 256 = 384 argument bytes.
    ``a`` and ``b`` (128 bytes each) are both live once ``b`` is made:
    a peak of 640 bytes.  The outputs are x (written in place, donated:
    aliased, 128) and b (128): output 256, alias 128, and temp = 640 -
    384 - 128 = 128, the bytes of ``a``.  FLOPs: the product's 2·4·8·8
    = 512.  Bytes accessed: the product reads 128 + 256 and writes 128,
    the multiply reads 128 and writes 128 (its 2 is no tensor), the add
    reads and writes 128 twice: 512 + 256 + 256 = 1024.  On fake tensors
    the same."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode() if fake else None
    with mode if fake else torch.no_grad():
        x, w = torch.ones(4, 8), torch.ones(8, 8)
        rec = cost.trace(_toy, (x, w), donate=(0,))
    assert rec["memory"] == {"argument_bytes": 384, "output_bytes": 256,
                             "temp_bytes": 128, "alias_bytes": 128,
                             "code_bytes": None}
    assert rec["cost"] == {"flops_per_device": 512.0,
                           "bytes_accessed_per_device": 1024.0}
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with mode if fake else torch.no_grad(), counter:
        _toy(torch.ones(4, 8), torch.ones(8, 8))
    assert counter.get_total_flops() == 512
    assert rec["collectives"]["total_bytes"] == 0


# -- real ids are still checked ---------------------------------------------
def test_real_ids_out_of_range_raise_after_a_fake_trace():
    """A fake trace skips the id checks only for fake tensors: after one
    ran in this process, real ids out of range still raise, through each
    check the trace passes (``checked_ids``, ``checked_cast_i32``, a
    segment plan, the cross-entropy's labels)."""
    from repro_torch.kernels._casting import checked_cast_i32
    from repro_torch.kernels._mesh import checked_ids
    from repro_torch.kernels.segment import ops as segops
    from repro_torch.models import layers

    rec = cost.trace_cell(get_arch("deepfm"), "serve_p99", (2, 2))
    assert rec["cost"]["flops_per_device"] > 0
    with pytest.raises(IndexError):
        checked_ids(torch.tensor([0, 7]), what="ids", n_rows=5)
    with pytest.raises(IndexError):
        checked_cast_i32(torch.tensor([9]), n_elements=5)
    with pytest.raises(IndexError):
        segops.segment_plan(torch.tensor([0, 9], dtype=torch.int32), 5)
    with pytest.raises(IndexError):
        layers.cross_entropy(torch.zeros(2, 4), torch.tensor([0, 4]))
    assert checked_ids(torch.tensor([0, 4]), what="ids",
                       n_rows=5).dtype == torch.int32


# -- the command line -------------------------------------------------------
# One cell of each family, traced on both production meshes.  Each
# call's limit: at least 3x its seconds alone on 8 CPU cores (NequIP
# ``full_graph_sm``'s, the longest: 8 s of trace on (16, 16), 23 on
# (2, 16, 16), and the interpreter's start).
CLI_CELLS = (("glm4-9b", "decode_32k"), ("nequip", "full_graph_sm"),
             ("deepfm", "serve_p99"))
CLI_LIMIT_S = 180


def test_dryrun_cli_cost_records_every_jax_key(tmp_path):
    """``--cost`` on one cell of each family on both meshes: 6 records,
    each ``ok`` with the JAX dry run's keys, FLOPs and bytes accessed
    above 0, the five collective kinds and ``total_bytes`` their sum,
    ``code_bytes`` None, and arguments the untraced record's."""
    out = tmp_path / "d.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    for arch_id, shape in CLI_CELLS:
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch_id, "--shape", shape, "--both-meshes", "--cost", "--out",
             str(out)], env=env, capture_output=True, text=True,
            timeout=CLI_LIMIT_S, cwd=str(REPO))
        assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
        assert time.monotonic() - t0 < CLI_LIMIT_S
    recs = json.loads(out.read_text())
    assert len(recs) == 6
    for key, rec in recs.items():
        assert rec["ok"] and rec["probe"] is None, key
        assert rec["cost"]["flops_per_device"] > 0, key
        assert rec["cost"]["bytes_accessed_per_device"] > 0, key
        colls = rec["collectives"]
        assert set(colls) == set(KINDS) | {"total_bytes"}
        assert colls["total_bytes"] == sum(colls[k]["bytes"] for k in KINDS)
        mem = rec["memory"]
        assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                            "alias_bytes", "code_bytes"}
        assert mem["code_bytes"] is None and mem["temp_bytes"] >= 0
        assert rec["compile_s"] > 0
        arch_id, shape, mesh = key.split("|")
        plain = dryrun_record(arch_id, shape, mesh == "mp")
        assert mem["argument_bytes"] == plain["memory"]["argument_bytes"]
    # a decode writes its cache in place: the cache is aliased
    dec = recs["glm4-9b|decode_32k|sp"]["memory"]
    assert 0 < dec["alias_bytes"] < dec["output_bytes"]


def dryrun_record(arch_id: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.launch import dryrun

    return dryrun.run_cell(arch_id, shape, multi_pod)
