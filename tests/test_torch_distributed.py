"""The port's distribution == the JAX package's, on the CPU.

Sharding: the port's ``param_specs`` of every parameter of the ten
published configurations (built on ``meta``) equal the JAX package's on
``jax.eval_shape`` avals, with and without ``fsdp_rules``, and so do
``opt_state_specs`` and ``sanitize_specs`` on both production meshes.
Lowerings: for every (arch × shape) cell on both meshes, the port's
``lowering()`` arguments have the JAX lowering's tree paths, shapes and
dtypes, its sanitized ``in_specs`` are the JAX ones, and the dry run's
per-device ``argument_bytes`` equals the same arithmetic on the JAX
avals and specs.  The JAX side needs no 256-device mesh: ``lowering``
reads only the mesh's axis names and ``sanitize_specs`` its device
shape, so a stand-in holds both.

SPMD: the counterparts of ``tests/test_distributed.py::
TestSPMDExecution`` on gloo process groups of 8 CPU ranks
(``tests/torch_spmd_cases.py``, each case one subprocess with a limit
of its own, ``SPMD_LIMIT_S``): the sharded AdamW step within the JAX test's 1e-5 of the plain
one, ``quantized_psum`` within its 0.05 relative and bit for bit equal
to the JAX ``quantized_psum`` under ``shard_map`` on 8 host devices (a
JAX subprocess), the row-sharded embedding lookup exactly, and the
elastic checkpoint reshard (4, 2) → (2, 4) exactly.  A checkpoint the
port writes from ``DTensor`` leaves is read back by the JAX
``restore_checkpoint`` byte for byte, and one the JAX package writes
sharded on 8 devices is restored by the port onto another mesh.

Also: ``constrain`` and ``_filter``, ``initialize_distributed`` without
``REPRO_COORDINATOR``, the dry run's command line, fault C14 (a run of
2³¹ elements) on a zero-byte expanded view, and the JAX package's lint
over the port, which must find nothing.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402

from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.distributed import context as port_ctx  # noqa: E402
from repro_torch.distributed import sharding as port_shd  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.kernels.segment import ops as segops  # noqa: E402
from repro_torch.launch import dryrun as port_dryrun  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.train.checkpoint import flatten_tree  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
TESTS = Path(__file__).resolve().parent
import torch_spmd_cases as cases  # noqa: E402

# Each case's time limit, from its start: about 6x its own seconds alone
# on 8 CPU cores (the ``seconds`` each case writes; 2-3x the most that
# any case took beside the rest of the suite on six workers, up to 4x
# its time alone), and at least 120 s.  Alone: production_graphs 52.2,
# nequip_models 20.8, one_rank_models 17.8, recsys_models 12.5, every
# other case under 8.  ``SPMD_TIMEOUT_S`` is the limit of a case not
# named here.
SPMD_TIMEOUT_S = 120
SPMD_LIMIT_S = {"recsys_models": 120, "nequip_models": 150,
                "one_rank_models": 120, "production_graphs": 320}
SPMD_RANKS = 8
MESHES = {"sp": False, "mp": True}
CELLS = ref_configs.all_cells()
FAMILY_RULES = {"lm": ("lm_rules",), "gnn": ("gnn_rules",),
                "recsys": ("recsys_rules", "lm_rules")}
FIRST_SHAPE = {aid: ref_configs.get_arch(aid).shapes[0]
               for aid in ref_configs.ARCH_IDS}


# -- helpers ------------------------------------------------------------------
def _jax_mesh(multi_pod: bool):
    """What the JAX ``lowering`` and ``sanitize_specs`` read of a
    production mesh: its axis names and its device grid's shape."""
    m = port_mesh.make_production_mesh(multi_pod=multi_pod)
    return SimpleNamespace(axis_names=m.axis_names,
                           devices=np.empty(m.axis_sizes, dtype=np.uint8))


def _jax_flat(tree) -> dict:
    """{path: leaf} of a JAX tree, specs and ``None`` kept as leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP) or x is None)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in leaves}


def _port_flat(tree) -> dict:
    return flatten_tree(tree, is_leaf=port_shd.is_spec_leaf)


def _spec_tuple(spec):
    return None if spec is None else tuple(spec)


def _assert_specs_equal(port_tree, jax_tree, what: str):
    got = {k: _spec_tuple(v) for k, v in _port_flat(port_tree).items()}
    want = {k: _spec_tuple(v) for k, v in _jax_flat(jax_tree).items()}
    assert sorted(got) == sorted(want), what
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, f"{what}: {len(bad)} specs differ, e.g. " \
        f"{list(bad.items())[:3]}"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _avals(port_args, jax_args, what: str):
    """The two argument trees as {path: (shape, dtype name)}, which must
    hold the same paths."""
    got = {k: (tuple(v.shape), _dtype_name(v.dtype))
           for k, v in flatten_tree(port_args).items()}
    want = {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in _jax_flat(jax_args).items()}
    assert sorted(got) == sorted(want), what
    return got, want


def _jax_argument_bytes(low, mesh) -> int:
    """The dry run's arithmetic on the JAX lowering: each leaf's bytes
    over the product of its sanitized spec's axis sizes."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for specs, args in zip(low.in_specs, low.args):
        specs = _jax_flat(ref_shd.sanitize_specs(specs, args, mesh))
        for key, aval in _jax_flat(args).items():
            spec = specs[key]
            n = int(np.prod(aval.shape)) * aval.dtype.itemsize
            parts = int(np.prod([sizes[a] for d in (spec or ())
                                 if d is not None
                                 for a in (d if isinstance(d, tuple)
                                           else (d,))]))
            assert n % parts == 0
            total += n // parts
    return total


def run_spmd_case(case: str, d: Path, world: int = SPMD_RANKS) -> dict:
    """One case of ``tests/torch_spmd_cases.py`` on ``world`` gloo ranks,
    in a subprocess with a time limit."""
    return finish_spmd_case(start_spmd_case(case, d, world), d)


def start_spmd_case(case: str, d: Path, world: int = SPMD_RANKS):
    """``run_spmd_case`` started, for ``finish_spmd_case`` to wait on."""
    d.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "torch_spmd_cases.py"), case,
         str(world), str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    proc.started = time.monotonic()
    proc.limit = SPMD_LIMIT_S.get(case, SPMD_TIMEOUT_S)
    return proc


def finish_spmd_case(proc, d: Path) -> dict:
    """The result of a started case, within its limit (``SPMD_LIMIT_S``)
    of its start; a case past it is killed and fails."""
    try:
        _, err = proc.communicate(timeout=max(
            1.0, proc.limit - (time.monotonic() - proc.started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-3000:]
    return json.loads((d / "result.json").read_text())


JAX_SPMD = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    from functools import partial
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.compression import quantized_psum
    from repro.train.checkpoint import save_checkpoint

    d = sys.argv[1]
    inputs = np.load(os.path.join(d, "psum.npz"))
    mesh = jax.make_mesh((8,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))

    @partial(jax.shard_map, mesh=mesh, in_specs=P("data", None),
             out_specs=P("data", None))
    def f(xs):
        return quantized_psum(xs, "data")

    out = [[float(v).hex() for v in np.asarray(f(jnp.asarray(
        inputs[k])))[0]] for k in sorted(inputs.files)]
    m1 = jax.make_mesh((4, 2), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
    w = np.load(os.path.join(d, "w.npy"))
    ws = jax.device_put(jnp.asarray(w),
                        NamedSharding(m1, P("data", "model")))
    save_checkpoint(os.path.join(d, "foreign"), 5, {"w": ws})
    print(json.dumps({"hex": out,
                      "n_shards": len(ws.addressable_shards)}))
"""


@pytest.fixture(scope="module")
def jax_spmd(tmp_path_factory) -> dict:
    """One JAX subprocess on 8 host devices: ``quantized_psum`` under
    ``shard_map`` of ``cases.psum_inputs()``, and a checkpoint of
    ``cases.checkpoint_array()`` sharded P("data", "model") on a (4, 2)
    mesh under ``dir/foreign``."""
    d = tmp_path_factory.mktemp("jax_spmd")
    np.savez(d / "psum.npz", **{f"x{i}": x for i, x in
                                enumerate(cases.psum_inputs())})
    np.save(d / "w.npy", cases.checkpoint_array())
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SPMD),
                          str(d)], env={**env, "JAX_PLATFORMS": "cpu"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {"dir": d, **json.loads(out.stdout.strip().splitlines()[-1])}


# -- (a) sharding rules on the published parameters ---------------------------
@pytest.mark.parametrize("arch_id", ref_configs.ARCH_IDS)
def test_param_specs_match_jax(arch_id):
    """Every parameter's spec under the family's rules (and under
    ``fsdp_rules`` of them), the optimizer state's, and both sanitized on
    both production meshes, equal the JAX package's."""
    shape = FIRST_SHAPE[arch_id]
    ref_arch = ref_configs.get_arch(arch_id)
    family = ref_arch.family
    ref_low = ref_arch.lowering(shape, _jax_mesh(False))
    low = port_configs.get_arch(arch_id).lowering(
        shape, port_mesh.make_production_mesh())
    jparams = ref_low.args[0]["params"]
    params = low.args[0]["params"]
    _avals(params, jparams, arch_id)
    for name in FAMILY_RULES[family]:
        for fsdp in (False, True):
            jrules = getattr(ref_shd, name)
            rules = getattr(port_shd, name)
            if fsdp:
                jrules, rules = ref_shd.fsdp_rules(jrules), \
                    port_shd.fsdp_rules(rules)
            what = f"{arch_id} {name} fsdp={fsdp}"
            jspecs = ref_shd.param_specs(jparams, jrules)
            specs = port_shd.param_specs(params, rules)
            _assert_specs_equal(specs, jspecs, what)
            _assert_specs_equal(port_shd.opt_state_specs(specs, params),
                                ref_shd.opt_state_specs(jspecs, jparams),
                                what + " opt")
            for key, mp in MESHES.items():
                jm = _jax_mesh(mp)
                pm = port_mesh.make_production_mesh(multi_pod=mp)
                _assert_specs_equal(
                    port_shd.sanitize_specs(specs, params, pm),
                    ref_shd.sanitize_specs(jspecs, jparams, jm),
                    f"{what} sanitized {key}")


# -- (b) every cell's lowering and its bytes per device -----------------------
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch_id,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_lowering_matches_jax(arch_id, shape, mesh_key):
    mp = MESHES[mesh_key]
    jm = _jax_mesh(mp)
    pm = port_mesh.make_production_mesh(multi_pod=mp)
    ref_low = ref_configs.get_arch(arch_id).lowering(shape, jm)
    low = port_configs.get_arch(arch_id).lowering(shape, pm)
    assert low.kind == ref_low.kind
    assert len(low.args) == len(ref_low.args) == len(low.in_specs)
    for i, (args, jargs) in enumerate(zip(low.args, ref_low.args)):
        got, want = _avals(args, jargs, f"{arch_id} {shape} arg {i}")
        assert got == want, {k: (got[k], want[k]) for k in want
                             if got[k] != want[k]}
        assert all(t.device.type == "meta"
                   for t in flatten_tree(args).values())
        _assert_specs_equal(
            port_shd.sanitize_specs(low.in_specs[i], args, pm),
            ref_shd.sanitize_specs(ref_low.in_specs[i], jargs, jm),
            f"{arch_id} {shape} in_specs {i}")
    assert port_dryrun.argument_bytes(low, pm) == \
        _jax_argument_bytes(ref_low, jm)


@pytest.mark.parametrize("arch_id,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_lowering_fn_and_donate_match_jax(arch_id, shape):
    """Every one of the 40 cells carries a callable ``fn`` and the JAX
    lowering's ``donate``: the train step's state (``(0,)``), an LM
    decode's cache (``(1,)``), nothing for a prefill or a serving
    forward."""
    ref_low = ref_configs.get_arch(arch_id).lowering(shape, _jax_mesh(False))
    low = port_configs.get_arch(arch_id).lowering(
        shape, port_mesh.make_production_mesh())
    assert callable(ref_low.fn)
    assert callable(low.fn)
    assert low.donate == ref_low.donate
    assert low.donate == {"train": (0,), "decode": (1,)}.get(low.kind, ())


def _fake_cases():
    """(op, its arguments on the CPU) for each custom op of the port."""
    from repro_torch.kernels.segment import ref as segref

    table = torch.randn(50, 6)
    ids = torch.tensor([3, 0, 49, 7], dtype=torch.int32)
    bags = torch.tensor([[1, -1], [4, 4], [-1, -1]], dtype=torch.int32)
    seg = torch.tensor([2, -1, 0, 2, 5], dtype=torch.int32)
    plan = segref.build_plan(seg, 6)
    plan_args = (plan.ids, plan.perm, plan.offsets, 6)
    return {
        "gather_rows": (gops.gather_rows_op, (table, ids)),
        "gather_rows_backward": (gops.gather_rows_backward_op,
                                 (torch.randn(4, 6), ids, 50)),
        "gather_rows_bag": (gops.gather_rows_bag_op, (table, bags)),
        "gather_rows_bag_backward": (gops.gather_rows_bag_backward_op,
                                     (torch.randn(3, 6), bags, 50)),
        "segment_sum": (segops.segment_sum_op,
                        (torch.randn(5, 3, dtype=torch.float64),
                         *plan_args)),
        "segment_gather": (segops.segment_gather_op,
                           (torch.randn(6, 3), *plan_args)),
    }


@pytest.mark.parametrize("name", ("gather_rows", "gather_rows_backward",
                                  "gather_rows_bag",
                                  "gather_rows_bag_backward", "segment_sum",
                                  "segment_gather"))
def test_custom_op_fake_matches_the_op(name):
    """Each custom op on ``meta`` tensors (its fake) gives the shape and
    dtype the op gives on the CPU, and the op passes
    ``torch.library.opcheck``'s schema and fake checks."""
    op, args = _fake_cases()[name]
    real = op(*args)
    fake = op(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args))
    assert fake.device.type == "meta"
    assert fake.shape == real.shape and fake.dtype == real.dtype
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_faketensor"))


# -- (c) the registry ---------------------------------------------------------
def test_all_cells_match_jax():
    assert port_configs.all_cells() == ref_configs.all_cells()
    assert len(port_configs.all_cells()) == 40
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS


@pytest.mark.parametrize("arch_id", ref_configs.ARCH_IDS)
def test_describe_and_correction_match_jax(arch_id):
    ref, port = ref_configs.get_arch(arch_id), port_configs.get_arch(arch_id)
    assert port.arch_id == ref.arch_id and port.family == ref.family
    assert port.shapes == ref.shapes
    assert port.describe() == ref.describe()
    assert (port.correction is None) == (ref.correction is None)
    if ref.correction is not None:
        assert port.correction() == ref.correction()
    assert port.probes is None


def test_smoke_wraps_train_smoke():
    out = port_configs.get_arch("dlrm-rm2").smoke(device="cpu")
    assert out["family"] == "recsys" and out["kind"] == "dlrm"
    state, _ = out["step"](out["state"], {
        k: torch.from_numpy(v) for k, v in out["batch"].items()})
    assert int(state["opt"]["step"]) == 1


def test_get_arch_unknown():
    with pytest.raises(KeyError):
        port_configs.get_arch("gpt-5")


# -- the dry run --------------------------------------------------------------
def test_dryrun_cli_all_cells_both_meshes(tmp_path):
    """80 records, all ``ok``, per-device bytes the lowering's."""
    out = tmp_path / "d.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--both-meshes", "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=300, cwd=str(REPO))
    assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
    recs = json.loads(out.read_text())
    assert len(recs) == 80 and all(r["ok"] for r in recs.values())
    rec = recs["deepseek-v3-671b|train_4k|mp"]
    assert rec["n_devices"] == 512 and rec["kind"] == "train"
    assert rec["correction"]["opt_kind"] == "adafactor"
    low = port_configs.get_arch("deepseek-v3-671b").lowering(
        "train_4k", port_mesh.make_production_mesh(multi_pod=True))
    assert rec["memory"]["argument_bytes"] == port_dryrun.argument_bytes(
        low, port_mesh.make_production_mesh(multi_pod=True))
    assert recs["glm4-9b|decode_32k|sp"]["n_devices"] == 256
    # --resume skips what is recorded
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepfm", "--shape", "serve_p99", "--out", str(out), "--resume"],
        env=env, capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0 and "[skip] deepfm|serve_p99|sp" in res.stdout


def test_dryrun_failing_cell_is_recorded(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(port_dryrun, "run_cell", boom)
    out = tmp_path / "d.json"
    rc = port_dryrun.main(["--arch", "deepfm", "--shape", "serve_p99",
                           "--out", str(out)])
    assert rc == 1
    rec = json.loads(out.read_text())["deepfm|serve_p99|sp"]
    assert rec["ok"] is False and "planted" in rec["error"]


# -- (d) TestShardingRules counterparts ---------------------------------------
class TestShardingRules:
    def test_lm_rules_specs(self):
        from repro_torch import carry
        from repro_torch.models import transformer as tf

        cfg = tf.TransformerConfig(name="t", vocab=160, d_model=32,
                                   n_layers=2, n_heads=4, n_kv_heads=2,
                                   d_head=8, d_ff=64)
        params = carry.decoder_params(tf.init_params(cfg, device="meta"),
                                      cfg)
        flat = port_shd.param_specs(params, port_shd.lm_rules)
        assert flat["embed/table"] == P("model", None)
        # stacked layer weights get a leading None for the layer dim
        assert flat["groups/0/attn/wq"][0] is None
        assert "model" in flat["groups/0/attn/wq"]

    def test_sanitize_drops_undivisible_and_missing(self):
        mesh = port_mesh.Mesh(("data",), (1,))
        specs = {"a": P("model", "data"), "b": P(("data", "pod")),
                 "c": P("data")}
        avals = {"a": torch.empty((7, 4), device="meta"),
                 "b": torch.empty((8, 2), device="meta"),
                 "c": torch.empty((3,), device="meta")}
        out = port_shd.sanitize_specs(specs, avals, mesh)
        assert out["a"] == P(None, "data")   # 'model' axis missing
        assert out["b"] == P("data")          # 'pod' dropped from tuple
        assert out["c"] == P("data")          # 3 % 1 == 0 → kept

    def test_partition_spec_semantics_match_jax(self):
        for dims in [(), (None,), ("a",), (("a",),), (("a", "b"), None),
                     ([],), (["a", "b"],), ((),), ("a", None)]:
            assert tuple(P(*dims)) == tuple(JP(*dims)), dims
        assert P() != P(None) and P("a") == P(("a",))
        assert P("a", None) != P("a")

    def test_named_placements(self):
        from torch.distributed.tensor import Replicate, Shard

        mesh = port_mesh.make_production_mesh(multi_pod=True)
        sh = port_shd.named(mesh, {"w": P(("data", "pod"), "model"),
                                   "s": P(), "n": None})
        assert sh["n"] is None
        assert sh["w"].device_mesh is None          # abstract mesh
        assert sh["w"].placements == (Shard(0), Shard(0), Shard(1))
        assert sh["s"].placements == (Replicate(),) * 3
        with pytest.raises(ValueError):
            port_shd.named(mesh, P("expert"))

    def test_batch_axes_and_dp(self):
        from repro_torch.configs.common import all_axes, dp

        sp = port_mesh.make_production_mesh()
        mp = port_mesh.make_production_mesh(multi_pod=True)
        assert port_shd.batch_axes(sp) == ("data",)
        assert port_shd.batch_axes(mp) == ("pod", "data")
        assert port_shd.batch_axes(port_mesh.Mesh(("x",), (2,))) == ("x",)
        assert dp(mp) == ("pod", "data") and all_axes(sp) == ("data",
                                                              "model")
        assert mp.size == 512 and sp.size == 256

    def test_rules_accept_jax_paths(self):
        path = (jax.tree_util.DictKey("groups"),
                jax.tree_util.SequenceKey(0), jax.tree_util.DictKey("attn"),
                jax.tree_util.DictKey("wo"))
        assert port_shd.lm_rules(path, (2, 64, 32)) == \
            ref_shd.lm_rules(path, (2, 64, 32))


# -- the models on the mesh ---------------------------------------------------
# Tolerances.  The mesh run against the one-process run of the same
# ``fn``: a bag, a segment or a product whose terms span ranks is summed
# in another order (float32), ``MESH_F32``.  Against the JAX package's
# ``fn``: outputs, losses and gradient norms at the float32 tolerance of
# the port's model tests (``JAX_F32``), a step's parameters at that of
# its train-step tests (``STEP_F32``).  AdamW's first moment, a tenth
# of the clipped gradient (elements of 1e-5 to 1e-2), at ``MOMENT_F32``
# against both: NequIP's force terms, summed in another order on the
# mesh, move it by up to 1.2e-7.
MESH_F32 = dict(rtol=1e-5, atol=1e-6)
JAX_F32 = dict(rtol=2e-5, atol=2e-5)
STEP_F32 = dict(rtol=1e-5, atol=1e-6)
MOMENT_F32 = dict(rtol=1e-4, atol=1e-6)
# What a lowering reads of a mesh: its axis names (the cells' (2, 2)).
MODEL_MESH = SimpleNamespace(axis_names=("data", "model"),
                             devices=np.empty((2, 2), dtype=np.uint8))


def _np_paths(tree) -> dict:
    return {k: np.asarray(v) for k, v in _jax_flat(tree).items()}


@pytest.fixture(scope="module")
def recsys_models(tmp_path_factory) -> dict:
    """The JAX initialisers' smoke parameters of DLRM-RM2, DeepFM and
    two-tower under ``dir/params``; the ``recsys_models`` case run on
    them (one subprocess of 4 ranks), and meanwhile every cell's JAX
    ``fn`` on the same parameters and batches (``"jax"``)."""
    from repro.models import recsys as ref_rs

    d = tmp_path_factory.mktemp("recsys_models")
    (d / "params").mkdir()
    init = {"dlrm": ref_rs.dlrm_init, "deepfm": ref_rs.deepfm_init,
            "twotower": ref_rs.twotower_init}
    for arch_id, kind in cases.RECSYS_KINDS.items():
        np.savez(d / "params" / f"{arch_id}.npz", **_np_paths(
            init[kind](jax.random.PRNGKey(cases.SEED),
                       _ref_smoke_cfg(arch_id))))
    proc = start_spmd_case("recsys_models", d, world=cases.MODEL_WORLD)
    want = {(a, s): _jax_recsys_cell(d, a, s) for a in cases.RECSYS_KINDS
            for s in cases.RECSYS_SHAPES}
    return {"dir": d, "jax": want, "result": finish_spmd_case(proc, d)}


@pytest.fixture(scope="module")
def nequip_models(tmp_path_factory) -> dict:
    """The JAX ``nequip_init`` parameters of each graph shape's smoke
    configuration under ``dir/params``; the ``nequip_models`` case run
    on them (one subprocess of 4 ranks), and meanwhile every cell's JAX
    step (``"jax"``); then, one after the other, each on its own clock,
    the ``one_rank_models`` case (one rank: ``"one_rank"``) and the
    ``production_graphs`` case (a fake process group:
    ``"production"``)."""
    from repro.models import nequip as ref_nq

    d = tmp_path_factory.mktemp("nequip_models")
    (d / "params").mkdir()
    for shape in cases.GNN_SHAPES:
        np.savez(d / "params" / f"nequip|{shape}.npz", **_np_paths(
            ref_nq.nequip_init(jax.random.PRNGKey(cases.SEED),
                               _ref_graph_cfg(shape))))
    proc = start_spmd_case("nequip_models", d, world=cases.MODEL_WORLD)
    want = {s: _jax_nequip_cell(d, s) for s in cases.GNN_SHAPES}
    return {"dir": d, "jax": want, "result": finish_spmd_case(proc, d),
            "one_rank": run_spmd_case("one_rank_models", d / "one_rank",
                                      world=1),
            "production": run_spmd_case("production_graphs",
                                        d / "production", world=1)}


def _ref_smoke_cfg(arch_id: str):
    import importlib

    return importlib.import_module(
        f"repro.configs.{port_configs._MODULES[arch_id]}")._smoke()


def _ref_graph_cfg(shape: str):
    import dataclasses

    from repro.configs import common as ref_common
    from repro.configs import nequip as ref_nqc

    info = ref_common.GNN_SHAPES[shape]
    return dataclasses.replace(ref_nqc._smoke(), d_feat=info["d_feat"],
                               n_out=info["n_out"], readout=info["readout"])


def _ref_opt():
    from repro.train.optimizer import OptimizerConfig

    return OptimizerConfig(**cases.MODEL_OPT)


def _cell_results(models: dict, name: str) -> dict:
    """{"plain": {...}, "dist": {...}} of a cell from its subprocess."""
    z = np.load(models["dir"] / f"{name}.npz")
    out = {"plain": {}, "dist": {}}
    for key in z.files:
        run, _, leaf = key.partition("/")
        out[run][leaf] = z[key]
    return out


def _jax_run(low, params, args: tuple) -> dict:
    """The JAX lowering's ``fn`` (under ``jax.jit``) as ``_run_cell``
    reports the port's."""
    from repro.train.train_state import init_train_state

    fn = jax.jit(low.fn)
    if low.kind == "train":
        new, metrics = fn(init_train_state(params, _ref_opt()), *args)
        out = {f"params/{k}": v for k, v in _np_paths(new["params"]).items()}
        out.update({f"m/{k}": v
                    for k, v in _np_paths(new["opt"]["m"]).items()})
        out["loss"] = np.asarray(metrics["loss"])
        out["grad_norm"] = np.asarray(metrics["grad_norm"])
        return out
    return {"out": np.asarray(fn(params, *args))}


def _jax_recsys_cell(d: Path, arch_id: str, shape: str) -> dict:
    from repro.configs import common as ref_common

    kind = cases.RECSYS_KINDS[arch_id]
    cfg = _ref_smoke_cfg(arch_id)
    low = ref_common.recsys_arch(arch_id, kind, cfg, cfg,
                                 _ref_opt()).lowering(shape, MODEL_MESH)
    params = _jax_params(d, arch_id)
    batch = {k: jnp.asarray(v) for k, v in
             cases.recsys_batch(kind, cfg, shape).items()}
    args = (batch["user_ids"], batch["cand_ids"]) if "cand_ids" in batch \
        else (batch,)
    return _jax_run(low, params, args)


def _jax_nequip_cell(d: Path, shape: str) -> dict:
    from repro.configs import common as ref_common
    from repro.configs import nequip as ref_nqc

    smoke = ref_nqc._smoke()
    low = ref_common.gnn_arch("nequip", smoke, smoke, _ref_opt()).lowering(
        shape, MODEL_MESH)
    batch = {k: jnp.asarray(v) for k, v in
             cases.graph_batch(ref_common.GNN_SHAPES[shape]).items()}
    return _jax_run(low, _jax_params(d, f"nequip|{shape}"), (batch,))


def _jax_params(d: Path, name: str) -> dict:
    """The saved parameters as the JAX tree the initialiser built."""
    z = np.load(d / "params" / f"{name}.npz")
    return _nested({k: jnp.asarray(z[k]) for k in z.files})


def _nested(flat: dict) -> dict:
    """{"a/0/b": x} as nested dicts, and lists where every key of a level
    is an index of the JAX initialisers' layer lists (``layers``)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parts, last = path.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node, key=None):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v, k) for k, v in node.items()}
        if key == "layers":
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


def _assert_cell(got: dict, want: dict, exact: bool) -> None:
    plain, mesh = got["plain"], got["dist"]
    assert set(plain) == set(mesh) == set(want), (sorted(plain),
                                                   sorted(want))
    for key, w in want.items():
        if exact:
            assert mesh[key].tobytes() == plain[key].tobytes(), key
        else:
            np.testing.assert_allclose(
                mesh[key], plain[key], **(MOMENT_F32 if key.startswith("m/")
                                          else MESH_F32),
                err_msg=f"mesh vs plain {key}")
        tol = STEP_F32 if key.startswith("params/") else MOMENT_F32 \
            if key.startswith("m/") else JAX_F32
        np.testing.assert_allclose(mesh[key], w, **tol,
                                   err_msg=f"mesh vs JAX {key}")


# -- (d) TestSPMDExecution counterparts on gloo -------------------------------
class TestSPMDExecution:
    def test_sharded_train_step_matches_single_device(self, tmp_path):
        res = run_spmd_case("train_step", tmp_path)
        for accum in ("accum1", "accum2"):
            r = res[accum]
            assert r["err"] < 1e-5 and r["m_err"] < 1e-5, (accum, r)
            assert r["placements"] == ["R", "S(1)"]
            assert r["local_shape"] == [16, 2]
            assert r["m_local_shape"] == [8, 2]
        # the microbatch split stays on the data axis
        assert res["micro_placements"] == ["S(1)", "R"]
        assert res["micro_local_shape"] == [2, 8, 16]

    def test_quantized_psum(self, tmp_path, jax_spmd):
        res = run_spmd_case("quantized_psum", tmp_path)
        assert all(r < 0.05 for r in res["rel"])   # int8 error bound
        assert all(res["ranks_agree"])
        assert res["hex"] == jax_spmd["hex"]

    def test_row_sharded_embedding_lookup(self, tmp_path):
        res = run_spmd_case("embedding_lookup", tmp_path)
        assert res["err"] == 0.0 and res["local_rows"] == 8

    def test_supervisor_restores_onto_the_mesh(self, tmp_path):
        res = run_spmd_case("supervisor", tmp_path)
        assert res["restarts"] == 1 and res["step"] == 6
        assert res["err"] < 1e-5
        assert res["placements"] == ["R", "S(1)"]

    # -- the models on the mesh: one subprocess of 4 ranks a family --------
    @pytest.mark.parametrize("shape", cases.RECSYS_SHAPES)
    @pytest.mark.parametrize("arch_id", tuple(cases.RECSYS_KINDS))
    def test_recsys_cell_on_the_mesh(self, recsys_models, arch_id, shape):
        """The cell's ``fn`` on DTensors over a (2, 2) mesh against the
        same ``fn`` on plain tensors in one process (bit for bit where no
        reduction crosses ranks: DLRM and DeepFM serving, one id a bag;
        else ``MESH_F32``), and against the JAX lowering's ``fn`` from the
        same weights and batch (``STEP_F32`` for a step's parameters,
        ``JAX_F32`` for outputs and the loss)."""
        got = _cell_results(recsys_models, f"{arch_id}|{shape}")
        want = recsys_models["jax"][arch_id, shape]
        _assert_cell(got, want, exact=cases.RECSYS_KINDS[arch_id] !=
                     "twotower" and shape != "train_batch")

    def test_recsys_ranks_read_only_their_rows(self, recsys_models):
        """Each rank's B6 and B1 calls on the mesh were handed its own
        rows of each row-sharded table (half of them on the 2-way
        "model" axis), and each rank holds only those."""
        res = recsys_models["result"]
        rows = {"dlrm-rm2": 4 * 128 // 2, "deepfm": 6 * 64 // 2,
                "two-tower-retrieval": 128 // 2}
        kernel = {"dlrm-rm2": "gather_rows_bag", "deepfm": "gather_rows_bag",
                  "two-tower-retrieval": "gather_rows"}
        for arch_id, per_rank in res["rows_seen"].items():
            assert len(per_rank) == cases.MODEL_WORLD
            for seen in per_rank:
                assert seen == [[kernel[arch_id], rows[arch_id]]], \
                    (arch_id, seen)
        assert res["local_tables"] == {
            "dlrm-rm2": {"bags/tables": [4, 64, 8]},
            "deepfm": {"bags/tables": [6, 32, 4],
                       "linear/tables": [6, 32, 1]},
            "two-tower-retrieval": {"user_embed/table": [64, 16],
                                    "item_embed/table": [64, 16]}}

    @pytest.mark.parametrize("shape", cases.GNN_SHAPES)
    def test_nequip_cell_on_the_mesh(self, nequip_models, shape):
        """One NequIP train step on DTensors (nodes and edges sharded 4
        ways, the message sums B7 on each rank's edges then
        reduce-scattered) against the plain step (``MESH_F32``) and the
        JAX step (``STEP_F32``; the loss ``JAX_F32``)."""
        got = _cell_results(nequip_models, f"nequip|{shape}")
        want = nequip_models["jax"][shape]
        _assert_cell(got, want, exact=False)

    def test_segments_on_rows_that_do_not_split_evenly(self,
                                                        nequip_models):
        """B7's sums and gathers on the (2, 2) mesh over 7 node rows
        (2, 2, 2, 1 a rank, ``DTensor``'s layout), their gradient and its
        gradient, in float64: within 1e-12 of the plain run (the ranks'
        sums add in another order)."""
        errs = nequip_models["result"]["uneven"]
        assert set(errs) == {"sums", "grad", "grad_grad"}
        assert max(errs.values()) < 1e-12, errs

    @pytest.mark.parametrize("shape", cases.PRODUCTION_GRAPHS)
    @pytest.mark.parametrize("sizes", ((16, 16), (2, 16, 16)))
    def test_graph_cell_on_a_production_mesh(self, nequip_models, sizes,
                                             shape):
        """The cell's train step at its published node and edge counts
        runs on the JAX production mesh (a fake process group of 256 or
        512 ranks, one of them here): a molecule batch's 128 per-graph
        energies over 256 ranks split unevenly.  The parameters keep
        their local shapes and placements; loss and gradient norm are
        scalars."""
        got = nequip_models["production"][f"{tuple(sizes)}|{shape}"]
        assert got == {"same_layout": True, "loss": [], "grad_norm": []}

    def test_cells_on_a_one_rank_mesh_are_bit_equal(self, nequip_models):
        """On a (1, 1) mesh no reduction crosses ranks: each of the 16
        cells' ``fn`` on DTensors equals its plain-tensor run to the
        bit (the contract the card's ``sharded_models`` phase holds at
        published width)."""
        res = nequip_models["one_rank"]
        assert len(res["cells"]) == 16
        assert res["differ"] == {}

    def test_elastic_checkpoint_reshard(self, tmp_path):
        """Save on a (4, 2) mesh, restore onto (2, 4)."""
        res = run_spmd_case("elastic_reshard", tmp_path)
        assert res["err"] == 0.0 and res["b_err"] == 0.0
        assert res["ndev"] == 8 and res["mesh"] == [2, 4]
        assert res["local_shape"] == [8, 4] and res["step"] == 7
        assert res["refused_untouched"]
        assert res["files"] == ["manifest.json"] + [
            f"shard_h{k}.npz" for k in range(8)]
        manifest = json.loads((tmp_path / "ckpt" / "step_000000001" /
                               "manifest.json").read_text())
        assert manifest["n_hosts"] == 8
        # Each distinct shard once: 8 of w, 1 of the replicated b.
        assert len(manifest["tree"]["w"]["shards"]) == 8
        assert len(manifest["tree"]["b"]["shards"]) == 1


# -- (g) checkpoints across the packages --------------------------------------
def test_port_sharded_checkpoint_restores_in_jax(tmp_path):
    run_spmd_case("save_for_foreign", tmp_path)
    target = {"params": {"w": jax.ShapeDtypeStruct((16, 16), jnp.float32)},
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    back = ref_ckpt.restore_checkpoint(tmp_path / "port", 3, target)
    want = cases.checkpoint_array()
    got = np.asarray(back["params"]["w"])
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert int(back["step"]) == 3
    manifest = json.loads((tmp_path / "port" / "step_000000003" /
                           "manifest.json").read_text())
    idx = sorted(tuple(map(tuple, s["index"]))
                 for s in manifest["tree"]["params/w"]["shards"])
    assert idx == sorted(((4 * i, 4 * i + 4), (8 * j, 8 * j + 8))
                         for i in range(4) for j in range(2))


def test_jax_sharded_checkpoint_restores_on_port_mesh(tmp_path, jax_spmd):
    assert jax_spmd["n_shards"] == 8
    d = tmp_path / "run"
    d.mkdir()
    (d / "foreign").symlink_to(jax_spmd["dir"] / "foreign")
    res = run_spmd_case("restore_foreign", d)
    assert res["equal"] and res["local_shape"] == [8, 4]


def test_jax_sharded_checkpoint_restores_whole_on_port(jax_spmd):
    """Without ``shardings``, the plain-tensor restore puts the 8 saved
    shards together."""
    from repro_torch.train import checkpoint as port_ckpt

    target = {"w": torch.zeros((16, 16))}
    port_ckpt.restore_checkpoint(jax_spmd["dir"] / "foreign", 5, target)
    assert target["w"].numpy().tobytes() == \
        cases.checkpoint_array().tobytes()


def test_plain_state_files_unchanged(tmp_path):
    """A state of plain tensors keeps one shard file, each leaf whole."""
    from repro_torch.train import checkpoint as port_ckpt

    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(2, dtype=torch.int32)}}
    port_ckpt.save_checkpoint(tmp_path, 4, state)
    d = tmp_path / "step_000000004"
    assert sorted(f.name for f in d.iterdir()) == ["manifest.json",
                                                   "shard_h0.npz"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["n_hosts"] == 1
    assert manifest["tree"]["params/w"]["shards"] == [
        {"index": [[0, 2], [0, 3]], "file_key": "params/w#0-2_0-3",
         "host": 0}]
    assert manifest["tree"]["opt/step"]["shards"][0]["file_key"] == \
        "opt/step#scalar"


def test_restore_checks_every_leaf_before_writing(tmp_path):
    """Shards that do not cover a later leaf are found before the first
    leaf is written: the target stays as it was."""
    from repro_torch.train import checkpoint as port_ckpt

    port_ckpt.save_checkpoint(tmp_path, 1, {"a": torch.ones(3),
                                            "b": torch.ones(4)})
    path = tmp_path / "step_000000001" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["tree"]["b"]["shards"][0]["index"] = [[0, 2]]
    path.write_text(json.dumps(manifest))
    target = {"a": torch.zeros(3), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="b"):
        port_ckpt.restore_checkpoint(tmp_path, 1, target)
    assert not target["a"].any() and not target["b"].any()


def test_read_region_puts_shards_together_and_rejects_gaps():
    from repro_torch.train.checkpoint import read_region

    info = {"dtype": "float32", "shards": [
        {"index": [[0, 2]], "file_key": "a"},
        {"index": [[2, 4]], "file_key": "b"}]}
    arrays = {"a": np.array([1, 2], np.float32),
              "b": np.array([3, 4], np.float32)}
    assert read_region(info, arrays, [[0, 2]]) is arrays["a"]
    assert read_region(info, arrays, [[1, 3]]).tolist() == [2, 3]
    assert read_region(info, arrays, [[0, 4]]).tolist() == [1, 2, 3, 4]
    with pytest.raises(ValueError):
        read_region(info, arrays, [[0, 6]])


def test_open_shards_maps_what_np_load_reads(tmp_path):
    from repro_torch.train.checkpoint import _open_shards

    rng = np.random.default_rng(0)
    arrays = {"w#0-3_0-5": rng.normal(size=(3, 5)).astype(np.float32),
              "s#scalar": np.array(7, np.int32),
              "e#0-0": np.zeros((0,), np.float64),
              "f#0-4_0-2": np.asfortranarray(rng.normal(size=(4, 2))),
              "big/a#0-70000": rng.integers(0, 9, 70_000).astype(np.int64)}
    np.savez(tmp_path / "shard_h0.npz", **arrays)
    got = _open_shards(tmp_path / "shard_h0.npz")
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert np.array_equal(got[k], v), k
    assert isinstance(got["w#0-3_0-5"], np.memmap)
    np.savez_compressed(tmp_path / "c.npz", **arrays)
    got = _open_shards(tmp_path / "c.npz")
    assert all(np.array_equal(got[k], v) for k, v in arrays.items())


def test_shard_index_is_torch_chunk():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.train.checkpoint import shard_index

    # 10 rows over 4: chunks of 3, 3, 3, 1
    got = [shard_index((10, 4), (Shard(0),), (c,), (4,))[0]
           for c in range(4)]
    assert got == [[0, 3], [3, 6], [6, 9], [9, 10]]
    assert [list(map(len, torch.arange(10).chunk(4)))] == \
        [[b - a for a, b in got]]
    # two mesh dims on one tensor dim: the first is the major one
    got = shard_index((16,), (Shard(0), Shard(0)), (1, 1), (2, 4))
    assert got == [[10, 12]]
    assert shard_index((16, 4), (Replicate(), Shard(1)), (1, 1),
                       (2, 2)) == [[0, 16], [2, 4]]


# -- (e) the mesh context -----------------------------------------------------
class TestContext:
    def test_filter(self):
        f = port_ctx._filter
        axes = ("data", "model")
        assert f(None, axes) is None
        assert f("data", axes) == "data"
        assert f("pod", axes) is None
        assert f(("pod", "data"), axes) == "data"
        assert f(("data", "model"), axes) == ("data", "model")
        assert f(("pod", "expert"), axes) is None

    def test_filter_matches_jax(self):
        from repro.distributed import context as ref_ctx

        for entry in [None, "data", "pod", ("pod", "data"),
                      ("data", "model"), ("x",)]:
            for axes in [(), ("data",), ("pod", "data", "model")]:
                assert port_ctx._filter(entry, axes) == \
                    ref_ctx._filter(entry, axes)

    def test_constrain_without_mesh_is_identity(self):
        x = torch.ones(4, 2)
        assert port_ctx.mesh_axes() == ()
        assert port_ctx.constrain(x, "data", None) is x

    def test_mesh_context_sets_and_resets(self):
        mesh = port_mesh.make_production_mesh(multi_pod=True)
        x = torch.ones(4, 2)
        with port_ctx.mesh_context(mesh) as m:
            assert m is mesh
            assert port_ctx.mesh_axes() == ("pod", "data", "model")
            # a plain tensor has no placement to change
            assert port_ctx.constrain(x, port_ctx.DP, None) is x
            assert port_ctx.constrain(x, "expert", None) is x
        assert port_ctx.mesh_axes() == ()

    def test_set_mesh_axes(self):
        import contextvars

        def inner():
            port_ctx.set_mesh_axes(["data"])
            return port_ctx.mesh_axes()

        assert contextvars.copy_context().run(inner) == ("data",)
        assert port_ctx.mesh_axes() == ()


def test_initialize_distributed_is_a_noop_without_coordinator(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("REPRO_COORDINATOR", raising=False)
    port_mesh.initialize_distributed()
    assert not dist.is_initialized()


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError):
        port_mesh.make_host_mesh(1, 1)


def test_production_meshes_match_jax():
    assert port_mesh.make_production_mesh().axis_sizes == (16, 16)
    mp = port_mesh.make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model")
    assert mp.axis_sizes == (2, 16, 16)
    assert mp.device_mesh is None


# -- (f) C14: a run of 2³¹ elements -------------------------------------------
def test_c14_run_of_2_31_elements_on_expanded_view():
    view = torch.zeros(1, dtype=torch.uint8).expand(2 ** 31)
    starts, lengths, offsets, n_points = gops.plan_run_inputs(
        view, np.array([0]), np.array([2 ** 31]))
    assert n_points == 2 ** 31
    assert starts.dtype == lengths.dtype == torch.int32
    assert int(lengths.min()) > 0
    assert int(lengths.to(torch.int64).sum()) == 2 ** 31
    assert offsets.tolist() == [0, 2 ** 31 - 1, 2 ** 31]
    # each piece reads on from where the one before ended
    assert starts.tolist() == [0, 2 ** 31 - 1]


def test_c14_pieces_keep_every_point():
    starts = np.array([4, 0, 50, 9])
    lengths = np.array([3, 0, 23, 10])
    s, n = gops.split_long_runs(starts, lengths, most=7)
    assert n.max() <= 7 and n.sum() == lengths.sum()
    flat = np.arange(100)
    want = np.concatenate([flat[a:a + k] for a, k in zip(starts, lengths)])
    got = np.concatenate([flat[a:a + k] for a, k in zip(s, n)])
    assert np.array_equal(got, want)
    flat_t = torch.arange(100, dtype=torch.int64)
    # the plain B2 on pieces that fit equals the runs' read
    assert np.array_equal(
        gops.gather_plan_runs(flat_t, s, n).numpy(), want)


# -- the lint over the port ---------------------------------------------------
def test_jax_lint_finds_nothing_in_the_port():
    """The JAX package's lint (its int32-cast and lock rules) over
    ``src/repro_torch``: no diagnostic."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--lint", "--locks",
         "--root", str(REPO / "src" / "repro_torch")], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stdout[-3000:]
    assert "diagnostic" not in out.stdout
    assert "all checks clean" in out.stdout
