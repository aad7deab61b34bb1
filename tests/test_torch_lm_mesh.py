"""The port's decoders on DTensors == the plain path and the JAX package,
on the CPU.

The five LMs (GLM-4, Granite, Yi, DeepSeek-V3, Arctic) and BERT4Rec run
every cell's ``Lowering.fn`` (train step, prefill, decode, serving) on a
mesh of gloo ranks, from the parameters the JAX initialisers drew
(``tests/torch_lm_spmd_cases.py``, each case one subprocess of 4 ranks,
or 1, with a limit of its own, ``CASE_LIMIT_S``; the cases share no
process with JAX).  Meanwhile
this process runs the JAX lowering's ``fn`` under ``jax.jit`` on the same
parameters and inputs.  Each cell on the (2, 2) mesh is held against the
same ``fn`` on plain tensors (``MESH_F32``; AdamW's first moment
``MOMENT_F32``) and against the JAX ``fn`` (``STEP_F32`` for a step's
parameters, ``MOMENT_F32`` for its first moment, ``JAX_F32`` for logits,
caches, losses and ``grad_norm``): the tolerances of
``tests/test_torch_distributed.py``.  Every cell runs at its
architecture's smoke width and the cases' smoke sizes
(``cases.SMOKE_SHAPES``; the JAX lowering reads them through its own
``LM_SHAPES``).

Also: GLM-4's 2 KV heads and Yi's 7 heads and 1 KV head on a (1, 4) mesh;
Yi, DeepSeek and Arctic trained with every weight FSDP-sharded over
"data"; the MoE layer's capacity drops on groups that fall on the data
shards, straddle them, or fall back to one group; what each rank holds
(B1's rows, the cross-entropy's and the head's columns, the grouped
GEMM's experts: a half each on the 2-way "model" axis) and that no decode
redistributes its cache; all 24 cells on a one-rank mesh bit for bit
equal to the plain path; and all 24 on the JAX production mesh (16, 16)
as rank 0 of a fake process group of 256 (layouts only).  On one card,
in this process: labels, token ids and decode positions out of range
raise ``IndexError``, and the serving engine reads no ids back.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import common as ref_common  # noqa: E402
from repro.models import recsys as ref_rs  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train.optimizer import OptimizerConfig as RefOpt  # noqa: E402
from repro.train.train_state import init_train_state  # noqa: E402

import torch_lm_spmd_cases as cases  # noqa: E402
from test_torch_distributed import (JAX_F32, MESH_F32,  # noqa: E402
                                    MOMENT_F32, SPMD_TIMEOUT_S, STEP_F32)

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
TESTS = Path(__file__).resolve().parent
# What a JAX lowering reads of a mesh: its axis names (the cells' (2, 2)).
MODEL_MESH = SimpleNamespace(axis_names=("data", "model"),
                             devices=np.empty((2, 2), dtype=np.uint8))
_MODULES = {"deepseek-v3-671b": "deepseek_v3_671b",
            "arctic-480b": "arctic_480b", "glm4-9b": "glm4_9b",
            "yi-34b": "yi_34b", "granite-3-8b": "granite_3_8b",
            "bert4rec": "bert4rec"}
# The subprocess cases, (name, case, ranks, arguments), the longest
# first; at most ``PARALLEL`` run at once, each within its own limit of
# its own start (``case_limit``).
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
UNEVEN = ("glm4-9b", "yi-34b")
CASES = (
    [(f"{a}|train", "lm_cells", 4, (a, "train_4k")) for a in cases.LM_IDS]
    + [(f"{a}|serve", "lm_cells", 4, (a, *SERVE_SHAPES))
       for a in cases.LM_IDS]
    + [(f"{a}|fsdp", "lm_fsdp", 4, (a,)) for a in cases.FSDP_ARCHS]
    + [(f"{a}|1x4", "uneven_heads", 4, (a,)) for a in UNEVEN]
    + [("bert4rec", "bert4rec_cells", 4, ()),
       ("moe", "moe_capacity", 4, ()),
       ("production", "production_lm", 1, ())]
    + [(f"{a}|one_rank", "one_rank_lm", 1, (a,))
       for a in (*cases.LM_IDS, "bert4rec")])
PARALLEL = 2
# Each case's time limit: about 6x its own seconds alone on 8 CPU cores
# (the ``seconds`` each case writes; beside the rest of the suite on six
# workers a case took up to 4x its time alone), and at least 120 s
# (``SPMD_TIMEOUT_S``, the limit of a case not named here).  Alone:
# DeepSeek-V3's train 37.6, production 37.9, DeepSeek-V3's FSDP 31.4,
# Arctic's train 28.1, GLM-4's and Yi's (1, 4) 22.2 and 22.6, Arctic's
# FSDP 20.3, every other case under 20.
CASE_LIMIT_S = {"deepseek-v3-671b|train": 300, "production": 240,
                "deepseek-v3-671b|fsdp": 240, "arctic-480b|train": 240,
                "glm4-9b|1x4": 180, "yi-34b|1x4": 180,
                "arctic-480b|fsdp": 180}


def case_limit(name: str) -> float:
    return CASE_LIMIT_S.get(name, SPMD_TIMEOUT_S)


def _ref_cfg(arch_id: str):
    import importlib

    return importlib.import_module(
        f"repro.configs.{_MODULES[arch_id]}")._smoke()


def _np_paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(flat: dict, groups: bool) -> dict:
    """{"groups/0/attn/wq": x} as the JAX tree (``groups`` a list)."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        *parts, last = path.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    if groups:
        root["groups"] = [root["groups"][str(i)]
                          for i in range(len(root["groups"]))]
    return root


def _jax_arch(arch_id: str):
    cfg = _ref_cfg(arch_id)
    opt = RefOpt(**cases.MODEL_OPT)
    if arch_id == "bert4rec":
        return ref_common.recsys_arch(arch_id, "bert4rec", cfg, cfg, opt), cfg
    return ref_common.lm_arch(arch_id, cfg, cfg, opt,
                              fsdp=arch_id not in cases.NO_FSDP), cfg


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_tree(v) for v in tree)
    return jnp.asarray(tree)


def _jax_cell(arch_id: str, shape: str, params: dict, pcfg) -> dict:
    """The JAX lowering's ``fn`` under ``jax.jit`` on ``params`` and the
    cases' inputs, as ``cases.results`` reports the port's."""
    arch, _ = _jax_arch(arch_id)
    with pytest.MonkeyPatch.context() as mp:
        for name, info in cases.SMOKE_SHAPES.items():
            mp.setitem(ref_common.LM_SHAPES, name, info)
        low = arch.lowering(shape, MODEL_MESH)
    args = _jax_tree(cases.cell_args(arch_id, pcfg, shape))
    fn = jax.jit(low.fn)
    if low.kind == "train":
        new, metrics = fn(init_train_state(params, RefOpt(
            **cases.MODEL_OPT)), *args)
        out = {f"params/{k}": v for k, v in _np_paths(new["params"]).items()}
        out.update({f"m/{k}": v
                    for k, v in _np_paths(new["opt"]["m"]).items()})
        out["loss"] = np.asarray(metrics["loss"])
        out["grad_norm"] = np.asarray(metrics["grad_norm"])
        return out
    got = fn(params, *args)
    if low.kind in ("prefill", "decode"):
        logits, caches = got
        return {"out": np.asarray(logits),
                **{f"caches/{k}": v for k, v in _np_paths(caches).items()}}
    return {"out": np.asarray(got)}


def _start(name: str, case: str, world: int, d: Path, args: tuple):
    """A case of ``tests/torch_lm_spmd_cases.py`` started in ``d``, its
    output to ``d/log`` (never a pipe that could fill), with the limit of
    the entry ``name`` of ``CASES``."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    with open(d / "log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(TESTS / "torch_lm_spmd_cases.py"), case,
             str(world), str(d), *args], env=env, stdout=log,
            stderr=subprocess.STDOUT)
    proc.started = time.monotonic()
    proc.limit = case_limit(name)
    return proc


def _result(proc, d: Path):
    """A started case's result (with the seconds the case measured from
    its start to its ranks' end), or its failure as a string; a case
    past its limit from its start is killed."""
    try:
        proc.wait(timeout=max(
            1.0, proc.limit - (time.monotonic() - proc.started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return f"killed after {proc.limit} s"
    if proc.returncode:
        return (d / "log").read_text()[-3000:]
    return json.loads((d / "result.json").read_text())


@pytest.fixture(scope="module")
def lm_mesh(tmp_path_factory) -> dict:
    """The JAX initialisers' smoke parameters of the five LMs and BERT4Rec
    under ``dir/params``; every case of ``CASES`` run on them (``PARALLEL``
    at a time, each in a directory of its own that links those
    parameters), and meanwhile every (2, 2) cell's JAX ``fn``."""
    from repro_torch.configs import train as tc

    root = tmp_path_factory.mktemp("lm_mesh")
    (root / "params").mkdir()
    flat = {}
    for arch_id in _MODULES:
        cfg = _ref_cfg(arch_id)
        init = ref_rs.bert4rec_init if arch_id == "bert4rec" else \
            ref_tf.init_params
        flat[arch_id] = _np_paths(init(jax.random.PRNGKey(cases.SEED), cfg))
        np.savez(root / "params" / f"{arch_id}.npz", **flat[arch_id])
    pending = list(CASES)
    running, results = {}, {}

    def step(block: bool = False):
        """Collect the cases that ended (with ``block``, the oldest one
        whenever it ends), then start cases into the free slots."""
        for name, (proc, d) in list(running.items()):
            if block or proc.poll() is not None:
                results[name] = (_result(proc, d), d)
                del running[name]
                block = False
        while pending and len(running) < PARALLEL:
            name, case, world, args = pending.pop(0)
            d = root / name.replace("|", "_")
            d.mkdir()
            (d / "params").symlink_to(root / "params")
            running[name] = (_start(name, case, world, d, args), d)

    want = {}
    step()
    jobs = [(a, s) for a in cases.LM_IDS for s in cases.LM_SHAPES] + \
        [("bert4rec", s) for s in cases.BERT_SHAPES]
    for arch_id, shape in jobs:
        pcfg = tc.module_of(arch_id)._smoke()
        want[arch_id, shape] = _jax_cell(
            arch_id, shape, _nested(flat[arch_id], groups=True), pcfg)
        step()
    while running or pending:
        step(block=True)
    return {"jax": want, "cases": results}


def _case(lm_mesh, name: str) -> tuple:
    res, d = lm_mesh["cases"][name]
    assert isinstance(res, dict), f"case {name} failed:\n{res}"
    return res, d


def _cell_results(d: Path, name: str) -> dict:
    z = np.load(d / f"{name}.npz")
    out = {"plain": {}, "dist": {}}
    for key in z.files:
        run, _, leaf = key.partition("/")
        out[run][leaf] = z[key]
    return out


def _assert_cell(got: dict, want: dict) -> None:
    """The mesh run against the plain run and the JAX ``fn``.  Against
    the plain run a step's parameters, loss and ``grad_norm`` are held
    at ``MESH_F32`` and its first moment at ``MOMENT_F32``; a prefill's
    or decode's logits and caches at ``JAX_F32``, the float32 tolerance
    of the port's model outputs: their new rows pass through RMSNorm
    (MLA's latent reduced over its sharded rank), whose elements near
    zero carry the rounding of the whole row (1.2e-6 on an element of
    1.3e-3 in DeepSeek's decode), past ``MESH_F32``'s 1e-6."""
    plain, mesh = got["plain"], got["dist"]
    assert set(plain) == set(mesh) == set(want), (sorted(mesh),
                                                   sorted(want))
    for key in plain:
        tol = MOMENT_F32 if key.startswith("m/") else JAX_F32 \
            if key == "out" or key.startswith("caches/") else MESH_F32
        np.testing.assert_allclose(mesh[key], plain[key], **tol,
                                   err_msg=f"mesh vs plain {key}")
        tol = STEP_F32 if key.startswith("params/") else MOMENT_F32 \
            if key.startswith("m/") else JAX_F32
        np.testing.assert_allclose(mesh[key], want[key], **tol,
                                   err_msg=f"mesh vs JAX {key}")


def _case_of(arch_id: str, shape: str) -> str:
    if arch_id == "bert4rec":
        return "bert4rec"
    return f"{arch_id}|{'train' if shape == 'train_4k' else 'serve'}"


@pytest.mark.parametrize("shape", cases.LM_SHAPES)
@pytest.mark.parametrize("arch_id", cases.LM_IDS)
def test_lm_cell_on_the_mesh(lm_mesh, arch_id, shape):
    """The cell's ``fn`` on DTensors over a (2, 2) mesh against the same
    ``fn`` on plain tensors and against the JAX lowering's ``fn``: a
    train step's parameters, first moment, loss and ``grad_norm``
    (8 microbatches of 2 rows, one a data rank); a prefill's and a
    decode's logits and caches (the decode's updated in place)."""
    _, d = _case(lm_mesh, _case_of(arch_id, shape))
    _assert_cell(_cell_results(d, f"{arch_id}|{shape}"),
                 lm_mesh["jax"][arch_id, shape])


@pytest.mark.parametrize("shape", cases.BERT_SHAPES)
def test_bert4rec_cell_on_the_mesh(lm_mesh, shape):
    """BERT4Rec's cell on the (2, 2) mesh against the plain run and the
    JAX ``fn``: the cloze step through the tied chunked cross-entropy on
    each rank's vocabulary rows, and the scores sharded on V."""
    _, d = _case(lm_mesh, "bert4rec")
    _assert_cell(_cell_results(d, f"bert4rec|{shape}"),
                 lm_mesh["jax"]["bert4rec", shape])


@pytest.mark.parametrize("shape", cases.LM_SHAPES)
@pytest.mark.parametrize("arch_id", ("glm4-9b", "yi-34b"))
def test_heads_that_do_not_split(lm_mesh, arch_id, shape):
    """On a (1, 4) mesh GLM-4's 2 KV heads (each rank holds 8 of ``wk``'s
    32 columns: half a head) and Yi's 7 heads and 1 KV head do not split
    over "model": the cell still equals the plain run and the JAX
    ``fn``."""
    _, d = _case(lm_mesh, f"{arch_id}|1x4")
    _assert_cell(_cell_results(d, f"{arch_id}|{shape}|1x4"),
                 lm_mesh["jax"][arch_id, shape])


@pytest.mark.parametrize("arch_id", cases.FSDP_ARCHS)
def test_fsdp_step_on_the_mesh(lm_mesh, arch_id):
    """A train step with every weight of two or more dims sharded over
    "data" as well (gathered at use, layer by layer; the gradients
    reduce-scattered back) equals the plain step, and every rank's
    weights keep their FSDP placements and local shapes after it."""
    res, d = _case(lm_mesh, f"{arch_id}|fsdp")
    _assert_cell(_cell_results(d, f"{arch_id}|fsdp"),
                 lm_mesh["jax"][arch_id, "train_4k"])
    assert len(res["data_sharded"]) >= 7
    for layout in res["layout"]:
        assert set(layout) == set(res["data_sharded"])
        for key, (placements, local) in layout.items():
            # Mesh dim 0 is "data": each such weight is still split there.
            assert placements == res["want"][key], (key, placements)
            assert placements.startswith("(Shard"), (key, placements)


def _per_rank(res: dict, shape: str) -> list:
    per = res[shape]
    assert len(per) == cases.MODEL_WORLD
    return per


@pytest.mark.parametrize("arch_id", cases.LM_IDS)
def test_ranks_hold_only_their_vocabulary_and_experts(lm_mesh, arch_id):
    """On the (2, 2) mesh each rank's B1 calls were handed its own half
    of the vocabulary rows (256 / 2), its cross-entropy and its logits
    span its own half of the columns, its grouped GEMMs only its own
    half of the experts (8 / 2), and its caches only its part."""
    train, _ = _case(lm_mesh, f"{arch_id}|train")
    serve, _ = _case(lm_mesh, f"{arch_id}|serve")
    moe = arch_id in ("deepseek-v3-671b", "arctic-480b")
    for shape in cases.LM_SHAPES:
        res = train if shape == "train_4k" else serve
        for rec in _per_rank(res, shape):
            assert rec["b1"] == [128], (shape, rec)
            assert rec["experts"] == ([4] if moe else []), (shape, rec)
            if shape == "train_4k":
                assert rec["ce_cols"] == [128], rec
            else:
                assert rec["logits_local"][-1] == 128, rec
    b, s = (cases.SMOKE_SHAPES[x][k] for x, k in (("decode_32k", "batch"),
                                                  ("decode_32k", "seq")))
    for rec in _per_rank(serve, "decode_32k"):
        for group in rec["cache_local"]:
            for local in group:
                assert local[1:3] == [b // 2, s // 2], local
    s = cases.SMOKE_SHAPES["long_500k"]["seq"]
    for rec in _per_rank(serve, "long_500k"):
        for group in rec["cache_local"]:
            for local in group:
                assert local[1:3] == [1, s // 4], local


@pytest.mark.parametrize("arch_id", cases.LM_IDS)
def test_no_rank_gathers_a_decode_cache(lm_mesh, arch_id):
    """During each decode on the (2, 2) mesh ``DTensor`` redistributed no
    tensor of a cache's shape (the stacked cache or a layer's): each
    rank read and wrote only its own rows of S, and the softmax merged
    partial statistics."""
    serve, _ = _case(lm_mesh, f"{arch_id}|serve")
    for shape in ("decode_32k", "long_500k"):
        for rec in _per_rank(serve, shape):
            assert rec["moved_cache"] == [], (shape, rec)
            assert rec["n_moved"] > 0


def test_bert4rec_ranks_hold_only_their_rows(lm_mesh):
    """BERT4Rec on the (2, 2) mesh: B1 on half of the item rows (502 / 2)
    and of the 16 positions, the tied cross-entropy's chunks on half of
    the items, the scores on half of the columns."""
    res, _ = _case(lm_mesh, "bert4rec")
    for shape in cases.BERT_SHAPES:
        for rec in _per_rank(res, shape):
            assert rec["b1"] == [8, 251], (shape, rec)
            assert rec["tied_rows"] == ([251] if shape == "train_batch"
                                        else []), (shape, rec)
            if shape != "train_batch":
                assert rec["scores_local"][-1] == 251, rec


@pytest.mark.parametrize("name", tuple(cases.MOE_CASES))
def test_moe_capacity_drops_the_plain_slots(lm_mesh, name):
    """Arctic's MoE at capacity factor 0.5 on the (2, 2) mesh: the groups
    fall on the data shards (each rank routes its own), straddle them
    (3 rows over 2 ranks: the groups' tokens gathered first) or fall
    back to one group (``t % g``): the kept slots add up to the plain
    path's, and the outputs, the aux loss and the gradients of the input,
    the router and an expert weight equal it."""
    res, d = _case(lm_mesh, "moe")
    got = res[name]
    kept = [k[0] for k in got["mesh_kept"]]
    if name == "aligned":
        # Each data rank its own groups; the model ranks repeat them.
        assert kept[0] + kept[2] == got["plain_kept"][0], got
        assert kept[0] == kept[1] and kept[2] == kept[3], got
    else:
        assert kept == got["plain_kept"] * 4, got
    z = _cell_results(d, f"moe|{name}")
    for key in z["plain"]:
        np.testing.assert_allclose(z["dist"][key], z["plain"][key],
                                   **MESH_F32, err_msg=key)


def test_cells_on_a_one_rank_mesh_are_bit_equal(lm_mesh):
    """On a (1, 1) mesh no reduction crosses ranks: each of the 24 cells'
    ``fn`` on DTensors equals its plain-tensor run to the bit (the
    contract the card's ``sharded_lm`` phase holds at published
    width)."""
    cells, differ = [], {}
    for arch_id in (*cases.LM_IDS, "bert4rec"):
        res, _ = _case(lm_mesh, f"{arch_id}|one_rank")
        cells += res["cells"]
        differ.update(res["differ"])
    assert len(cells) == 24
    assert differ == {}


@pytest.mark.parametrize("arch_id", (*cases.LM_IDS, "bert4rec"))
def test_cells_on_the_production_mesh(lm_mesh, arch_id):
    """Each cell's ``fn`` runs on the JAX production mesh (16, 16) (a fake
    process group of 256 ranks, one of them here), its batch padded to
    the data extent, and returns the plain run's global shapes."""
    res, _ = _case(lm_mesh, "production")
    shapes = cases.BERT_SHAPES if arch_id == "bert4rec" else cases.LM_SHAPES
    for shape in shapes:
        assert res[f"{arch_id}|{shape}"] is True, shape


def test_every_case_stays_inside_its_limit(lm_mesh):
    """Every case finished, each well inside its own time limit."""
    for name, (res, _) in lm_mesh["cases"].items():
        assert isinstance(res, dict), f"case {name} failed:\n{res}"
        assert res["seconds"] < case_limit(name), (name, res["seconds"])



# -- ids out of range raise on one card -------------------------------------
def _plain_lm(arch_id):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config(arch_id, smoke=True)
    return tf, cfg, tf.init_params(cfg, device="cpu", seed=3)


@pytest.mark.parametrize("bad", ("below", "past"))
@pytest.mark.parametrize("where", ("cross_entropy", "loss_fn"))
def test_labels_out_of_the_vocabulary_raise(where, bad):
    """A label outside [0, V) raises ``IndexError`` on the plain path, in
    the bare loss and through the decoder's ``loss_fn`` (its one read of
    the tokens' and labels' spans), where the vocabulary-parallel NLL
    would otherwise read its gold logit as 0."""
    from repro_torch.models import layers

    tf, cfg, params = _plain_lm("glm4-9b")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    labels = tokens.clone()
    labels[1, 3] = -1 if bad == "below" else cfg.vocab
    with pytest.raises(IndexError, match="labels span"):
        if where == "cross_entropy":
            layers.cross_entropy(torch.zeros((2, 8, cfg.vocab)), labels)
        else:
            tf.loss_fn(params, cfg, tokens, labels)


@pytest.mark.parametrize("bad", ("below", "past"))
@pytest.mark.parametrize("arch_id", ("glm4-9b", "deepseek-v3-671b"))
def test_decode_positions_past_the_cache_raise(arch_id, bad):
    """``decode_step`` at a position outside its cache's [0, S) raises
    ``IndexError`` before it writes (a RoPE model has no position table
    to catch it), and leaves the cache as it was."""
    tf, cfg, params = _plain_lm(arch_id)
    tokens = torch.arange(4)[None, :]
    with torch.no_grad():
        _, caches = tf.prefill(params, cfg, tokens, max_seq=8)
        before = [{k: v.clone() for k, v in c.items()} for c in caches]
        pos = torch.tensor([-1 if bad == "below" else 8])
        with pytest.raises(IndexError, match="of its cache"):
            tf.decode_step(params, cfg, caches, torch.tensor([1]), pos)
    for c, b in zip(caches, before):
        for k in c:
            assert torch.equal(c[k], b[k]), k


@pytest.mark.parametrize("entry", ("trunk", "prefill_paged", "decode_paged"))
def test_token_ids_out_of_the_vocabulary_raise(entry):
    """A token outside [0, vocab) raises ``IndexError`` at every entry that
    embeds tokens: read back where no span is given, and checked against
    the span the engine hands over from its host copy."""
    tf, cfg, params = _plain_lm("glm4-9b")
    k_pool, v_pool = tf.init_paged_cache(cfg, 4, 4, device="cpu")
    bad = torch.tensor([[0, cfg.vocab]])
    with pytest.raises(IndexError, match="ids span"), torch.no_grad():
        if entry == "trunk":
            tf.trunk(params, cfg, bad)
        elif entry == "prefill_paged":
            tf.prefill_paged(params, cfg, torch.zeros_like(bad), k_pool,
                             v_pool, torch.arange(1),
                             token_span=(0, cfg.vocab))
        else:
            tf.decode_paged(params, cfg, k_pool, v_pool, bad[0, 1:],
                            torch.tensor([0]),
                            torch.zeros((1, 1), dtype=torch.int32),
                            torch.tensor([1]), token_span=(0, cfg.vocab))


def test_engine_reads_no_token_span_back(monkeypatch):
    """The serving engine hands the decoder the span of the tokens it
    holds on the host: a prefill and a decode round of an LM read no ids
    back from the device to check them."""
    from repro_torch.serve import engine as eng

    tf, cfg, params = _plain_lm("glm4-9b")

    def no_read(*ids):
        raise AssertionError("the engine's decoder read ids back")

    monkeypatch.setattr(tf, "id_spans", no_read)
    engine = eng.ServeEngine(params, cfg, eng.EngineConfig(
        max_batch=2, max_seq=32, page_size=8, n_pages=16), device="cpu")
    for n in (5, 9):
        engine.submit(eng.Request(prompt=np.arange(n, dtype=np.int32),
                                  max_new_tokens=3))
    done = engine.run()
    assert sorted(len(r.out_tokens) for r in done) == [3, 3]
