"""The port's recsys serving path == the JAX package's, on the CPU.

On the CPU, kernel B6 (``gather_rows_bag``) runs its plain PyTorch
version. It is held byte for byte against the Pallas kernel in
interpret mode, which sums a bag's slots in the same order. Against
the jnp reference and the models, whose sums and matrix products XLA
orders its own way, the tolerance is rtol = atol = 2e-5: the JAX tests'
own float32 tolerance (``tests/test_kernels.py``). Inputs come from numpy
seeds; parameters are drawn by the JAX initialisers and carried across
with ``repro_torch.carry``. The CUDA kernel itself is held against the
plain version on the card in ``test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import deepfm as ref_deepfm_cfg  # noqa: E402
from repro.configs import dlrm_rm2 as ref_dlrm_cfg  # noqa: E402
from repro.configs.common import RECSYS_SHAPES as REF_SHAPES  # noqa: E402
from repro.dataplane import recsys as ref_data  # noqa: E402
from repro.kernels.gather import kernel as ref_gather_kernel  # noqa: E402
from repro.kernels.gather import ref as ref_gather  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recsys as ref_recsys  # noqa: E402

from repro_torch import carry, configs  # noqa: E402
from repro_torch.configs import common as port_common  # noqa: E402
from repro_torch.configs import deepfm as port_deepfm_cfg  # noqa: E402
from repro_torch.configs import dlrm_rm2 as port_dlrm_cfg  # noqa: E402
from repro_torch.dataplane import recsys as port_data  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.models import recsys as port_recsys  # noqa: E402
from repro_torch.models.layers import MLP  # noqa: E402

# XLA orders float32 sums and matrix products its own way.
F32 = dict(rtol=2e-5, atol=2e-5)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _bag_case(n: int, d: int, b: int, l: int, seed: int):
    """A float32 (n, d) table and (b, l) bags with -1 slots; bag 0 is all
    padding."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    bags = rng.integers(-1, n, (b, l)).astype(np.int32)
    bags[0] = -1
    return table, bags


def _pad(bags: np.ndarray, seed: int, share: float = 0.25) -> np.ndarray:
    """``bags`` with a seeded ``share`` of its slots set to -1."""
    rng = np.random.default_rng(seed)
    out = bags.copy()
    out[rng.random(out.shape) < share] = -1
    return out


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- kernel B6 ----------------------------------------------------------------

class TestGatherRowsBag:
    @pytest.mark.parametrize("l", (1, 3, 8))
    @pytest.mark.parametrize("d", (1, 10, 64))
    def test_plain_equals_pallas_kernel(self, d, l):
        table, bags = _bag_case(40, d, 6, l, seed=100 * d + l)
        want = np.asarray(ref_gather_kernel.gather_rows_bag(
            jnp.asarray(table), jnp.asarray(bags), interpret=True))
        got = gops.gather_rows_bag(torch.from_numpy(table),
                                   torch.from_numpy(bags)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bytes(got), _bytes(want))
        assert not got[0].any()                  # the all-padding bag

    @pytest.mark.parametrize("l", (1, 3, 8))
    @pytest.mark.parametrize("d", (1, 10, 64))
    def test_plain_against_jnp_reference(self, d, l):
        table, bags = _bag_case(300, d, 50, l, seed=7 * d + l)
        want = np.asarray(ref_gather.gather_rows_bag(jnp.asarray(table),
                                                     jnp.asarray(bags)))
        got = gops.gather_rows_bag(torch.from_numpy(table), bags).numpy()
        if l == 1:        # one slot: no summation order to differ
            assert np.array_equal(_bytes(got), _bytes(want))
        else:
            np.testing.assert_allclose(got, want, **F32)

    def test_cpu_tensors_launch_nothing(self):
        table, bags = _bag_case(20, 4, 5, 2, seed=0)
        before = dict(LAUNCHES)
        gops.gather_rows_bag(torch.from_numpy(table), torch.from_numpy(bags))
        assert LAUNCHES == before

    def test_empty_batch_and_empty_bags(self):
        table = torch.ones(5, 3)
        assert gops.gather_rows_bag(
            table, torch.zeros((0, 4), dtype=torch.int32)).shape == (0, 3)
        out = gops.gather_rows_bag(table, torch.zeros((2, 0),
                                                      dtype=torch.int32))
        assert out.shape == (2, 3) and not out.any()

    @pytest.mark.parametrize("bad", (5, -2, 2 ** 31))
    def test_ids_outside_the_table_raise(self, bad):
        table = torch.ones(5, 3)
        bags = torch.tensor([[0, bad]], dtype=torch.int64)
        with pytest.raises((IndexError, OverflowError)):
            gops.gather_rows_bag(table, bags)


# -- EmbeddingBag -------------------------------------------------------------

def _embedding_bag(n_tables, rows, dim, tables):
    bag = port_recsys.EmbeddingBag(n_tables, rows, dim,
                                   generator=torch.Generator(),
                                   device=torch.device("cpu"))
    carry._load(bag.tables, tables, "tables")
    return bag


class TestEmbeddingBag:
    @pytest.mark.parametrize("combine", ("sum", "mean"))
    @pytest.mark.parametrize("l", (1, 3))
    def test_matches_jax(self, combine, l):
        rng = np.random.default_rng(l)
        t, r, d = 4, 50, 10
        tables = rng.normal(size=(t, r, d)).astype(np.float32)
        bags = _pad(rng.integers(0, r, (16, t, l)).astype(np.int32), seed=l)
        bags[0, 1] = -1                              # an all-padding bag
        want = np.asarray(ref_recsys.embedding_bag(
            {"tables": jnp.asarray(tables)}, jnp.asarray(bags), combine))
        bag = _embedding_bag(t, r, d, tables)
        got = bag(torch.from_numpy(bags), combine).detach().numpy()
        assert got.shape == (16, t, d)
        np.testing.assert_allclose(got, want, **F32)
        assert not got[0, 1].any()

    def test_one_bag_call_over_all_tables(self, monkeypatch):
        calls = []
        real = gops.ref.gather_rows_bag

        def rec(table, bags):
            calls.append((tuple(table.shape), tuple(bags.shape), bags))
            return real(table, bags)

        monkeypatch.setattr(gops.ref, "gather_rows_bag", rec)
        rng = np.random.default_rng(0)
        tables = rng.normal(size=(3, 7, 2)).astype(np.float32)
        bags = np.array([[[6, -1], [0, 1], [-1, -1]]], np.int32)
        _embedding_bag(3, 7, 2, tables)(torch.from_numpy(bags))
        assert len(calls) == 1
        table_shape, bags_shape, flat = calls[0]
        assert table_shape == (21, 2) and bags_shape == (3, 2)
        # ids offset by t * R where valid, -1 kept, already int32
        assert flat.dtype == torch.int32
        assert flat.tolist() == [[6, -1], [7, 8], [-1, -1]]

    @pytest.mark.parametrize("bad", (7, 20, -2))
    def test_ids_outside_each_table_raise(self, bad):
        # 7 = R would read table 1's row 0 of the flattened view.
        bag = _embedding_bag(3, 7, 2, np.zeros((3, 7, 2), np.float32))
        bags = torch.zeros((2, 3, 1), dtype=torch.int32)
        bags[1, 0, 0] = bad
        with pytest.raises(IndexError):
            bag(bags)

    def test_tables_past_int32_flat_ids_raise(self):
        # 3 * 2**30 flat ids t*R + id do not fit int32; refused before
        # anything is allocated.
        with pytest.raises(OverflowError):
            port_recsys.EmbeddingBag(3, 2 ** 30, 1,
                                     generator=torch.Generator(),
                                     device=torch.device("cpu"))

    def test_rejects_bad_shapes_and_combine(self):
        bag = _embedding_bag(3, 7, 2, np.zeros((3, 7, 2), np.float32))
        with pytest.raises(ValueError):
            bag(torch.zeros((2, 4, 1), dtype=torch.int32))
        with pytest.raises(ValueError):
            bag(torch.zeros((2, 3), dtype=torch.int32))
        with pytest.raises(ValueError):
            bag(torch.zeros((2, 3, 1), dtype=torch.int32), combine="max")


# -- dense layers -------------------------------------------------------------

class TestLayers:
    @pytest.mark.parametrize("dims", ([13, 16, 8], [20, 1], [5, 7, 9, 3]))
    def test_mlp_matches_jax(self, dims):
        params = ref_layers.mlp_init(jax.random.PRNGKey(len(dims)), dims)
        x = np.random.default_rng(1).normal(size=(9, dims[0])).astype(
            np.float32)
        want = np.asarray(ref_layers.mlp(params, jnp.asarray(x)))
        mlp = MLP(dims, generator=torch.Generator(),
                  device=torch.device("cpu"))
        carry._load_mlp(mlp, _np_tree(params), "mlp")
        with torch.no_grad():
            got = mlp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **F32)

    def test_layout_and_init(self):
        gen = torch.Generator().manual_seed(0)
        mlp = MLP([64, 32, 1], generator=gen, device=torch.device("cpu"))
        w0, w1 = mlp.layers[0].w.detach(), mlp.layers[1].w.detach()
        assert w0.shape == (64, 32) and mlp.layers[0].b.shape == (32,)
        assert not mlp.layers[0].b.any()
        assert abs(float(w0.std()) - 1 / 8) < 0.02            # 1/√64
        assert abs(float(w1.std()) - 1 / np.sqrt(32)) < 0.06


# -- the models ---------------------------------------------------------------

def _dlrm_narrow(jax_side: bool):
    kw = dict(name="dlrm-narrow", n_dense=13, n_sparse=5, rows=200,
              embed_dim=16, bot_mlp=(32, 16), top_mlp=(32, 16, 1),
              bag_size=3)
    return (ref_recsys.DLRMConfig(**kw) if jax_side
            else port_recsys.DLRMConfig(**kw))


def _deepfm_narrow(jax_side: bool):
    kw = dict(name="deepfm-narrow", n_sparse=7, rows=100, embed_dim=10,
              mlp_dims=(32, 32))
    return (ref_recsys.DeepFMConfig(**kw) if jax_side
            else port_recsys.DeepFMConfig(**kw))


DLRM_CASES = {"smoke": (ref_dlrm_cfg._smoke, lambda: configs.get_config(
    "dlrm-rm2", smoke=True)), "narrow": (lambda: _dlrm_narrow(True),
                                         lambda: _dlrm_narrow(False))}
DEEPFM_CASES = {"smoke": (ref_deepfm_cfg._smoke, lambda: configs.get_config(
    "deepfm", smoke=True)), "narrow": (lambda: _deepfm_narrow(True),
                                       lambda: _deepfm_narrow(False))}


def _clicks(cfg, step: int, batch: int, narrow: bool) -> dict:
    """A click batch for ``cfg``: its own bag size at the smoke config,
    else three ids per bag with a quarter of the slots padded."""
    stream = port_data.ClickStream(
        n_sparse=cfg.n_sparse, rows=cfg.rows,
        bag_size=3 if narrow else getattr(cfg, "bag_size", 1), seed=3)
    b = stream.batch(step, batch)
    if narrow:
        b["bags"] = _pad(b["bags"], seed=step)
    return b


class TestDLRM:
    @pytest.mark.parametrize("case", sorted(DLRM_CASES))
    def test_matches_dlrm_forward(self, case):
        jcfg, pcfg = (f() for f in DLRM_CASES[case])
        params = ref_recsys.dlrm_init(jax.random.PRNGKey(0), jcfg)
        model = carry.dlrm_from_params(pcfg, _np_tree(params), device="cpu")
        for step in range(2):
            b = _clicks(pcfg, step, 64, narrow=case == "narrow")
            want = np.asarray(ref_recsys.dlrm_forward(
                params, jcfg, jnp.asarray(b["dense"]),
                jnp.asarray(b["bags"])))
            with torch.no_grad():
                got = model(torch.from_numpy(b["dense"]),
                            torch.from_numpy(b["bags"])).numpy()
            assert got.shape == (64,) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, **F32)

    def test_pairs_in_triu_order(self):
        model = port_recsys.DLRM(configs.get_config("dlrm-rm2", smoke=True),
                                 device="cpu")
        iu, ju = np.triu_indices(5, k=1)
        assert model.pair_i.tolist() == iu.tolist()
        assert model.pair_j.tolist() == ju.tolist()

    def test_init_is_seeded_and_leaves_the_global_generator(self):
        cfg = configs.get_config("dlrm-rm2", smoke=True)
        state = torch.random.get_rng_state()
        a = port_recsys.DLRM(cfg, device="cpu", seed=0)
        b = port_recsys.DLRM(cfg, device="cpu", seed=0)
        c = port_recsys.DLRM(cfg, device="cpu", seed=1)
        assert torch.equal(torch.random.get_rng_state(), state)
        assert torch.equal(a.bags.tables, b.bags.tables)
        assert not torch.equal(a.bags.tables, c.bags.tables)
        assert a.bags.tables.requires_grad      # the tables train
        std = float(a.bags.tables.std())
        assert abs(std - 1 / np.sqrt(cfg.embed_dim)) < 0.05


class TestDeepFM:
    @pytest.mark.parametrize("case", sorted(DEEPFM_CASES))
    def test_matches_deepfm_forward(self, case):
        jcfg, pcfg = (f() for f in DEEPFM_CASES[case])
        params = ref_recsys.deepfm_init(jax.random.PRNGKey(1), jcfg)
        # A non-zero bias, so that carrying it is tested too.
        params["bias"] = jnp.asarray(0.25, jnp.float32)
        model = carry.deepfm_from_params(pcfg, _np_tree(params),
                                         device="cpu")
        for step in range(2):
            b = _clicks(pcfg, step, 64, narrow=case == "narrow")
            want = np.asarray(ref_recsys.deepfm_forward(
                params, jcfg, jnp.asarray(b["bags"])))
            with torch.no_grad():
                got = model(torch.from_numpy(b["bags"])).numpy()
            assert got.shape == (64,) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("make", (
    lambda dev: port_recsys.DLRM(configs.get_config("dlrm-rm2", smoke=True),
                                 device=dev),
    lambda dev: port_recsys.DeepFM(configs.get_config("deepfm", smoke=True),
                                   device=dev)), ids=("dlrm", "deepfm"))
def test_models_default_to_the_card(make):
    if torch.cuda.is_available():
        assert make(None).bags.tables.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)
    assert not make("cpu").bags.tables.is_cuda


def test_matmul_precision_is_read_not_set():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    model = port_recsys.DLRM(configs.get_config("dlrm-rm2", smoke=True),
                             device="cpu")
    b = _clicks(model.cfg, 0, 8, narrow=False)
    with torch.no_grad():
        model(torch.from_numpy(b["dense"]), torch.from_numpy(b["bags"]))
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == before


# -- the data plane -----------------------------------------------------------

class TestClickStream:
    @pytest.mark.parametrize("kw", (
        dict(), dict(n_sparse=39, rows=1_000_000, seed=5),
        dict(n_sparse=4, rows=128, bag_size=3, seed=2)))
    def test_batches_equal_jax_packages(self, kw):
        ours, theirs = port_data.ClickStream(**kw), ref_data.ClickStream(**kw)
        for step, shard, n_shards in ((0, 0, 1), (3, 0, 1), (7, 1, 2)):
            a = ours.batch(step, 64, shard=shard, n_shards=n_shards)
            b = theirs.batch(step, 64, shard=shard, n_shards=n_shards)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), k

    def test_interaction_stream_equals_jax_packages(self):
        ours = port_data.InteractionStream(n_users=500, n_items=640, seed=4)
        theirs = ref_data.InteractionStream(n_users=500, n_items=640, seed=4)
        for a, b in ((ours.pairs(2, 32), theirs.pairs(2, 32)),
                     (ours.sequences(1, 8, 12), theirs.sequences(1, 8, 12))):
            for k in b:
                assert np.array_equal(a[k], b[k]), k


# -- configurations -----------------------------------------------------------

def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    return out


class TestConfigs:
    @pytest.mark.parametrize("port_mod,ref_mod", (
        (port_dlrm_cfg, ref_dlrm_cfg), (port_deepfm_cfg, ref_deepfm_cfg)),
        ids=("dlrm-rm2", "deepfm"))
    @pytest.mark.parametrize("which", ("_cfg", "_smoke"))
    def test_values_equal_jax_field_by_field(self, port_mod, ref_mod, which):
        assert port_mod.ID == ref_mod.ID
        ours, theirs = getattr(port_mod, which)(), getattr(ref_mod, which)()
        assert _fields(ours) == _fields(theirs)
        assert configs.get_config(port_mod.ID,
                                  smoke=which == "_smoke") == ours

    def test_shapes_and_registry(self):
        """The port registers the JAX package's ten architectures."""
        assert port_common.RECSYS_SHAPES == REF_SHAPES
        assert len(configs.ARCH_IDS) == 10
        assert set(configs.ARCH_IDS) == set(REF_ARCH_IDS)
        for arch in configs.ARCH_IDS:
            assert configs.get_config(arch, smoke=True).name.startswith(arch)
        with pytest.raises(KeyError):
            configs.get_config("no-such-arch")

    def test_published_table_bytes(self):
        dlrm = configs.get_config("dlrm-rm2")
        fm = configs.get_config("deepfm")
        assert dlrm.n_sparse * dlrm.rows * dlrm.embed_dim * 4 == 6_656_000_000
        assert fm.n_sparse * fm.rows * fm.embed_dim * 4 == 1_560_000_000
