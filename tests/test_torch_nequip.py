"""The port's NequIP inference path == the JAX package's, on the CPU.

On the CPU, kernel B7 (``segment_sum``) runs its plain PyTorch version,
which adds each segment's edges in ascending edge index from +0.0.  It
is held byte for byte against the JAX package's reference
(``jax.ops.segment_sum``, which sums in the same order on the CPU), and
within rtol = atol = 1e-4 against the Pallas one-hot kernel in
interpret mode (``tests/test_kernels.py``'s tolerance: that kernel sums
each 256-edge block as a matrix product, then adds the blocks).  Sums
over a ``segment_plan`` (the ids checked and grouped once) are held
byte for byte against the same reference, and a forward builds one
plan (two with the energy readout).

The model is held against ``nequip_forward`` with the parameters drawn
by ``nequip_init`` and carried across with ``repro_torch.carry``,
within rtol = atol = 2e-5: XLA orders the float32 einsums of the tensor
products and the channel mix its own way (the port contracts each
path's filter once per forward and multiplies per edge), so the last
bits differ (the measured gap is at most 3e-7 on outputs of size 1).
The equivariance checks run on the port's own weights, with the JAX
tests' tolerances.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import nequip as ref_nequip_cfg  # noqa: E402
from repro.configs.common import GNN_SHAPES as REF_GNN_SHAPES  # noqa: E402
from repro.dataplane import graph as ref_graph  # noqa: E402
from repro.kernels.segment import kernel as ref_seg_kernel  # noqa: E402
from repro.kernels.segment import ref as ref_seg  # noqa: E402
from repro.models import nequip as ref_nequip  # noqa: E402

from repro_torch import carry, configs  # noqa: E402
from repro_torch.configs import common as port_common  # noqa: E402
from repro_torch.configs import nequip as port_nequip_cfg  # noqa: E402
from repro_torch.dataplane import graph as port_graph  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.segment import ops as sops  # noqa: E402
from repro_torch.kernels.segment import ref as sref  # noqa: E402
from repro_torch.models import nequip as port_nequip  # noqa: E402

# XLA orders the float32 einsums its own way.
F32 = dict(rtol=2e-5, atol=2e-5)
# The Pallas kernel sums 256-edge blocks as matrix products.
PALLAS = dict(rtol=1e-4, atol=1e-4)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _seg_case(e: int, s: int, d: int, seed: int, dtype=np.float32):
    """(e, d) messages and ids in [-1, s): a fifth -1, segment 3 a hub of
    a quarter of the edges, segments 5 and the last one empty."""
    rng = np.random.default_rng(seed)
    msg = rng.normal(size=(e, d)).astype(dtype)
    ids = rng.integers(-1, s, e).astype(np.int32)
    ids[rng.random(e) < 0.25] = 3
    ids[(ids == 5) | (ids == s - 1)] = 4
    ids[rng.random(e) < 0.2] = -1
    return msg, ids


def _seg_torch(msg, ids, s):
    return sops.segment_sum(torch.from_numpy(msg), torch.from_numpy(ids),
                            s).numpy()


# -- kernel B7 ----------------------------------------------------------------

class TestSegmentSum:
    @pytest.mark.parametrize("d", (1, 5, 32, 96))
    def test_plain_equals_jax_reference_byte_for_byte(self, d):
        msg, ids = _seg_case(2000, 200, d, seed=d)
        got = _seg_torch(msg, ids, 200)
        want = np.asarray(ref_seg.segment_sum(jnp.asarray(msg),
                                              jnp.asarray(ids), 200))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(_bytes(got), _bytes(want))
        assert not got[5].any() and not got[-1].any()

    def test_plain_equals_a_sequential_loop(self):
        msg, ids = _seg_case(700, 40, 7, seed=11, dtype=np.float64)
        want = np.zeros((40, 7))
        for e in range(len(ids)):                  # ascending edge order
            if ids[e] >= 0:
                want[ids[e]] = want[ids[e]] + msg[e]
        assert np.array_equal(_bytes(_seg_torch(msg, ids, 40)),
                              _bytes(want))

    @pytest.mark.parametrize("d", (1, 5, 32, 96))
    def test_plain_against_pallas_kernel(self, d):
        msg, ids = _seg_case(1000, 60, d, seed=100 + d)
        want = np.asarray(ref_seg_kernel.segment_sum(
            jnp.asarray(msg), jnp.asarray(ids), 60, interpret=True))
        np.testing.assert_allclose(_seg_torch(msg, ids, 60), want,
                                   **PALLAS)

    @pytest.mark.parametrize("d", (1, 32))
    def test_segment_max_matches_jax(self, d):
        msg, ids = _seg_case(500, 50, d, seed=7)
        got = sops.segment_max(torch.from_numpy(msg), torch.from_numpy(ids),
                               50).numpy()
        want = np.asarray(ref_seg.segment_max(jnp.asarray(msg),
                                              jnp.asarray(ids), 50))
        assert np.array_equal(got, want)

    def test_numpy_ids_and_ops_signature(self):
        msg, ids = _seg_case(300, 20, 4, seed=3)
        a = sops.segment_sum(torch.from_numpy(msg), ids, 20,
                             use_pallas=True, interpret=False)
        assert np.array_equal(a.numpy(), _seg_torch(msg, ids, 20))

    def test_cpu_tensors_launch_nothing(self):
        msg, ids = _seg_case(100, 10, 3, seed=0)
        before = dict(LAUNCHES)
        _seg_torch(msg, ids, 10)
        assert LAUNCHES == before

    def test_empty_inputs(self):
        out = sops.segment_sum(torch.zeros((0, 4)),
                               torch.zeros((0,), dtype=torch.int32), 3)
        assert out.shape == (3, 4) and not out.any()
        out = sops.segment_sum(torch.ones((2, 4)),
                               torch.full((2,), -1, dtype=torch.int32), 0)
        assert out.shape == (0, 4)

    @pytest.mark.parametrize("bad", (10, -2, 2 ** 31))
    def test_ids_outside_the_segments_raise(self, bad):
        ids = torch.tensor([0, bad], dtype=torch.int64)
        with pytest.raises((IndexError, OverflowError)):
            sops.segment_sum(torch.ones((2, 3)), ids, 10)

    def test_shapes_must_agree(self):
        with pytest.raises(ValueError):
            sops.segment_sum(torch.ones((3, 2)),
                             torch.zeros((2,), dtype=torch.int32), 4)

    def test_backward_gathers_the_output_gradient(self):
        rng = np.random.default_rng(5)
        msg = torch.from_numpy(rng.normal(size=(60, 3))).requires_grad_()
        ids = torch.from_numpy(rng.integers(-1, 8, 60).astype(np.int32))
        grad_out = torch.from_numpy(rng.normal(size=(8, 3)))
        (grad,) = torch.autograd.grad(sops.segment_sum(msg, ids, 8),
                                      msg, grad_out)
        want = np.where((ids >= 0).numpy()[:, None],
                        grad_out.numpy()[ids.clamp(min=0).numpy()], 0.0)
        assert np.array_equal(grad.numpy(), want)
        assert torch.autograd.gradcheck(
            lambda m: sops.segment_sum(m, ids, 8), (msg,))


class TestSegmentPlan:
    """``segment_plan`` + ``segment_sum``: the ids validated and grouped
    once, then read by every sum over them; the same bytes as the ids
    path and as ``jax.ops.segment_sum``."""

    @pytest.mark.parametrize("dtype", (np.float32, np.float64))
    @pytest.mark.parametrize("d", (1, 32, 96))
    def test_plan_equals_jax_reference_byte_for_byte(self, d, dtype):
        msg, ids = _seg_case(2000, 200, d, seed=20 + d, dtype=dtype)
        plan = sops.segment_plan(torch.from_numpy(ids), 200)
        got = sops.segment_sum(torch.from_numpy(msg), plan, 200).numpy()
        with jax.enable_x64(dtype == np.float64):
            want = np.asarray(ref_seg.segment_sum(jnp.asarray(msg),
                                                  jnp.asarray(ids), 200))
        assert got.dtype == want.dtype == dtype
        assert np.array_equal(_bytes(got), _bytes(want))
        # -1 ids, empty segments and a hub (segment 3) are in the case.
        assert (ids == -1).any() and (ids == 3).sum() > 400
        assert not got[5].any() and not got[-1].any()

    def test_one_plan_read_by_three_sums(self):
        _, ids = _seg_case(1500, 120, 1, seed=9)
        plan = sops.segment_plan(ids, 120)            # numpy ids: the CPU
        assert plan.ids.dtype == torch.int32 and plan.num_segments == 120
        rng = np.random.default_rng(10)
        for d in (1, 7, 48):
            msg = torch.from_numpy(rng.normal(size=(1500, d)).astype(
                np.float32))
            assert np.array_equal(
                _bytes(sops.segment_sum(msg, plan, 120).numpy()),
                _bytes(_seg_torch(msg.numpy(), ids, 120)))

    def test_a_plan_that_does_not_fit_raises(self):
        _, ids = _seg_case(300, 20, 1, seed=4)
        plan = sops.segment_plan(torch.from_numpy(ids), 20)
        with pytest.raises(ValueError, match="num_segments"):
            sops.segment_sum(torch.ones((300, 2)), plan, 21)
        with pytest.raises(ValueError, match="plan of 300"):
            sops.segment_sum(torch.ones((299, 2)), plan, 20)
        with pytest.raises(ValueError, match="num_segments"):
            sref.segment_sum(torch.ones((300, 2)), plan, 19)
        with pytest.raises(IndexError):                # validated once
            sops.segment_plan(torch.from_numpy(ids), 10)

    def test_plan_builds_launch_nothing_on_the_cpu(self):
        _, ids = _seg_case(100, 10, 1, seed=0)
        before = dict(LAUNCHES)
        sops.segment_sum(torch.ones((100, 3)),
                         sops.segment_plan(torch.from_numpy(ids), 10), 10)
        assert LAUNCHES == before

    def test_backward_through_a_plan(self):
        rng = np.random.default_rng(6)
        ids = torch.from_numpy(rng.integers(-1, 8, 60).astype(np.int32))
        msg = torch.from_numpy(rng.normal(size=(60, 3))).requires_grad_()
        grad_out = torch.from_numpy(rng.normal(size=(8, 3)))
        plan = sops.segment_plan(ids, 8)
        (got,) = torch.autograd.grad(sops.segment_sum(msg, plan, 8), msg,
                                     grad_out)
        (want,) = torch.autograd.grad(sops.segment_sum(msg, ids, 8), msg,
                                      grad_out)
        assert torch.equal(got, want)


# -- spherical harmonics, Gaunt tensors, radial basis -------------------------

class TestIrrepAlgebra:
    def test_tp_paths_and_gaunt_equal_jax(self):
        assert port_nequip.tp_paths(2) == ref_nequip.tp_paths(2)
        assert len(port_nequip.tp_paths(2)) == 11
        for path in port_nequip.tp_paths(2):
            a, b = port_nequip.gaunt(*path), ref_nequip.gaunt(*path)
            assert a.dtype == b.dtype and np.array_equal(a, b), path

    @pytest.mark.parametrize("l", (0, 1, 2))
    def test_sph_harm_matches_jax(self, l):
        rng = np.random.default_rng(l)
        v = rng.normal(size=(50, 3))
        v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
        got = port_nequip.sph_harm(l, torch.from_numpy(v)).numpy()
        want = np.asarray(ref_nequip.sph_harm(l, jnp.asarray(v)))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port_nequip.sph_harm_np(l, v),
                                   ref_nequip.sph_harm_np(l, v))

    def test_bessel_rbf_matches_jax(self):
        r = np.linspace(0.0, 6.0, 97).astype(np.float32)
        got = port_nequip.bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy()
        want = np.asarray(ref_nequip.bessel_rbf(jnp.asarray(r), 8, 5.0))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert not got[r > 5.0].any()           # the envelope's cutoff


# -- the model ----------------------------------------------------------------

def _cfgs(readout: str, d_feat: int, n_out: int):
    kw = dict(n_layers=2, channels=8, l_max=2, n_rbf=4, cutoff=5.0,
              d_feat=d_feat, n_out=n_out, readout=readout)
    return port_nequip.NequIPConfig(**kw), ref_nequip.NequIPConfig(**kw)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# Compiled once per configuration: eager dispatch of the reference's
# einsums takes seconds.
_ref_forward = jax.jit(ref_nequip.nequip_forward, static_argnums=1,
                       static_argnames="n_graphs")
_ref_energy_forces = jax.jit(ref_nequip.nequip_energy_forces,
                             static_argnums=1, static_argnames="n_graphs")


def _cases():
    """Batches from the port's data plane (equal to the JAX package's):
    a padded full graph, a sampled minibatch and padded molecules."""
    g = port_graph.synthetic_graph(90, 5, 6, 3, seed=1)
    full = port_graph.full_graph_batch(g, 128, 512)
    mini = port_graph.minibatch(g, 8, [4, 3], 96, 160, step=2)
    mol = port_graph.molecule_batch(4, 30, 64, pad_nodes=128,
                                    pad_edges=300)
    return {"full_graph": ("node_class", 3, full),
            "minibatch": ("node_class", 3, mini),
            "molecule": ("energy", 1, mol)}


def _run_both(name):
    readout, n_out, b = _cases()[name]
    pcfg, jcfg = _cfgs(readout, b["node_feat"].shape[1], n_out)
    params = _np_tree(ref_nequip.nequip_init(jax.random.PRNGKey(3), jcfg))
    model = carry.nequip_from_params(pcfg, params, device="cpu")
    kw = {}
    if readout == "energy":
        kw = dict(graph_ids=b["graph_ids"], n_graphs=b["n_graphs"])
    args = (b["node_feat"], b["positions"], b["edge_index"])
    return model, params, jcfg, args, kw


def _t(args, kw):
    return ([torch.from_numpy(a) for a in args],
            {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()})


class TestNequIP:
    @pytest.mark.parametrize("name", ("full_graph", "minibatch", "molecule"))
    def test_matches_nequip_forward(self, name):
        model, params, jcfg, args, kw = _run_both(name)
        want = np.asarray(_ref_forward(
            params, jcfg, *map(jnp.asarray, args),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}))
        targs, tkw = _t(args, kw)
        with torch.no_grad():
            got = model(*targs, **tkw).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, **F32)

    def test_energy_forces_match_jax(self):
        model, params, jcfg, args, kw = _run_both("molecule")
        e_want, f_want = _ref_energy_forces(
            params, jcfg, *map(jnp.asarray, args),
            graph_ids=jnp.asarray(kw["graph_ids"]), n_graphs=kw["n_graphs"])
        targs, tkw = _t(args, kw)
        e, f = port_nequip.nequip_energy_forces(model, *targs, **tkw)
        assert f.shape == targs[1].shape and not e.requires_grad
        np.testing.assert_allclose(e.numpy(), np.asarray(e_want), **F32)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_want), **F32)
        assert np.abs(np.asarray(f_want)).max() > 1e-3   # forces not all 0

    @pytest.mark.parametrize("name,calls", (("full_graph", 6),
                                            ("molecule", 7)))
    def test_every_sum_goes_through_segment_sum(self, name, calls,
                                                monkeypatch):
        model, _, _, args, kw = _run_both(name)
        seen = []
        real = sref.segment_sum

        def counting(messages, ids, n):
            seen.append((tuple(messages.shape), n))
            return real(messages, ids, n)

        monkeypatch.setattr(sref, "segment_sum", counting)
        targs, tkw = _t(args, kw)
        with torch.no_grad():
            model(*targs, **tkw)
        # n_layers × (l_max + 1) message sums, then the energy readout.
        assert len(seen) == calls
        n, c = targs[0].shape[0], model.cfg.channels
        assert [d for (_, d), _ in seen[:3]] == [c, 3 * c, 5 * c]
        if name == "molecule":
            assert seen[-1] == ((n, 1), kw["n_graphs"])

    @pytest.mark.parametrize("name,plans", (("full_graph", 2),
                                            ("minibatch", 2),
                                            ("molecule", 3)))
    def test_one_segment_plan_per_forward(self, name, plans, monkeypatch):
        """The layers' sums share one plan of the destination ids and
        their gathers one of the source ids, and an energy forward builds
        one more for the readout; outputs (and forces) still agree with
        the JAX package within 2e-5."""
        model, params, jcfg, args, kw = _run_both(name)
        built = []
        real = sops.segment_plan

        def counting(ids, n):
            built.append(n)
            return real(ids, n)

        monkeypatch.setattr(sops, "segment_plan", counting)
        targs, tkw = _t(args, kw)
        jargs = [jnp.asarray(a) for a in args]
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        if name == "molecule":
            e, f = port_nequip.nequip_energy_forces(model, *targs, **tkw)
            e_want, f_want = _ref_energy_forces(params, jcfg, *jargs, **jkw)
            np.testing.assert_allclose(e.numpy(), np.asarray(e_want), **F32)
            np.testing.assert_allclose(f.numpy(), np.asarray(f_want), **F32)
        else:
            with torch.no_grad():
                got = model(*targs, **tkw).numpy()
            np.testing.assert_allclose(
                got, np.asarray(_ref_forward(params, jcfg, *jargs, **jkw)),
                **F32)
        n = targs[0].shape[0]
        assert len(built) == plans and built[:2] == [n, n]
        if name == "molecule":
            assert built[2] == kw["n_graphs"]

    @pytest.mark.parametrize("name", ("minibatch", "molecule"))
    def test_padding_edges_dropped_equals_clamped_to_node_0(
            self, name, monkeypatch):
        """The port drops padding edges from the sums (id -1); the JAX
        package clamps them onto node 0 with zero messages.  Same bits."""
        model, _, _, args, kw = _run_both(name)
        assert (args[2] < 0).any()
        targs, tkw = _t(args, kw)
        with torch.no_grad():
            dropped = model(*targs, **tkw)
            real = sops.segment_plan
            monkeypatch.setattr(sops, "segment_plan", lambda ids, n:
                                real(ids.clamp(min=0), n))
            clamped = model(*targs, **tkw)
        assert np.array_equal(_bytes(dropped.numpy()),
                              _bytes(clamped.numpy()))

    def test_float64_model_agrees(self):
        model, params, _, args, kw = _run_both("full_graph")
        cfg64 = dataclasses.replace(model.cfg, dtype=torch.float64)
        model64 = carry.nequip_from_params(cfg64, params, device="cpu")
        targs, tkw = _t(args, kw)
        with torch.no_grad():
            a = model(*targs, **tkw)
            b = model64(targs[0].double(), targs[1].double(), targs[2])
        assert b.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)

    def test_layout_and_carry_checks(self):
        pcfg, jcfg = _cfgs("energy", 16, 1)
        params = _np_tree(ref_nequip.nequip_init(jax.random.PRNGKey(0),
                                                 jcfg))
        model = port_nequip.NequIP(pcfg, device="cpu")
        layer = model.layers[0]
        for key, mod in (("mix", layer.mix),
                         ("self", layer.self_interaction),
                         ("gate", layer.gate)):
            assert set(mod.keys()) == set(params["layers"][0][key])
            for k, v in params["layers"][0][key].items():
                assert tuple(mod[k].shape) == v.shape, (key, k)
        bad = dict(params["layers"][0], gate={"1": params["layers"][0][
            "gate"]["1"]})
        with pytest.raises(ValueError, match="gate"):
            carry.nequip_from_params(pcfg, dict(params, layers=[
                bad, params["layers"][1]]), device="cpu")
        with pytest.raises(ValueError, match="layers"):
            carry.nequip_from_params(pcfg, dict(
                params, layers=params["layers"][:1]), device="cpu")

    def test_init_is_seeded_and_leaves_the_global_generator(self):
        pcfg, _ = _cfgs("node_class", 4, 3)
        state = torch.random.get_rng_state()
        a = port_nequip.NequIP(pcfg, device="cpu", seed=4)
        b = port_nequip.NequIP(pcfg, device="cpu", seed=4)
        assert torch.equal(torch.random.get_rng_state(), state)
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), name


def test_model_defaults_to_the_card():
    cfg = configs.get_config("nequip", smoke=True)
    if torch.cuda.is_available():
        assert next(port_nequip.NequIP(cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_nequip.NequIP(cfg)
    assert not next(port_nequip.NequIP(cfg, device="cpu")
                    .parameters()).is_cuda


# -- equivariance (tests/test_models.py::TestEquivariance on the port) -------

def _equivariance_setup(readout, n_out):
    cfg = port_nequip.NequIPConfig(n_layers=2, channels=8, d_feat=4,
                                   n_out=n_out, readout=readout)
    model = port_nequip.NequIP(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    n, e = 16, 48
    pos = torch.from_numpy(rng.uniform(0, 4, (n, 3)).astype(np.float32))
    feat = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    ei = torch.from_numpy(rng.integers(0, n, (2, e)).astype(np.int32))
    return model, pos, feat, ei


def _rotation(seed):
    from scipy.spatial.transform import Rotation

    return torch.from_numpy(Rotation.random(random_state=seed).as_matrix()
                            .astype(np.float32))


class TestEquivariance:
    @pytest.mark.parametrize("seed", range(15))
    def test_rotation_invariance_of_scalars(self, seed):
        model, pos, feat, ei = _equivariance_setup("node_class", 3)
        rot = _rotation(seed)
        with torch.no_grad():
            out = model(feat, pos, ei)
            out_r = model(feat, pos @ rot.T, ei)
        np.testing.assert_allclose(out.numpy(), out_r.numpy(), atol=5e-3)

    def test_force_equivariance(self):
        model, pos, feat, ei = _equivariance_setup("energy", 1)
        rot = _rotation(3)
        e1, f1 = port_nequip.nequip_energy_forces(model, feat, pos, ei)
        e2, f2 = port_nequip.nequip_energy_forces(model, feat, pos @ rot.T,
                                                  ei)
        np.testing.assert_allclose(float(e1[0]), float(e2[0]), atol=5e-3)
        np.testing.assert_allclose((f1 @ rot.T).numpy(), f2.numpy(),
                                   atol=5e-3)

    def test_translation_invariance(self):
        model, pos, feat, ei = _equivariance_setup("node_class", 3)
        with torch.no_grad():
            out = model(feat, pos, ei)
            out_t = model(feat, pos + 7.3, ei)
        np.testing.assert_allclose(out.numpy(), out_t.numpy(), atol=1e-4)


# -- the data plane -----------------------------------------------------------

def _assert_batches_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in b:
        if b[k] is None or np.isscalar(b[k]):
            assert a[k] == b[k], k
            continue
        assert a[k].dtype == b[k].dtype, k
        assert np.array_equal(a[k], b[k]), k


class TestGraphDataplane:
    def test_synthetic_graph_equals_jax_packages(self):
        a = port_graph.synthetic_graph(300, 6, 5, 4, seed=2)
        b = ref_graph.synthetic_graph(300, 6, 5, 4, seed=2)
        for f in ("indptr", "indices", "node_feat", "labels"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)

    def test_full_graph_batch_equals_jax_packages(self):
        args = (300, 6, 5, 4)
        for pad_edges in (1024, 1500):           # truncated, then padded
            _assert_batches_equal(
                port_graph.full_graph_batch(
                    port_graph.synthetic_graph(*args), 320, pad_edges),
                ref_graph.full_graph_batch(
                    ref_graph.synthetic_graph(*args), 320, pad_edges))

    @pytest.mark.parametrize("step", (0, 3))
    def test_minibatch_equals_jax_packages(self, step):
        args = (400, 8, 5, 4)
        _assert_batches_equal(
            port_graph.minibatch(port_graph.synthetic_graph(*args), 16,
                                 [5, 3], 200, 160, step=step),
            ref_graph.minibatch(ref_graph.synthetic_graph(*args), 16,
                                [5, 3], 200, 160, step=step))

    @pytest.mark.parametrize("kw", (dict(n_graphs=3),
                                    dict(n_graphs=4, pad_nodes=128,
                                         pad_edges=300, step=5)))
    def test_molecule_batch_equals_jax_packages(self, kw):
        _assert_batches_equal(port_graph.molecule_batch(**kw),
                              ref_graph.molecule_batch(**kw))


# -- configurations -----------------------------------------------------------

def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.") if isinstance(
        cfg.dtype, torch.dtype) else str(np.dtype(cfg.dtype))
    return out


class TestConfigs:
    @pytest.mark.parametrize("ours,theirs", (("_cfg", "_base"),
                                             ("_smoke", "_smoke")))
    def test_values_equal_jax_field_by_field(self, ours, theirs):
        assert port_nequip_cfg.ID == ref_nequip_cfg.ID
        a = getattr(port_nequip_cfg, ours)()
        b = getattr(ref_nequip_cfg, theirs)()
        assert _fields(a) == _fields(b)
        assert configs.get_config("nequip", smoke=ours == "_smoke") == a
        assert a.paths == b.paths and a.ls == b.ls

    @pytest.mark.parametrize("shape", tuple(REF_GNN_SHAPES))
    def test_for_shape_equals_jax_shape_cfg(self, shape):
        info = REF_GNN_SHAPES[shape]
        want = dataclasses.replace(ref_nequip_cfg._base(),
                                   d_feat=info["d_feat"],
                                   n_out=info["n_out"],
                                   readout=info["readout"])
        assert _fields(port_nequip_cfg.for_shape(shape)) == _fields(want)

    def test_gnn_shapes_equal_jax_packages(self):
        assert port_common.GNN_SHAPES == REF_GNN_SHAPES
        assert "nequip" in configs.ARCH_IDS
