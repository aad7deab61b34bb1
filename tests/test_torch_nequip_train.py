"""NequIP training on the port == the JAX package's, on the CPU.

On the CPU kernel B7 (``segment_sum``) runs its plain version.  Its
backward is the op ``segment_gather`` (``grad_out[ids]``), whose own backward
is ``segment_sum`` again over the same ids or plan: ``gradgradcheck``
holds both in float64 with ``-1`` ids.  ``nequip_loss`` is held against
the JAX ``nequip_loss`` in all three branches (``node_class`` with a
label mask, energy, energy + 100 × forces through a double backward),
with its gradient against ``jax.grad``; the parameters are drawn by
``nequip_init`` and carried with ``repro_torch.carry``.

Tolerances: the losses and gradients within rtol = atol = 2e-5 (the
float32 tolerance of ``tests/test_torch_nequip.py``: XLA orders its
einsums its own way), the force branch's too, whose gradients go
through a second backward of every layer.  Three
``make_train_step`` steps from a carried JAX ``init_train_state``: the
parameters and every state leaf within rtol = 1e-5, atol = 1e-6, the
metrics within rtol = 1e-5, as ``tests/test_torch_recsys_train.py``
holds the recsys steps.  The layers' recomputation
(``torch.utils.checkpoint``) changes no bit of the loss or of any
gradient.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import nequip as ref_nequip_cfg  # noqa: E402
from repro.models import nequip as ref_nequip  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_state as ref_ts  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.configs import nequip as port_nequip_cfg  # noqa: E402
from repro_torch.configs import train as port_train  # noqa: E402
from repro_torch.dataplane import graph as port_graph  # noqa: E402
from repro_torch.dataplane.pipeline import device_put  # noqa: E402
from repro_torch.kernels.segment import ops as sops  # noqa: E402
from repro_torch.kernels.segment import ref as sref  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.models import nequip as port_nequip  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402
from repro_torch.train import train_state as port_ts  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
STEPS = dict(rtol=1e-5, atol=1e-6)
METRICS = dict(rtol=1e-5, atol=0)
REPO = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

def _launch(args: list) -> "subprocess.CompletedProcess":
    """The training launcher in a process of its own, on the port's
    sources."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True, timeout=300)



def _cfgs(readout: str, d_feat: int, n_out: int):
    kw = dict(n_layers=2, channels=8, l_max=2, n_rbf=4, cutoff=5.0,
              d_feat=d_feat, n_out=n_out, readout=readout)
    return port_nequip.NequIPConfig(**kw), ref_nequip.NequIPConfig(**kw)


def _batches() -> dict:
    """A sampled minibatch with a partial label mask, padded molecules
    with energies, and the same molecules with forces too (drawn)."""
    g = port_graph.synthetic_graph(90, 5, 6, 3, seed=1)
    mini = port_graph.minibatch(g, 8, [4, 3], 96, 160, step=2)
    mini["label_mask"][::3] = 0.0
    mol = port_graph.molecule_batch(4, 12, 24, pad_nodes=64, pad_edges=120)
    mol.pop("forces")
    forces = np.random.default_rng(7).normal(
        0, 0.5, mol["positions"].shape).astype(np.float32)
    return {"node_class": ("node_class", 3, mini),
            "energy": ("energy", 1, mol),
            "energy_forces": ("energy", 1, {**mol, "forces": forces})}


def _setup(name: str, seed: int = 3):
    readout, n_out, batch = _batches()[name]
    pcfg, jcfg = _cfgs(readout, batch["node_feat"].shape[1], n_out)
    params = ref_nequip.nequip_init(jax.random.PRNGKey(seed), jcfg)
    model = carry.nequip_from_params(pcfg, _np_tree(params), device="cpu")
    return model, params, jcfg, batch


def _ref_loss(jcfg, batch):
    """The JAX loss of ``batch`` (numpy), ``n_graphs`` closed over."""
    n_graphs = batch.get("n_graphs")
    arrays = {k: v for k, v in batch.items() if k != "n_graphs"}

    def loss(params, b):
        full = {**b, "n_graphs": n_graphs} if n_graphs else b
        return ref_nequip.nequip_loss(params, jcfg, full)

    return jax.jit(loss), {k: jnp.asarray(v) for k, v in arrays.items()}


def _port_batch(batch: dict) -> dict:
    out = device_put({k: v for k, v in batch.items()
                      if isinstance(v, np.ndarray)}, "cpu")
    if "n_graphs" in batch:
        out["n_graphs"] = batch["n_graphs"]
    return out


# -- B7 differentiated twice --------------------------------------------------

class TestSegmentSumTwice:
    @pytest.mark.parametrize("planned", (False, True))
    def test_gradgradcheck_float64_with_dropped_ids(self, planned):
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(-1, 6, 30).astype(np.int32))
        ids[:4] = -1
        msg = torch.from_numpy(rng.normal(size=(30, 3))).requires_grad_()
        seg = sops.segment_plan(ids, 6) if planned else ids

        def f(m):
            return sops.segment_sum(m * m, seg, 6)

        assert torch.autograd.gradcheck(f, (msg,))
        assert torch.autograd.gradgradcheck(f, (msg,))

    def test_second_order_is_the_sum_over_the_same_ids(self, monkeypatch):
        """The backward of the backward of ``segment_sum`` applied to a
        vector v is ``segment_sum(v)``; the plan is the one the forward
        had (its ids, no new plan)."""
        rng = np.random.default_rng(1)
        ids = torch.from_numpy(rng.integers(-1, 5, 40).astype(np.int32))
        plan = sops.segment_plan(ids, 5)
        msg = torch.from_numpy(rng.normal(size=(40, 2))).requires_grad_()
        grad_out = torch.from_numpy(rng.normal(size=(5, 2))
                                    ).requires_grad_()
        (g,) = torch.autograd.grad(sops.segment_sum(msg, plan, 5), msg,
                                   grad_out, create_graph=True)
        assert torch.equal(g.detach(), sref.segment_sum_backward(
            grad_out.detach(), ids))
        v = torch.from_numpy(rng.normal(size=(40, 2)))
        built = []
        real = sref.build_plan
        monkeypatch.setattr(sref, "build_plan",
                            lambda *a: built.append(a) or real(*a))
        (gg,) = torch.autograd.grad(g, grad_out, v)
        assert not built
        assert torch.equal(gg, sref.segment_sum(v, plan, 5))


# -- the loss in its three branches -------------------------------------------

class TestNequIPLoss:
    @pytest.mark.parametrize("name", ("node_class", "energy",
                                      "energy_forces"))
    def test_loss_and_every_gradient_equal_jax(self, name):
        model, params, jcfg, batch = _setup(name)
        loss_fn, jb = _ref_loss(jcfg, batch)
        want_loss = float(loss_fn(params, jb))
        want = _paths(jax.jit(jax.grad(loss_fn))(params, jb))
        loss = port_nequip.nequip_loss(model, _port_batch(batch))
        np.testing.assert_allclose(float(loss.detach()), want_loss, **F32)
        got = dict(zip(carry.model_params(model), torch.autograd.grad(
            loss, list(carry.model_params(model).values()),
            allow_unused=True)))
        assert set(got) == set(want)
        for path, w in want.items():
            g = np.zeros_like(w) if got[path] is None else got[path].numpy()
            np.testing.assert_allclose(g, w, **F32, err_msg=path)
        if name == "energy_forces":
            assert max(np.abs(w).max() for w in want.values()) > 1e-2

    def test_forces_stay_attached_with_create_graph(self):
        model, params, jcfg, batch = _setup("energy_forces")
        pb = _port_batch(batch)
        args = (pb["node_feat"], pb["positions"], pb["edge_index"], None,
                pb["graph_ids"], pb["n_graphs"])
        e, f = port_nequip.nequip_energy_forces(model, *args,
                                                create_graph=True)
        assert e.requires_grad and f.requires_grad
        e0, f0 = port_nequip.nequip_energy_forces(model, *args)
        assert not e0.requires_grad and not f0.requires_grad
        assert torch.equal(e.detach(), e0)
        # A backward that builds its own graph may take some products in
        # another order: the forces agree to the last bits.
        np.testing.assert_allclose(f.detach().numpy(), f0.numpy(),
                                   rtol=1e-6, atol=1e-9)
        e_want, f_want = ref_nequip.nequip_energy_forces(
            params, jcfg, jnp.asarray(batch["node_feat"]),
            jnp.asarray(batch["positions"]), jnp.asarray(batch["edge_index"]),
            graph_ids=jnp.asarray(batch["graph_ids"]),
            n_graphs=batch["n_graphs"])
        np.testing.assert_allclose(f0.numpy(), np.asarray(f_want), **F32)
        np.testing.assert_allclose(e0.numpy(), np.asarray(e_want), **F32)

    @pytest.mark.parametrize("name", ("node_class", "energy_forces"))
    def test_recomputation_changes_no_bit(self, name, monkeypatch):
        model, _, _, batch = _setup(name)
        params = list(model.parameters())

        def grads():
            loss = port_nequip.nequip_loss(model, _port_batch(batch))
            return loss, torch.autograd.grad(loss, params,
                                             allow_unused=True)

        calls = []
        real = port_nequip.checkpoint

        def counting(fn, *a, **kw):
            calls.append(fn)
            return real(fn, *a, **kw)

        monkeypatch.setattr(port_nequip, "checkpoint", counting)
        loss, got = grads()
        assert len(calls) == model.cfg.n_layers
        monkeypatch.setattr(port_nequip, "checkpoint",
                            lambda fn, *a, **kw: fn(*a))
        loss2, want = grads()
        assert torch.equal(loss, loss2)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)

    @pytest.mark.parametrize("name", ("node_class", "energy"))
    def test_training_forward_changes_no_bit(self, name, monkeypatch):
        """``remat`` (each layer recomputed in the backward pass) against
        the forward without it: the same outputs and gradients to the
        bit, from the same segment plans."""
        model, _, _, batch = _setup(name)
        pb = _port_batch(batch)
        args = (pb["node_feat"], pb["positions"], pb["edge_index"], None)
        kw = {} if name == "node_class" else dict(
            graph_ids=pb["graph_ids"], n_graphs=pb["n_graphs"])
        params = list(model.parameters())
        plans = []
        real = sops.segment_plan
        monkeypatch.setattr(sops, "segment_plan",
                            lambda *a: plans.append(a) or real(*a))
        runs = []
        for remat in (True, False):
            out = model(*args, **kw, remat=remat)
            runs.append((out, torch.autograd.grad(
                out.square().sum(), params, allow_unused=True)))
        # Destination and source ids, and for energies the graph ids.
        assert len(plans) == 2 * (2 + (name == "energy"))
        (got, g_got), (want, g_want) = runs
        assert torch.equal(got, want)
        for g, w in zip(g_got, g_want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)

    def test_no_recomputation_without_a_gradient(self, monkeypatch):
        model, _, _, batch = _setup("node_class")
        monkeypatch.setattr(port_nequip, "checkpoint", None)
        with torch.no_grad():
            port_nequip.nequip_loss(model, _port_batch(batch))

    def test_model_params_are_the_jax_paths(self):
        model, params, _, _ = _setup("energy")
        assert set(carry.model_params(model)) == set(_paths(params))


# -- train steps, set-up and launcher -----------------------------------------

class TestTrainSteps:
    @pytest.mark.parametrize("name", ("node_class", "energy_forces"))
    def test_three_steps_equal_jax(self, name):
        fields = dict(kind="adamw", lr=1e-3, warmup_steps=2, total_steps=10)
        ref_oc = ref_opt.OptimizerConfig(**fields)
        port_oc = port_opt.OptimizerConfig(**fields)
        model, params, jcfg, batch = _setup(name, seed=5)
        loss_fn, jb = _ref_loss(jcfg, batch)
        state = ref_ts.init_train_state(params, ref_oc)
        ref_step = jax.jit(ref_ts.make_train_step(
            lambda p, b: (loss_fn(p, b), {}), ref_oc))
        pstate = carry.train_state_from_tree(model, _np_tree(state))
        port_step = port_ts.make_train_step(
            port_train.loss_for("nequip", model), port_oc)
        pb = _port_batch(batch)
        for i in range(3):
            state, want = ref_step(state, jb)
            pstate, got = port_step(pstate, pb)
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           **METRICS, err_msg=f"{i} {k}")
        got, want = _paths(carry.train_state_to_tree(pstate)), _paths(state)
        assert set(got) == set(want)
        for key, w in want.items():
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], w, **STEPS, err_msg=key)

    def test_smoke_set_up_is_the_jax_smoke(self):
        ref = ref_nequip_cfg.get().smoke()
        port = port_train.smoke("nequip", device="cpu")
        for k, v in ref["batch"].items():
            np.testing.assert_array_equal(port["batch"][k], np.asarray(v),
                                          err_msg=k)
        assert port["kind"] == "nequip" and port["family"] == "gnn"
        assert port["cfg"].readout == "node_class"
        assert (port["cfg"].d_feat, port["cfg"].n_out) == (8, 3)
        assert dataclasses.asdict(port["opt"]) == dataclasses.asdict(
            ref_opt.OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=100,
                                    total_steps=50_000))
        assert port_nequip_cfg._opt() == port["opt"]
        _, metrics = port["step"](port["state"],
                                  device_put(port["batch"], "cpu"))
        assert np.isfinite(float(metrics["loss"]))

    def test_data_source_is_the_jax_launchers(self):
        from repro.dataplane import graph as ref_graph

        smoke = port_train.smoke("nequip", device="cpu")
        source = port_launch.data_source_for(smoke, torch.device("cpu"))
        g = ref_graph.synthetic_graph(512, 8, 8, 3)
        for step in (0, 3):
            want = ref_graph.minibatch(g, 8, [4, 3], 16, 40, step=step)
            got = source(step)
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    def test_launcher_two_steps(self, tmp_path):
        """``python -m repro_torch.launch.train --arch nequip --device
        cpu --steps 2`` exits 0."""
        out = _launch(["--arch", "nequip", "--device", "cpu", "--steps",
                       "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)])
        assert out.returncode == 0, out.stderr
        assert "done: 2 steps" in out.stdout
