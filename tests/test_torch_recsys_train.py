"""Recsys training on the port == the JAX package's, on the CPU.

The losses, their gradients and whole train steps of DLRM-RM2, DeepFM
and two-tower (smoke configurations, parameters drawn by the JAX
initialisers and carried with ``repro_torch.carry``) against the JAX
functions under ``jax.jit``.  On the CPU kernels B6 and B1 run their
plain versions, and their backward is plain PyTorch on every device.

Tolerances: a loss and each gradient within rtol = atol = 2e-5, the JAX
tests' float32 tolerance (XLA orders its sums and products its own
way).  After three optimizer steps the parameters and every state leaf
within rtol = 1e-5, atol = 1e-6 (float32 bias corrections and schedule
may differ by an ulp between XLA and PyTorch); ``step`` exactly, and
``loss``, ``grad_norm``, ``lr`` within rtol = 1e-5; an error-feedback
leaf within rtol = 1e-5 of the gradient's size (``_assert_tree_close``).
The carried state's round trip and checkpoints read across the packages
are byte-equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deepfm as ref_deepfm_cfg  # noqa: E402
from repro.configs import dlrm_rm2 as ref_dlrm_cfg  # noqa: E402
from repro.configs import two_tower_retrieval as ref_tt_cfg  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recsys as ref_recsys  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_state as ref_ts  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.configs import deepfm as port_deepfm_cfg  # noqa: E402
from repro_torch.configs import dlrm_rm2 as port_dlrm_cfg  # noqa: E402
from repro_torch.configs import train as port_train  # noqa: E402
from repro_torch.configs import two_tower_retrieval as port_tt_cfg  # noqa: E402
from repro_torch.dataplane.pipeline import device_put  # noqa: E402
from repro_torch.distributed import compression as port_comp  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import recsys as port_recsys  # noqa: E402
from repro_torch.train import checkpoint as port_ckpt  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402
from repro_torch.train import train_state as port_ts  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
STEPS = dict(rtol=1e-5, atol=1e-6)
METRICS = dict(rtol=1e-5, atol=0)

ARCHS = ("dlrm-rm2", "deepfm", "two-tower-retrieval")
REF_LOSS = {"dlrm-rm2": ref_recsys.dlrm_loss, "deepfm": ref_recsys.deepfm_loss,
            "two-tower-retrieval": ref_recsys.twotower_loss}
REF_INIT = {"dlrm-rm2": ref_recsys.dlrm_init,
            "deepfm": ref_recsys.deepfm_init,
            "two-tower-retrieval": ref_recsys.twotower_init}
CFG_MODS = {"dlrm-rm2": (ref_dlrm_cfg, port_dlrm_cfg),
            "deepfm": (ref_deepfm_cfg, port_deepfm_cfg),
            "two-tower-retrieval": (ref_tt_cfg, port_tt_cfg)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree) -> dict:
    """{"a/b/0/c": leaf} of a JAX tree, the checkpoint's keys."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(port_tree, jax_tree, tol, what):
    """Every leaf within ``tol``; integers exactly.  An error-feedback
    leaf (``ef/…``) is the residual g - q·scale of int8 rounding, a
    difference of two numbers of the gradient's size: |ef| <= scale / 2 =
    max|g| / 254, so it is held within ``tol``'s rtol of max|g| >=
    254·max|ef| (absolute), not of itself."""
    got, want = _paths(port_tree), _paths(jax_tree)
    assert set(got) == set(want), what
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what} {key}"
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")
        elif key.startswith("ef/"):
            atol = tol["rtol"] * 254 * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=max(atol,
                                                              tol["atol"]),
                                       err_msg=f"{what} {key}")
        else:
            np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} {key}")


def _cfgs(arch_id: str, **changes):
    ref_mod, port_mod = CFG_MODS[arch_id]
    return (dataclasses.replace(ref_mod._smoke(), **changes),
            dataclasses.replace(port_mod._smoke(), **changes))


def _carried(arch_id: str, ref_cfg, port_cfg, seed: int = 0):
    """(JAX params, the port's model holding them)."""
    params = REF_INIT[arch_id](jax.random.PRNGKey(seed), ref_cfg)
    model = port_train._MODELS[port_train.KINDS[arch_id]](port_cfg,
                                                          device="cpu")
    carry._load_params(model, _np_tree(params), arch_id)
    return params, model


def _batch(arch_id: str, cfg, seed: int, n: int = 8, padded: bool = False):
    """A numpy batch; with ``padded``, -1 slots and repeated ids in the
    bags (and repeated ids for two-tower)."""
    rng = np.random.default_rng(seed)
    if arch_id == "two-tower-retrieval":
        users = rng.integers(0, cfg.n_users, n).astype(np.int32)
        items = rng.integers(0, cfg.n_items, n).astype(np.int32)
        if padded:
            users[1], items[3] = users[0], items[2]
        return {"user_ids": users, "item_ids": items,
                "item_logq": -np.log1p(items).astype(np.float32)}
    n_slots = getattr(cfg, "bag_size", 1)
    bags = rng.integers(0, cfg.rows, (n, cfg.n_sparse, n_slots)).astype(
        np.int32)
    if padded:
        bags[rng.random(bags.shape) < 0.3] = -1
        bags[1] = bags[0]                    # every id read twice
        bags[2, :, 0] = -1                   # a whole row of empty bags
    out = {"bags": bags,
           "labels": rng.integers(0, 2, n).astype(np.float32)}
    if arch_id == "dlrm-rm2":
        out["dense"] = rng.normal(size=(n, cfg.n_dense)).astype(np.float32)
    return out


def _port_loss(arch_id, model, batch):
    kind = port_train.KINDS[arch_id]
    return port_train.loss_for(kind, model)(None, device_put(batch, "cpu"))


# -- the Functions of B6 and B1 ---------------------------------------------

class TestGatherGradients:
    def test_bag_gradcheck_float64(self):
        rng = np.random.default_rng(0)
        table = torch.tensor(rng.normal(size=(7, 3)), dtype=torch.float64,
                             requires_grad=True)
        bags = torch.tensor([[0, 3, -1], [3, 3, 6], [-1, -1, -1],
                             [1, 0, 2]], dtype=torch.int32)
        assert torch.autograd.gradcheck(
            lambda t: gops.gather_rows_bag(t, bags), (table,))

    def test_rows_gradcheck_float64(self):
        rng = np.random.default_rng(1)
        table = torch.tensor(rng.normal(size=(6, 4)), dtype=torch.float64,
                             requires_grad=True)
        idx = np.array([5, 0, 5, 2, 2, 2], np.int32)
        assert torch.autograd.gradcheck(
            lambda t: gops.gather_rows(t, idx), (table,))

    def test_bag_backward_equals_jax_scatter(self):
        """The table gradient of a weighted bag sum: repeated ids add up,
        -1 slots add nothing, unread rows stay 0."""
        rng = np.random.default_rng(2)
        table = rng.normal(size=(9, 5)).astype(np.float32)
        bags = rng.integers(-1, 9, (16, 4)).astype(np.int32)
        bags[0] = -1
        bags[1] = bags[2]
        w = rng.normal(size=(16, 5)).astype(np.float32)

        def ref(t):
            params = {"tables": t[None]}
            return jnp.sum(ref_recsys.embedding_bag(
                params, jnp.asarray(bags)[:, None, :])[:, 0] * w)

        want = np.asarray(jax.grad(ref)(jnp.asarray(table)))
        t = torch.tensor(table, requires_grad=True)
        (gops.gather_rows_bag(t, bags) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(t.grad.numpy(), want, **F32)
        unread = np.setdiff1d(np.arange(9), bags[bags >= 0])
        assert (t.grad.numpy()[unread] == 0).all()


# -- losses and gradients ------------------------------------------------------

class TestLossesAndGradients:
    @pytest.mark.parametrize("arch_id, padded", (
        ("dlrm-rm2", False), ("dlrm-rm2", True), ("deepfm", False),
        ("two-tower-retrieval", False), ("two-tower-retrieval", True)))
    def test_loss_and_every_gradient_equal_jax(self, arch_id, padded):
        """With ``padded``: DLRM at L = 3 with -1 slots and every id of a
        row read twice, two-tower with repeated user and item ids
        (DeepFM's padded case is the next test)."""
        changes = {"bag_size": 3} if arch_id == "dlrm-rm2" and padded else {}
        ref_cfg, port_cfg = _cfgs(arch_id, **changes)
        params, model = _carried(arch_id, ref_cfg, port_cfg, seed=3)
        batch = _batch(arch_id, port_cfg, seed=4, padded=padded)
        loss_fn = jax.jit(lambda p, b: REF_LOSS[arch_id](p, ref_cfg, b))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want_loss = float(loss_fn(params, jb))
        want = _paths(jax.jit(jax.grad(loss_fn))(params, jb))
        loss, _ = _port_loss(arch_id, model, batch)
        np.testing.assert_allclose(float(loss.detach()), want_loss, **F32)
        loss.backward()
        got = {path: p.grad.numpy()
               for path, p in carry.model_params(model).items()}
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, **F32, err_msg=path)

    def test_deepfm_padded_bags_gradient(self):
        """DeepFM's bags at L = 3 with -1 slots and repeated ids (both
        packages accept them, though the JAX batch recipe draws L = 1)."""
        ref_cfg, port_cfg = _cfgs("deepfm")
        params, model = _carried("deepfm", ref_cfg, port_cfg, seed=5)
        rng = np.random.default_rng(6)
        bags = rng.integers(-1, port_cfg.rows, (8, port_cfg.n_sparse, 3)
                            ).astype(np.int32)
        bags[3] = bags[4]
        batch = {"bags": bags,
                 "labels": rng.integers(0, 2, 8).astype(np.float32)}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = _paths(jax.grad(lambda p: ref_recsys.deepfm_loss(
            p, ref_cfg, jb))(params))
        loss, _ = _port_loss("deepfm", model, batch)
        loss.backward()
        for path, p in carry.model_params(model).items():
            np.testing.assert_allclose(p.grad.numpy(), want[path], **F32,
                                       err_msg=path)

    @pytest.mark.parametrize("masked", (False, True))
    def test_cross_entropy_and_gradient(self, masked):
        rng = np.random.default_rng(7)
        logits = rng.normal(size=(6, 11)).astype(np.float32) * 4
        labels = rng.integers(0, 11, 6).astype(np.int32)
        mask = (rng.random(6) < 0.6).astype(np.float32) if masked else None

        def ref(x):
            return ref_layers.cross_entropy(
                x, jnp.asarray(labels),
                None if mask is None else jnp.asarray(mask))

        x = torch.tensor(logits, requires_grad=True)
        got = port_layers.cross_entropy(
            x, torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref(logits)),
                                   **F32)
        np.testing.assert_allclose(x.grad.numpy(),
                                   np.asarray(jax.grad(ref)(logits)), **F32)

    def test_bce_matches_jax(self):
        rng = np.random.default_rng(8)
        logits = (rng.normal(size=64) * 30).astype(np.float32)
        labels = rng.integers(0, 2, 64).astype(np.float32)
        want = float(ref_recsys._bce(jnp.asarray(logits),
                                     jnp.asarray(labels)))
        got = float(port_recsys._bce(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, **F32)


# -- train steps ----------------------------------------------------------------

VARIANTS = {
    "adamw": dict(kind="adamw", accum=1, compress=False),
    "adafactor": dict(kind="adafactor", accum=1, compress=False),
    "accum2": dict(kind="adamw", accum=2, compress=False),
    "compressed": dict(kind="adamw", accum=1, compress=True),
}


def _opt_cfgs(kind):
    """The configurations' optimizer with a short warmup and decay, so
    that three steps move the learning rate well off 0 and along the
    cosine."""
    fields = dict(kind=kind, lr=1e-3, warmup_steps=2, total_steps=10)
    return ref_opt.OptimizerConfig(**fields), port_opt.OptimizerConfig(**fields)


def _ref_opt_cfg(ref_mod):
    """The ``OptimizerConfig`` a JAX configuration module's ``get()``
    hands ``recsys_arch`` (closed over by its ``smoke``)."""
    cells = [c.cell_contents for c in ref_mod.get().smoke.__closure__]
    (cfg,) = [c for c in cells if isinstance(c, ref_opt.OptimizerConfig)]
    return cfg


class TestTrainSteps:
    @pytest.mark.parametrize("variant", tuple(VARIANTS))
    @pytest.mark.parametrize("arch_id", ARCHS)
    def test_three_steps_equal_jax(self, arch_id, variant):
        v = VARIANTS[variant]
        ref_cfg, port_cfg = _cfgs(arch_id)
        ref_oc, port_oc = _opt_cfgs(v["kind"])
        params, model = _carried(arch_id, ref_cfg, port_cfg, seed=9)
        state = ref_ts.init_train_state(params, ref_oc)
        if v["compress"]:
            state["ef"] = ref_comp.init_error_feedback(params)
        ref_step = jax.jit(ref_ts.make_train_step(
            lambda p, b: (REF_LOSS[arch_id](p, ref_cfg, b), {}), ref_oc,
            accum_steps=v["accum"],
            compressor=ref_comp.compress_grads if v["compress"] else None))
        pstate = carry.train_state_from_tree(model, _np_tree(state))
        port_step = port_ts.make_train_step(
            port_train.loss_for(port_train.KINDS[arch_id], model), port_oc,
            accum_steps=v["accum"],
            compressor=port_comp.compress_grads if v["compress"] else None)
        for i in range(3):
            batch = _batch(arch_id, port_cfg, seed=10 + i)
            state, want = ref_step(state, {k: jnp.asarray(x)
                                           for k, x in batch.items()})
            pstate, got = port_step(pstate, device_put(batch, "cpu"))
            assert set(got) == set(want) == {"loss", "grad_norm", "lr"}
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           **METRICS, err_msg=f"{i} {k}")
        _assert_tree_close(carry.train_state_to_tree(pstate), state, STEPS,
                           f"{arch_id} {variant}")
        assert int(pstate["opt"]["step"]) == 3
        # The step updates the model's own parameters.
        for path, p in carry.model_params(model).items():
            assert p is pstate["params"][path]

    @pytest.mark.parametrize("arch_id", ARCHS)
    def test_optimizer_is_the_jax_configurations(self, arch_id):
        ref_mod, port_mod = CFG_MODS[arch_id]
        assert dataclasses.asdict(port_mod._opt()) == dataclasses.asdict(
            _ref_opt_cfg(ref_mod))


# -- the state crosses both ways -------------------------------------------------

class TestCarry:
    @pytest.mark.parametrize("kind", ("adamw", "adafactor"))
    @pytest.mark.parametrize("arch_id", ARCHS)
    def test_round_trip_is_byte_equal(self, arch_id, kind):
        ref_cfg, port_cfg = _cfgs(arch_id)
        params, model = _carried(arch_id, ref_cfg, port_cfg, seed=11)
        oc = ref_opt.OptimizerConfig(kind=kind)
        state = ref_ts.init_train_state(params, oc)
        # Non-zero moments and step, so the round trip is not of zeros.
        rng = np.random.default_rng(12)
        state = jax.tree_util.tree_map(
            lambda x: np.asarray(rng.normal(size=np.shape(x)),
                                 np.asarray(x).dtype)
            if np.asarray(x).dtype.kind == "f" else np.asarray(x) + 7,
            state)
        state["ef"] = jax.tree_util.tree_map(np.asarray, params)
        back = carry.train_state_to_tree(
            carry.train_state_from_tree(model, state))
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(state)
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(back)[0],
                jax.tree_util.tree_flatten_with_path(state)[0]):
            assert a.dtype == b.dtype and a.shape == b.shape, p
            assert a.tobytes() == np.asarray(b).tobytes(), p

    def test_model_params_are_the_jax_paths(self):
        for arch_id in ARCHS:
            ref_cfg, port_cfg = _cfgs(arch_id)
            params, model = _carried(arch_id, ref_cfg, port_cfg)
            assert set(carry.model_params(model)) == set(_paths(params))

    def test_mismatched_tree_raises(self):
        ref_cfg, port_cfg = _cfgs("deepfm")
        params, model = _carried("deepfm", ref_cfg, port_cfg)
        state = _np_tree(ref_ts.init_train_state(
            params, ref_opt.OptimizerConfig()))
        del state["opt"]["m"]["bias"]
        with pytest.raises(ValueError, match="opt.m"):
            carry.train_state_from_tree(model, state)


class TestCheckpointsAcrossPackages:
    @pytest.mark.parametrize("kind", ("adamw", "adafactor"))
    @pytest.mark.parametrize("arch_id", ARCHS)
    def test_each_package_restores_the_others(self, tmp_path, arch_id,
                                              kind):
        ref_cfg, port_cfg = _cfgs(arch_id)
        params, model = _carried(arch_id, ref_cfg, port_cfg, seed=13)
        oc = ref_opt.OptimizerConfig(kind=kind)
        rng = np.random.default_rng(14)
        state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=np.shape(x)), x.dtype)
            if x.dtype.kind == "f" else x + 5,
            ref_ts.init_train_state(params, oc))
        # JAX writes, the port reads.
        ref_ckpt.save_checkpoint(tmp_path / "jax", 4, state)
        _, fresh = _carried(arch_id, ref_cfg, port_cfg, seed=15)
        pstate = port_ts.init_train_state(
            carry.model_params(fresh), port_opt.OptimizerConfig(kind=kind))
        port_ckpt.restore_checkpoint(tmp_path / "jax", 4, pstate)
        got = _paths(carry.train_state_to_tree(pstate))
        for key, want in _paths(state).items():
            assert got[key].tobytes() == want.tobytes(), key
        # The port writes, JAX reads.
        port_ckpt.save_checkpoint(tmp_path / "port", 6, pstate)
        assert ref_ckpt.latest_step(tmp_path / "port") == 6
        target = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
        back = ref_ckpt.restore_checkpoint(tmp_path / "port", 6, target)
        for key, want in _paths(state).items():
            assert _paths(back)[key].tobytes() == want.tobytes(), key
