"""The port's ``train`` package, compression and training launcher ==
the JAX package's, on the CPU.

The schedule, the global norm and its clip, and one and three AdamW and
Adafactor updates on a tree with 0-, 1-, 2- and 3-D leaves against
``repro.train.optimizer`` under ``jax.jit``: within rtol = 1e-5, atol =
1e-6 (XLA and PyTorch may round a float32 ``b ** step``, ``cos`` or sum
an ulp apart), ``step`` exactly.  int8 quantisation exactly; the
error-feedback residual within an ulp of the input's size.  Checkpoints
written by either package restore byte for byte in the other.  The
launcher's recsys batches are byte-equal to the JAX launcher's.  The
rest mirrors ``tests/test_train.py``, ``tests/test_compression.py`` and
``tests/test_fault.py`` on the port.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.launch import train as ref_launch  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_state as ref_ts  # noqa: E402

from repro_torch.configs import train as port_train  # noqa: E402
from repro_torch.dataplane import pipeline as port_pipe  # noqa: E402
from repro_torch.dataplane.pipeline import Prefetcher  # noqa: E402
from repro_torch.distributed import compression as port_comp  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.train import checkpoint as port_ckpt  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402
from repro_torch.train.fault import (FaultConfig, StragglerMonitor,  # noqa: E402
                                     Supervisor)
from repro_torch.train.train_state import (init_train_state,  # noqa: E402
                                           make_train_step)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"s": (), "b": (5,), "w": (4, 6), "t": (3, 5, 4)}


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree: dict) -> dict:
    return {k: torch.tensor(v) for k, v in tree.items()}


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_close(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_close(got[k], want[k], f"{what}/{k}")
        return
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)


# -- optimizer ------------------------------------------------------------------

class TestAgainstJax:
    @pytest.mark.parametrize("step", (0, 1, 7, 100, 101, 2500, 10_000,
                                      20_000))
    def test_schedule(self, step):
        cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
        want = jax.jit(lambda s: ref_opt.schedule(
            ref_opt.OptimizerConfig(**cfg), s))(jnp.asarray(step))
        got = port_opt.schedule(port_opt.OptimizerConfig(**cfg),
                                torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    @pytest.mark.parametrize("scale", (1e-3, 1.0, 10.0))
    def test_global_norm_and_clip(self, scale):
        tree = _tree(0, scale)
        want, want_norm = jax.jit(
            lambda t: ref_opt.clip_by_global_norm(t, 1.0))(tree)
        got, got_norm = port_opt.clip_by_global_norm(_torch(tree), 1.0)
        np.testing.assert_allclose(
            float(port_opt.global_norm(_torch(tree))),
            float(jax.jit(ref_opt.global_norm)(tree)), rtol=1e-6)
        np.testing.assert_allclose(float(got_norm), float(want_norm),
                                   rtol=1e-6)
        _assert_close(got, want, "clipped")

    @pytest.mark.parametrize("n_steps", (1, 3))
    @pytest.mark.parametrize("kind", ("adamw", "adafactor"))
    def test_updates_equal_jax(self, kind, n_steps):
        fields = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=50)
        ref_init, ref_update = ref_opt.make_optimizer(
            ref_opt.OptimizerConfig(**fields))
        port_init, port_update = port_opt.make_optimizer(
            port_opt.OptimizerConfig(**fields))
        ref_update = jax.jit(ref_update)
        params = _tree(1)
        ref_state = ref_init(params)
        pparams = _torch(params)
        pstate = port_init(pparams)
        for i in range(n_steps):
            grads = _tree(10 + i, scale=0.5 if i else 5.0)  # step 0 clips
            params, ref_state, want = ref_update(grads, ref_state, params)
            pparams, pstate, got = port_update(_torch(grads), pstate,
                                               pparams)
            for k in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           rtol=1e-5)
        _assert_close(pparams, params, "params")
        _assert_close(pstate, ref_state, "state")
        assert pstate["step"].dtype == torch.int32
        assert int(pstate["step"]) == n_steps


class TestOptimizers:
    @pytest.mark.parametrize("kind", ["adamw", "adafactor"])
    def test_converges_on_quadratic(self, kind):
        cfg = port_opt.OptimizerConfig(kind=kind, lr=0.1, weight_decay=0.0,
                                       warmup_steps=10, total_steps=500)
        init, update = port_opt.make_optimizer(cfg)
        params = {"w": torch.full((8, 4), 5.0)}
        state = init(params)
        for _ in range(300):
            grads = {"w": 2 * (params["w"] - 2.0)}
            params, state, _ = update(grads, state, params)
        np.testing.assert_allclose(params["w"].numpy(), 2.0, atol=0.3)

    def test_adafactor_state_is_factored(self):
        params = {"w": torch.zeros((64, 32)), "b": torch.zeros((32,)),
                  "t": torch.zeros((3, 64, 32))}
        st = port_opt.adafactor_init(params)
        assert st["f"]["w"]["vr"].shape == (64,)
        assert st["f"]["w"]["vc"].shape == (32,)
        assert st["f"]["b"]["v"].shape == (32,)
        assert st["f"]["t"]["vr"].shape == (3, 64)
        assert st["f"]["t"]["vc"].shape == (3, 32)

    def test_adamw_bias_correction_first_step(self):
        cfg = port_opt.OptimizerConfig(kind="adamw", lr=1e-1,
                                       weight_decay=0.0, warmup_steps=0,
                                       total_steps=100_000)
        params = {"w": torch.zeros((4, 4))}
        state = port_opt.adamw_init(params)
        new_params, state, _ = port_opt.adamw_update(
            cfg, {"w": torch.ones((4, 4))}, state, params)
        # bias-corrected first step ≈ -lr * g/|g|
        np.testing.assert_allclose(new_params["w"].numpy(), -0.1,
                                   rtol=1e-3)

    def test_weight_decay_only_on_matrices(self):
        cfg = port_opt.OptimizerConfig(kind="adamw", lr=1e-1,
                                       warmup_steps=0, weight_decay=0.5)
        params = {k: torch.ones(s) for k, s in SHAPES.items()}
        state = port_opt.adamw_init(params)
        grads = {k: torch.zeros(s) for k, s in SHAPES.items()}
        port_opt.adamw_update(cfg, grads, state, params)
        for k in ("s", "b"):
            assert bool((params[k] == 1.0).all()), k
        for k in ("w", "t"):
            assert bool((params[k] < 1.0).all()), k

    def test_warmup_then_cosine(self):
        cfg = port_opt.OptimizerConfig(lr=1.0, warmup_steps=100,
                                       total_steps=1000, min_lr_ratio=0.1)
        sched = lambda s: float(port_opt.schedule(cfg, torch.tensor(s)))
        assert sched(0) == 0.0
        assert abs(sched(100) - 1.0) < 1e-5
        assert abs(sched(1000) - 0.1) < 1e-5

    def test_clip(self):
        clipped, norm = port_opt.clip_by_global_norm(
            {"a": torch.full((10,), 10.0)}, 1.0)
        assert abs(float(port_opt.global_norm(clipped)) - 1.0) < 1e-5
        assert float(norm) > 1.0


class TestTrainStep:
    def test_accum_equivalence(self):
        """accum_steps=4 must equal the full-batch gradient step."""
        cfg = port_opt.OptimizerConfig(kind="adamw", lr=0.01,
                                       weight_decay=0.0, warmup_steps=0,
                                       total_steps=100)

        def loss_fn(params, batch):
            pred = batch["x"] @ params["w"]
            return torch.mean(torch.square(pred - batch["y"])), {}

        rng = np.random.default_rng(0)
        w = rng.normal(size=(8, 2)).astype(np.float32)
        batch = {"x": torch.tensor(rng.normal(size=(16, 8)),
                                   dtype=torch.float32),
                 "y": torch.tensor(rng.normal(size=(16, 2)),
                                   dtype=torch.float32)}
        s1 = init_train_state({"w": torch.tensor(w)}, cfg)
        s4 = init_train_state({"w": torch.tensor(w)}, cfg)
        s1, _ = make_train_step(loss_fn, cfg, accum_steps=1)(s1, batch)
        s4, _ = make_train_step(loss_fn, cfg, accum_steps=4)(s4, batch)
        np.testing.assert_allclose(s1["params"]["w"].detach().numpy(),
                                   s4["params"]["w"].detach().numpy(),
                                   rtol=2e-5, atol=2e-5)

    def test_metrics_contain_loss_and_lr(self):
        cfg = port_opt.OptimizerConfig(kind="adamw", lr=0.01,
                                       warmup_steps=0, total_steps=100)
        step = make_train_step(
            lambda p, b: (torch.sum(p["w"] ** 2), {"aux": p["w"].sum()}),
            cfg)
        state = init_train_state({"w": torch.ones((2, 2),
                                                  requires_grad=True)}, cfg)
        _, metrics = step(state, {"unused": torch.zeros(())})
        assert {"loss", "lr", "grad_norm", "aux"} <= set(metrics)

    def test_shared_and_broadcast_gradients_equal_jax(self):
        """Two parameters whose gradient autograd hands over as one tensor
        (``a + b``) and one whose gradient is a broadcast view (``c``'s
        sum): each clipped and updated once, as in JAX."""
        fields = dict(kind="adamw", lr=0.1, warmup_steps=0, grad_clip=0.5)
        rng = np.random.default_rng(5)
        tree = {k: rng.normal(size=(3, 4)).astype(np.float32)
                for k in "abc"}

        def ref_loss(p, _):
            return jnp.sum(jnp.square(p["a"] + p["b"])) + jnp.sum(p["c"]), {}

        def port_loss(p, _):
            return torch.sum(torch.square(p["a"] + p["b"])) \
                + torch.sum(p["c"]), {}

        ref_state = ref_ts.init_train_state(tree, ref_opt.OptimizerConfig(
            **fields))
        state = init_train_state(_torch(tree), port_opt.OptimizerConfig(
            **fields))
        ref_step = jax.jit(ref_ts.make_train_step(
            ref_loss, ref_opt.OptimizerConfig(**fields)))
        step = make_train_step(port_loss, port_opt.OptimizerConfig(**fields))
        for _ in range(2):
            ref_state, _ = ref_step(ref_state, jnp.zeros(()))
            state, _ = step(state, torch.zeros(()))
        _assert_close(state["params"], ref_state["params"], "params")
        _assert_close(state["opt"], ref_state["opt"], "opt")

    def test_failed_step_leaves_state_untouched(self):
        """A loss that raises leaves params and optimizer state as they
        were, so the supervisor can replay the step from memory."""
        cfg = port_opt.OptimizerConfig(lr=0.1, warmup_steps=0)
        state = init_train_state({"w": torch.ones((3, 3),
                                                  requires_grad=True)}, cfg)
        ok = make_train_step(lambda p, b: (torch.sum(p["w"] * b), {}), cfg)
        state, _ = ok(state, torch.full((3, 3), 2.0))
        before = {k: v.clone() for k, v in port_ckpt.flatten_tree(
            state).items()}

        def boom(p, b):
            torch.sum(p["w"] * b).backward(retain_graph=False)
            raise RuntimeError("a fault after the backward")

        with pytest.raises(RuntimeError):
            make_train_step(boom, cfg)(state, torch.ones((3, 3)))
        for k, v in port_ckpt.flatten_tree(state).items():
            assert torch.equal(v, before[k]), k


# -- compression ----------------------------------------------------------------

class TestCompression:
    @pytest.mark.parametrize("scale", (1e-4, 3.0))
    def test_quantize_equals_jax(self, scale):
        rng = np.random.default_rng(0)
        x = (rng.normal(size=(257,)) * scale).astype(np.float32)
        x[:3] = [0.0, scale, -scale]
        q, s = jax.jit(ref_comp.quantize_int8)(x)
        pq, ps = port_comp.quantize_int8(torch.from_numpy(x))
        assert pq.dtype == torch.int8
        np.testing.assert_array_equal(pq.numpy(), np.asarray(q))
        assert float(ps) == float(s)
        np.testing.assert_array_equal(
            port_comp.dequantize_int8(pq, ps).numpy(),
            np.asarray(ref_comp.dequantize_int8(q, s)))

    def test_roundtrip_error_bound(self):
        rng = np.random.default_rng(0)
        x = torch.tensor(rng.normal(0, 3, (128,)), dtype=torch.float32)
        q, scale = port_comp.quantize_int8(x)
        err = (port_comp.dequantize_int8(q, scale) - x).abs()
        assert float(err.max()) <= float(scale) * 0.5 + 1e-6

    def test_zero_tensor(self):
        q, _ = port_comp.quantize_int8(torch.zeros(16))
        assert bool((q == 0).all())

    def test_error_feedback_equals_jax(self):
        grads = _tree(3)
        ef = _tree(4, scale=1e-3)
        want_g, want_s = ref_comp.compress_grads(grads, {"ef": ef})
        got_g, got_s = port_comp.compress_grads(_torch(grads),
                                                {"ef": _torch(ef)})
        _assert_close(got_g, want_g, "grads")
        _assert_close(got_s["ef"], want_s["ef"], "ef")

    def test_ef_carries_residual(self):
        grads = {"w": torch.tensor([1e-4, 2.0, -3.0])}
        state = {"ef": port_comp.init_error_feedback(grads)}
        cg, state = port_comp.compress_grads(grads, state)
        np.testing.assert_allclose((cg["w"] + state["ef"]["w"]).numpy(),
                                   grads["w"].numpy(), rtol=1e-6)

    def test_training_converges_with_compression(self):
        cfg = port_opt.OptimizerConfig(kind="adamw", lr=0.05,
                                       weight_decay=0.0, warmup_steps=0,
                                       total_steps=1000)
        params = {"w": torch.full((16, 16), 9.0, requires_grad=True)}
        state = init_train_state(params, cfg)
        state["ef"] = port_comp.init_error_feedback(params)
        step = make_train_step(
            lambda p, b: (torch.mean(torch.square(p["w"] - 2.0)), {}), cfg,
            compressor=port_comp.compress_grads)
        for _ in range(200):
            state, _ = step(state, torch.zeros(()))
        np.testing.assert_allclose(state["params"]["w"].detach().numpy(),
                                   2.0, atol=0.2)


# -- the data pipeline --------------------------------------------------------------

class TestPipeline:
    def test_prefetcher_orders_and_prefetches(self):
        pf = Prefetcher(lambda s: {"x": np.full(2, s)}, depth=2)
        out = [next(pf) for _ in range(5)]
        pf.close()
        assert [s for s, _ in out] == list(range(5))
        np.testing.assert_array_equal(out[3][1]["x"], 3.0)

    def test_prefetcher_error_propagates(self):
        def bad(step):
            if step == 2:
                raise ValueError("boom")
            return step

        pf = Prefetcher(bad, depth=1)
        assert next(pf)[0] == 0
        assert next(pf)[0] == 1
        with pytest.raises(ValueError):
            next(pf)
            next(pf)
        pf.close()

    def test_cached_extraction_source_equals_jax(self):
        """Two crops alternating over steps: planned once each, through
        the port's service, with the JAX service's values."""
        from repro.core import (ConvexPolytope, OrderedAxis, Request,
                                Select, TensorDatacube)
        from repro.serve.extraction import ExtractionService

        from repro_torch import carry
        from repro_torch.serve import ExtractionService as PortService

        axes = [OrderedAxis(nm, np.arange(12.0)) for nm in "abc"]
        cube = TensorDatacube(axes)
        data = np.arange(cube.n_elements, dtype=np.float64)

        def crop(shift):
            verts = np.array([[0.0, 0.0], [8.0, 0.0], [0.0, 8.0]]) + shift
            return Request([ConvexPolytope(("a", "b"), verts),
                            Select("c", [1.0, 3.0])])

        def port_crop(shift):
            verts = np.array([[0.0, 0.0], [8.0, 0.0], [0.0, 8.0]]) + shift
            return carry.request_from_spec({"shapes": [
                {"kind": "convexpolytope", "axes": ["a", "b"],
                 "vertices": verts},
                {"kind": "select", "axis": "c", "values": [1.0, 3.0]}]})

        port_cube = carry.datacube_from_spec({"kind": "tensor", "axes": [
            {"kind": "ordered", "name": nm, "values": np.arange(12.0)}
            for nm in "abc"]})
        svc = PortService(port_cube, device="cpu")
        crops = [port_crop(0.0), port_crop(2.0)]
        pf = Prefetcher(port_pipe.CachedExtractionSource(
            svc, lambda s: crops[s % 2], torch.from_numpy(data)), depth=2)
        out = [next(pf) for _ in range(6)]
        pf.close()
        assert [s for s, _ in out] == list(range(6))
        assert svc.stats.misses == 2 and svc.stats.hits >= 4
        ref = ExtractionService(cube)
        for s, got in out:
            want = ref.submit_batch([crop(2.0 * (s % 2))], data)[0]
            np.testing.assert_array_equal(got.values.numpy(), want.values)

    def test_device_put_keeps_every_array(self):
        rng = np.random.default_rng(0)
        batch = {"a": rng.normal(size=(3, 5)).astype(np.float32),
                 "b": rng.integers(0, 9, (7,)).astype(np.int32),
                 "c": np.zeros((0, 2), np.float64)}
        got = port_pipe.device_put(batch, "cpu")
        assert list(got) == list(batch)
        for k, v in batch.items():
            assert got[k].numpy().dtype == v.dtype
            assert got[k].numpy().tobytes() == v.tobytes(), k


# -- checkpoints ------------------------------------------------------------------

def _state(seed: int) -> dict:
    tree = _tree(seed)
    return {"params": {"w": tree["w"], "bias": tree["b"]},
            "opt": {"m": {"w": tree["t"][0, :4], "bias": tree["b"] * 2},
                    "step": np.int32(seed + 3)}}


class TestCheckpoint:
    def test_jax_writes_port_reads(self, tmp_path):
        want = jax.tree_util.tree_map(jnp.asarray, _state(0))
        ref_ckpt.save_checkpoint(tmp_path, 7, want)
        target = jax.tree_util.tree_map(
            lambda x: torch.zeros(np.shape(x), dtype=torch.from_numpy(
                np.asarray(x)).dtype), _state(1))
        port_ckpt.restore_checkpoint(tmp_path, 7, target)
        for key, leaf in port_ckpt.flatten_tree(_state(0)).items():
            got = port_ckpt.flatten_tree(target)[key].numpy()
            assert got.tobytes() == np.asarray(leaf).tobytes(), key

    def test_port_writes_jax_reads(self, tmp_path):
        state = jax.tree_util.tree_map(torch.tensor, _state(2))
        port_ckpt.save_checkpoint(tmp_path, 11, state)
        assert ref_ckpt.latest_step(tmp_path) == 11
        target = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
            _state(2))
        back = ref_ckpt.restore_checkpoint(tmp_path, 11, target)
        for key, leaf in port_ckpt.flatten_tree(_state(2)).items():
            got = np.asarray(port_ckpt.flatten_tree(back)[key])
            assert got.tobytes() == np.asarray(leaf).tobytes(), key

    def test_snapshot_taken_before_return(self, tmp_path):
        """An async save holds the values of the call, not later ones."""
        state = {"w": torch.arange(6.0)}
        t = port_ckpt.save_checkpoint(tmp_path, 1, state, blocking=False)
        state["w"].add_(100.0)
        t.join()
        target = {"w": torch.zeros(6)}
        port_ckpt.restore_checkpoint(tmp_path, 1, target)
        assert torch.equal(target["w"], torch.arange(6.0))

    def test_mismatch_raises_before_writing(self, tmp_path):
        port_ckpt.save_checkpoint(tmp_path, 2, {"a": torch.ones(3),
                                                "b": torch.ones(2)})
        target = {"a": torch.zeros(3), "b": torch.zeros(4)}
        with pytest.raises(ValueError, match="b"):
            port_ckpt.restore_checkpoint(tmp_path, 2, target)
        assert bool((target["a"] == 0).all())

    def test_cleanup_keeps_latest(self, tmp_path):
        for s in range(5):
            port_ckpt.save_checkpoint(tmp_path, s, {"w": torch.ones(1)})
        port_ckpt.cleanup_old(tmp_path, keep=2)
        assert sorted(p.name for p in tmp_path.glob("step_*")) == \
            ["step_000000003", "step_000000004"]
        assert port_ckpt.latest_step(tmp_path) == 4


# -- the supervisor ------------------------------------------------------------------

def _setup(tmp_path, ckpt_every=5):
    cfg = port_opt.OptimizerConfig(kind="adamw", lr=0.05, weight_decay=0.0,
                                   warmup_steps=0, total_steps=1000)

    def loss_fn(params, batch):
        return torch.mean(torch.square(params["w"] - batch)), {}

    state = init_train_state({"w": torch.full((4, 4), 3.0,
                                              requires_grad=True)}, cfg)
    step = make_train_step(loss_fn, cfg)

    def data_fn(step_idx):   # step-addressable → deterministic replay
        return torch.full((4, 4), float(step_idx % 3))

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                       max_restarts=10, async_ckpt=False)
    return fcfg, step, data_fn, state


def _fresh_copy(state):
    return jax.tree_util.tree_map(lambda t: t.detach().clone(), state)


class TestSupervisor:
    def test_no_fault_runs_to_completion(self, tmp_path):
        fcfg, step, data_fn, state = _setup(tmp_path)
        sup = Supervisor(fcfg, step, data_fn)
        out = sup.run(state, 12)
        assert port_ckpt.latest_step(tmp_path) == 9
        assert sup.restarts == 0
        assert bool(torch.isfinite(out["params"]["w"]).all())

    @pytest.mark.parametrize("fail_at", (3, 12), ids=("from_memory",
                                                     "from_checkpoint"))
    def test_crash_restore_equals_uninterrupted(self, tmp_path, fail_at):
        """A fault before the first checkpoint replays from the state in
        memory; a later one restores the last checkpoint."""
        fcfg, step, data_fn, state = _setup(tmp_path / "a")
        start = _fresh_copy(state)
        clean = Supervisor(fcfg, step, data_fn).run(state, 20)
        fcfg2 = FaultConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                            max_restarts=10, async_ckpt=True)
        crashed = {"done": False}

        def injector(s):
            if s == fail_at and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("simulated node failure")

        sup = Supervisor(fcfg2, step, data_fn, fault_injector=injector)
        out = sup.run(start, 20)
        assert sup.restarts == 1
        for key, leaf in port_ckpt.flatten_tree(clean).items():
            assert torch.equal(port_ckpt.flatten_tree(out)[key], leaf), key

    def test_exhausted_restart_budget_raises(self, tmp_path):
        fcfg, step, data_fn, state = _setup(tmp_path)
        fcfg.max_restarts = 2

        def injector(s):
            raise RuntimeError("persistent failure")

        sup = Supervisor(fcfg, step, data_fn, fault_injector=injector)
        with pytest.raises(RuntimeError):
            sup.run(state, 5)
        assert sup.restarts == 3


class TestStraggler:
    def test_detects_outlier(self):
        mon = StragglerMonitor(factor=3.0)
        for _ in range(10):
            mon.record(0.1)
        assert mon.is_straggler(1.0)
        assert not mon.is_straggler(0.15)

    def test_needs_warmup(self):
        mon = StragglerMonitor()
        assert not mon.is_straggler(100.0)   # no baseline yet

    def test_skip_and_repair_records(self):
        mon = StragglerMonitor()
        mon.skip_and_repair(17)
        assert mon.skipped_steps == [17]


# -- the launcher ------------------------------------------------------------------

RECSYS = ("dlrm-rm2", "deepfm", "two-tower-retrieval")


class TestLauncher:
    @pytest.mark.parametrize("arch_id", RECSYS)
    def test_smoke_batch_equals_jax(self, arch_id):
        want = get_arch(arch_id).smoke()["batch"]
        got = port_train.smoke(arch_id, device="cpu")["batch"]
        assert set(got) == set(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].dtype == v.dtype and got[k].tobytes() == \
                v.tobytes(), k

    @pytest.mark.parametrize("arch_id", RECSYS)
    def test_data_source_equals_jax(self, arch_id):
        arch = get_arch(arch_id)
        want_src = ref_launch.data_source_for(arch, arch.smoke(), arch_id)
        got_src = port_launch.data_source_for(
            port_train.smoke(arch_id, device="cpu"), "cpu")
        for step in (0, 1, 17):
            want, got = want_src(step), got_src(step)
            assert list(got) == list(want)
            for k, v in want.items():
                v = np.asarray(v)
                g = got[k].numpy()
                assert g.dtype == v.dtype and g.shape == v.shape
                assert g.tobytes() == v.tobytes(), (step, k)

    def test_main_trains_and_checkpoints(self, tmp_path, capsys):
        state = port_launch.main(
            ["--arch", "deepfm", "--steps", "3", "--device", "cpu",
             "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
             "--log-every", "1"])
        assert port_ckpt.latest_step(tmp_path) == 2
        assert int(state["opt"]["step"]) == 3
        out = capsys.readouterr().out
        assert "step     2" in out and "done: 3 steps" in out
        # The checkpoint holds the final state.
        target = jax.tree_util.tree_map(lambda t: torch.zeros_like(t),
                                        port_ckpt.flatten_tree(state))
        port_ckpt.restore_checkpoint(tmp_path, 2, target)
        for key, leaf in port_ckpt.flatten_tree(state).items():
            assert torch.equal(target[key], leaf.detach()), key

    @pytest.mark.parametrize("arch_id", ("glm4-9b", "nequip", "bert4rec"))
    def test_untrained_families_raise(self, tmp_path, arch_id):
        """The LM, GNN and BERT4Rec families, which the launcher once
        refused with ``NotImplementedError``, now train: nothing raises,
        and the step's checkpoint is written."""
        state = port_launch.main(["--arch", arch_id, "--device", "cpu",
                                  "--steps", "1", "--ckpt-every", "1",
                                  "--ckpt-dir", str(tmp_path)])
        assert int(state["opt"]["step"]) == 1
        assert port_ckpt.latest_step(tmp_path) == 0

    def test_default_device_is_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("this checks the refusal where there is no card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_launch.main(["--arch", "deepfm", "--steps", "1",
                              "--ckpt-dir", str(tmp_path)])

    def test_trains_with_jax_blocked(self, tmp_path):
        """One DLRM smoke train step and a checkpoint round trip in a
        process where ``jax`` cannot be imported."""
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "import torch\n"
            "from repro_torch.configs import train\n"
            "from repro_torch.dataplane.pipeline import device_put\n"
            "from repro_torch.train import checkpoint as ck\n"
            f"d = {str(tmp_path)!r}\n"
            "s = train.smoke('dlrm-rm2', device='cpu')\n"
            "state, m = s['step'](s['state'], "
            "device_put(s['batch'], 'cpu'))\n"
            "assert bool(torch.isfinite(m['loss'])) and "
            "int(state['opt']['step']) == 1\n"
            "ck.save_checkpoint(d, 0, state)\n"
            "fresh = train.smoke('dlrm-rm2', device='cpu', seed=1)['state']\n"
            "ck.restore_checkpoint(d, 0, fresh)\n"
            "a, b = ck.flatten_tree(state), ck.flatten_tree(fresh)\n"
            "assert all(torch.equal(a[k], b[k]) for k in a), 'round trip'\n"
            "bad = [m for m in sys.modules if m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code],
                             env={**os.environ,
                                  "PYTHONPATH": str(REPO / "src")},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
