"""LM training on the port == the JAX package's, on the CPU.

``loss_fn`` (cross-entropy, the MoE aux loss and DeepSeek's MTP loss)
and its gradient are held against the JAX ``loss_fn`` and ``jax.grad``
on the GLM-4, DeepSeek-V3 and Arctic smoke configurations, with the
parameters drawn by the JAX ``init_params`` and carried across with
``repro_torch.carry`` (the train state's flat dict keyed by the JAX
tree's paths, each group's layers stacked: ``carry.decoder_params``).
JAX draws the tokens (``jax.random.randint``, as its smoke does) and the
test passes them across as numpy.  ``TokenCube.batch`` is byte-equal to
the JAX one over several steps and shards, with the same plan-cache
counts.  Three ``make_train_step`` steps, one with ``accum_steps=2``,
equal the JAX steps; an LM state's checkpoint is restored across the
packages byte for byte; the launcher trains two steps on the CPU.

Tolerances: a loss and each gradient within rtol = atol = 2e-5, the JAX
tests' float32 tolerance (XLA orders its sums and products its own way;
the MoE gates are rounded from a float64 softmax, ``models/moe.py``).
After three optimizer steps every state leaf within rtol = 1e-5, atol =
1e-6, and ``loss``, ``grad_norm``, ``lr`` within rtol = 1e-5, as
``tests/test_torch_recsys_train.py`` holds the recsys steps, except the
parameters under AdamW, within atol = 5e-5 (``ADAMW_PARAMS``).  The
layers' recomputation (``remat``) changes no bit.
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

from repro.configs import arctic_480b as ref_arctic  # noqa: E402
from repro.configs import deepseek_v3_671b as ref_deepseek  # noqa: E402
from repro.configs import glm4_9b as ref_glm  # noqa: E402
from repro.configs import granite_3_8b as ref_granite  # noqa: E402
from repro.configs import yi_34b as ref_yi  # noqa: E402
from repro.dataplane import tokens as ref_tokens  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_state as ref_ts  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.configs import (arctic_480b, deepseek_v3_671b,  # noqa: E402
                                 glm4_9b, granite_3_8b, yi_34b)
from repro_torch.configs import common as port_common  # noqa: E402
from repro_torch.configs import train as port_train  # noqa: E402
from repro_torch.dataplane import tokens as port_tokens  # noqa: E402
from repro_torch.dataplane.pipeline import device_put  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.train import checkpoint as port_ckpt  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402
from repro_torch.train import train_state as port_ts  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
STEPS = dict(rtol=1e-5, atol=1e-6)
# AdamW's first updates divide each gradient by its own size (√v ≈ |g|),
# so an element whose gradient is near float32 noise may move by up to
# the learning rate (1e-3) either way: 5% of it, measured ≤ 3e-5.
ADAMW_PARAMS = dict(rtol=1e-5, atol=5e-5)
METRICS = dict(rtol=1e-5, atol=0)
REPO = Path(__file__).resolve().parents[1]

ARCHS = {"glm4-9b": (glm4_9b, ref_glm),
         "granite-3-8b": (granite_3_8b, ref_granite),
         "yi-34b": (yi_34b, ref_yi),
         "deepseek-v3-671b": (deepseek_v3_671b, ref_deepseek),
         "arctic-480b": (arctic_480b, ref_arctic)}
LOSS_ARCHS = ("glm4-9b", "deepseek-v3-671b", "arctic-480b")


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



def _setup(arch: str, seed: int = 0):
    """(port cfg, JAX cfg, JAX params, the port's flat parameters holding
    them)."""
    port_mod, ref_mod = ARCHS[arch]
    pcfg, jcfg = port_mod._smoke(), ref_mod._smoke()
    params = ref_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    nested = carry.transformer_from_params(pcfg, _np_tree(params),
                                           device="cpu")
    return pcfg, jcfg, params, carry.decoder_params(nested, pcfg)


def _jax_tokens(vocab: int, shape, seed: int) -> np.ndarray:
    """Tokens drawn by JAX, as its smoke draws them."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         vocab), np.int32)


def _ref_opt_cfg(ref_mod):
    """The ``OptimizerConfig`` a JAX configuration module's ``get()``
    hands ``lm_arch``."""
    cells = [c.cell_contents for c in ref_mod.get().smoke.__closure__]
    (cfg,) = [c for c in cells if isinstance(c, ref_opt.OptimizerConfig)]
    return cfg


# -- the loss -----------------------------------------------------------------

class TestLoss:
    @pytest.mark.parametrize("arch", LOSS_ARCHS)
    def test_loss_metrics_and_every_gradient_equal_jax(self, arch):
        pcfg, jcfg, params, flat = _setup(arch, seed=1)
        toks = _jax_tokens(pcfg.vocab, (2, 17), seed=2)
        tokens, labels = toks[:, :-1], toks[:, 1:]

        def ref_loss(p):
            return ref_tf.loss_fn(p, jcfg, jnp.asarray(tokens),
                                  jnp.asarray(labels))

        (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
            ref_loss, has_aux=True))(params)
        loss_fn = port_train.loss_for("lm", flat, pcfg)
        loss, metrics, grads = port_ts.value_and_grad(
            loss_fn, flat, device_put({"tokens": tokens, "labels": labels},
                                      "cpu"))
        np.testing.assert_allclose(float(loss), float(want_loss), **F32)
        assert set(metrics) == set(want_m)
        for k, v in want_m.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), **F32,
                                       err_msg=k)
        want = _paths(want_g)
        assert set(grads) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(grads[path].numpy(), w, **F32,
                                       err_msg=path)
        if pcfg.moe is not None:
            assert float(metrics["aux"]) > 0
        if pcfg.mtp:
            assert "mtp_ce" in metrics and float(metrics["mtp_ce"]) > 0

    @pytest.mark.parametrize("labels", ("tokens", "next tokens"))
    def test_mtp_loss_equals_jax(self, labels):
        pcfg, jcfg, params, flat = _setup("deepseek-v3-671b", seed=3)
        toks = _jax_tokens(pcfg.vocab, (3, 13), seed=4)
        x = toks[:, :-1].copy()
        y = x.copy() if labels == "tokens" else toks[:, 1:].copy()
        want = float(ref_tf._mtp_loss(params, jcfg, jnp.asarray(x),
                                      jnp.asarray(y)))
        nested = carry.decoder_tree(flat, pcfg)
        with torch.no_grad():
            got = float(port_tf._mtp_loss(nested, pcfg, torch.from_numpy(x),
                                          torch.from_numpy(y)))
        np.testing.assert_allclose(got, want, **F32)

    def test_loss_with_a_mask_equals_jax(self):
        pcfg, jcfg, params, flat = _setup("glm4-9b", seed=5)
        toks = _jax_tokens(pcfg.vocab, (2, 9), seed=6)
        mask = (np.arange(8)[None, :] < np.array([[5], [8]])).astype(
            np.float32)
        want, _ = ref_tf.loss_fn(params, jcfg, jnp.asarray(toks[:, :-1]),
                                 jnp.asarray(toks[:, 1:]), jnp.asarray(mask))
        with torch.no_grad():
            got, _ = port_tf.loss_fn(carry.decoder_tree(flat, pcfg), pcfg,
                                     torch.from_numpy(toks[:, :-1]),
                                     torch.from_numpy(toks[:, 1:]),
                                     torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), **F32)

    @pytest.mark.parametrize("arch", ("glm4-9b", "deepseek-v3-671b"))
    def test_recomputation_changes_no_bit(self, arch, monkeypatch):
        pcfg, _, _, flat = _setup(arch, seed=7)
        toks = _jax_tokens(pcfg.vocab, (2, 9), seed=8)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]),
                 "labels": torch.from_numpy(toks[:, 1:])}
        calls = []
        real = port_tf.checkpoint

        def counting(fn, *a, **kw):
            calls.append(fn)
            return real(fn, *a, **kw)

        monkeypatch.setattr(port_tf, "checkpoint", counting)
        got = port_ts.value_and_grad(port_train.loss_for("lm", flat, pcfg),
                                     flat, batch)
        assert len(calls) == pcfg.n_layers
        off = dataclasses.replace(pcfg, remat=False)
        want = port_ts.value_and_grad(port_train.loss_for("lm", flat, off),
                                      flat, batch)
        assert len(calls) == pcfg.n_layers
        assert torch.equal(got[0], want[0])
        for k in want[2]:
            assert torch.equal(got[2][k], want[2][k]), k

    def test_no_recomputation_without_a_gradient(self, monkeypatch):
        pcfg, _, _, flat = _setup("glm4-9b")
        monkeypatch.setattr(port_tf, "checkpoint", None)
        with torch.no_grad():
            port_tf.forward(carry.decoder_tree(flat, pcfg), pcfg,
                            torch.zeros((1, 4), dtype=torch.int64))


class TestStackedParameters:
    @pytest.mark.parametrize("arch", tuple(ARCHS))
    def test_flat_params_are_the_jax_paths_and_views(self, arch):
        pcfg, _, params, flat = _setup(arch)
        want = _paths(params)
        assert set(flat) == set(want)
        for path, w in want.items():
            assert flat[path].numpy().tobytes() == w.tobytes(), path
        nested = carry.decoder_tree(flat, pcfg)
        assert len(nested["layers"]) == pcfg.n_layers
        wq = "wq_a" if pcfg.attn_type == "mla" else "wq"
        last = nested["layers"][-1]["attn"][wq]
        assert last.untyped_storage().data_ptr() == \
            flat[f"groups/{len(pcfg.layer_groups()) - 1}/attn/{wq}"
                 ].untyped_storage().data_ptr()
        back = carry.decoder_params(nested, pcfg)
        assert set(back) == set(flat)
        assert all(torch.equal(back[k], v) for k, v in flat.items())


# -- the token pipeline -------------------------------------------------------

class TestTokenCube:
    def test_batches_equal_jax_over_steps_and_shards(self):
        ref = ref_tokens.TokenCube(vocab=97, n_docs=12, doc_len=64)
        port = port_tokens.TokenCube(vocab=97, n_docs=12, doc_len=64,
                                     device="cpu")
        np.testing.assert_array_equal(port.materialize(), ref.materialize())
        for step in (0, 1, 5, 1, 0):
            for shard, n_shards in ((0, 1), (0, 2), (1, 2)):
                want = ref.batch(step, 6, 16, shard, n_shards)
                got = port.batch(step, 6, 16, shard, n_shards)
                for k in ("tokens", "labels"):
                    assert got[k].dtype == want[k].dtype == np.int32
                    assert got[k].tobytes() == want[k].tobytes(), (step, k)
        want, got = ref.service.stats, port.service.stats
        for field in ("hits", "misses", "batch_dedup", "bytes_requested",
                      "bytes_read"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.hits > 0

    def test_windows_are_the_batch_rows(self):
        port = port_tokens.TokenCube(vocab=50, n_docs=5, doc_len=40,
                                     device="cpu")
        flat = port.materialize()
        docs, starts = port.windows(3, 4, 10)
        bt = port.batch(3, 4, 10)
        for r, (d, s0) in enumerate(zip(docs, starts)):
            row = flat[d * 40 + s0: d * 40 + s0 + 11]
            np.testing.assert_array_equal(bt["tokens"][r], row[:-1])
            np.testing.assert_array_equal(bt["labels"][r], row[1:])

    def test_empty_shard(self):
        port = port_tokens.TokenCube(vocab=20, n_docs=3, doc_len=30,
                                     device="cpu")
        bt = port.batch(0, 1, 8, shard=0, n_shards=2)
        assert bt["tokens"].shape == (0, 8)

    def test_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            port_tokens.TokenCube(vocab=20, n_docs=3, doc_len=30)


# -- train steps, set-up and launcher -----------------------------------------

class TestTrainSteps:
    @pytest.mark.parametrize("arch, kind, accum", (
        ("glm4-9b", "adamw", 1), ("glm4-9b", "adamw", 2),
        ("deepseek-v3-671b", "adafactor", 1),
        ("arctic-480b", "adafactor", 2)))
    def test_three_steps_equal_jax(self, arch, kind, accum):
        fields = dict(kind=kind, lr=1e-3, warmup_steps=2, total_steps=10)
        ref_oc = ref_opt.OptimizerConfig(**fields)
        port_oc = port_opt.OptimizerConfig(**fields)
        pcfg, jcfg, params, flat = _setup(arch, seed=9)
        state = ref_ts.init_train_state(params, ref_oc)
        ref_step = jax.jit(ref_ts.make_train_step(
            lambda p, b: ref_tf.loss_fn(p, jcfg, b["tokens"], b["labels"]),
            ref_oc, accum_steps=accum))
        pstate = carry.train_state_from_tree(flat, _np_tree(state))
        port_step = port_ts.make_train_step(
            port_train.loss_for("lm", flat, pcfg), port_oc,
            accum_steps=accum)
        for i in range(3):
            toks = _jax_tokens(pcfg.vocab, (4, 13), seed=10 + i)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            state, want = ref_step(state, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            pstate, got = port_step(pstate, device_put(batch, "cpu"))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           **METRICS, err_msg=f"{i} {k}")
        got, want = _paths(carry.train_state_to_tree(pstate)), _paths(state)
        assert set(got) == set(want)
        for key, w in want.items():
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            else:
                tol = ADAMW_PARAMS if kind == "adamw" and \
                    key.startswith("params/") else STEPS
                np.testing.assert_allclose(got[key], w, **tol, err_msg=key)
        for path, p in flat.items():
            assert p is pstate["params"][path]

    @pytest.mark.parametrize("arch", tuple(ARCHS))
    def test_optimizer_is_the_jax_configurations(self, arch):
        port_mod, ref_mod = ARCHS[arch]
        assert dataclasses.asdict(port_mod._opt()) == dataclasses.asdict(
            _ref_opt_cfg(ref_mod))

    def test_smoke_set_up(self):
        smoke = port_train.smoke("deepseek-v3-671b", device="cpu")
        assert smoke["kind"] == "lm" and smoke["family"] == "lm"
        assert smoke["batch"]["tokens"].shape == port_train.LM_SMOKE_TOKENS
        assert smoke["model"] is smoke["state"]["params"]
        assert smoke["opt"].kind == "adafactor"
        _, metrics = smoke["step"](smoke["state"],
                                   device_put(smoke["batch"], "cpu"))
        # The smoke schedule: warmup 2, so the first step's rate is half.
        np.testing.assert_allclose(float(metrics["lr"]),
                                   smoke["opt"].lr / 2, rtol=1e-6)
        assert {"ce", "aux", "mtp_ce"} <= set(metrics)
        assert port_common.LM_ACCUM == 8

    def test_data_source_is_a_token_cube(self):
        smoke = port_train.smoke("glm4-9b", device="cpu")
        source = port_launch.data_source_for(smoke, torch.device("cpu"))
        ref = ref_tokens.TokenCube(vocab=smoke["cfg"].vocab, n_docs=32,
                                   doc_len=512)
        for step in (0, 2):
            want = ref.batch(step, *port_train.LM_SMOKE_TOKENS)
            got = source(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k].numpy(), want[k])

    @pytest.mark.parametrize("arch", ("glm4-9b",))
    def test_launcher_two_steps(self, arch, tmp_path):
        """``python -m repro_torch.launch.train --arch glm4-9b --device
        cpu --steps 2`` exits 0."""
        out = _launch(["--arch", arch, "--device", "cpu", "--steps", "2",
                       "--log-every", "1", "--ckpt-dir", str(tmp_path)])
        assert out.returncode == 0, out.stderr
        assert "done: 2 steps" in out.stdout


class TestCheckpointsAcrossPackages:
    @pytest.mark.parametrize("arch, kind", (("glm4-9b", "adamw"),
                                            ("deepseek-v3-671b",
                                             "adafactor")))
    def test_each_package_restores_the_others(self, tmp_path, arch, kind):
        pcfg, jcfg, params, _ = _setup(arch, seed=13)
        oc = ref_opt.OptimizerConfig(kind=kind)
        rng = np.random.default_rng(14)
        state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=np.shape(x)), x.dtype)
            if x.dtype.kind == "f" else x + 5,
            ref_ts.init_train_state(params, oc))
        ref_ckpt.save_checkpoint(tmp_path / "jax", 4, state)
        _, _, _, fresh = _setup(arch, seed=15)
        pstate = port_ts.init_train_state(
            fresh, port_opt.OptimizerConfig(kind=kind))
        port_ckpt.restore_checkpoint(tmp_path / "jax", 4, pstate)
        got = _paths(carry.train_state_to_tree(pstate))
        for key, want in _paths(state).items():
            assert got[key].tobytes() == want.tobytes(), key
        # The state round-trips through the carry as well.
        again = carry.train_state_from_tree(fresh, _np_tree(state))
        assert all(torch.equal(again["params"][k], v)
                   for k, v in pstate["params"].items())
        port_ckpt.save_checkpoint(tmp_path / "port", 6, pstate)
        target = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
        back = ref_ckpt.restore_checkpoint(tmp_path / "port", 6, target)
        for key, want in _paths(state).items():
            assert _paths(back)[key].tobytes() == want.tobytes(), key
