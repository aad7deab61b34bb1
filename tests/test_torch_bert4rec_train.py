"""BERT4Rec training on the port == the JAX package's, on the CPU.

``cross_entropy_tied_chunked`` (an autograd Function: the online
logsumexp over vocabulary chunks, and a backward that recomputes each
chunk's logits) is held against the JAX function and its ``jax.grad``
at a V that is not a multiple of the chunk, with and without weights;
the tensors it saves for the backward do not grow with the number of
chunks.  ``bert4rec_loss`` (the top ``MAX_MASKED`` masked positions, the
chunked CE at chunk 4096) and its gradient are held against the JAX
``bert4rec_loss``, with the parameters drawn by the JAX
``bert4rec_init`` and carried across; three ``make_train_step`` steps
equal the JAX steps; the launcher trains two steps on the CPU.

Tolerances: the loss, ``dh``, ``dtable`` and every parameter gradient
within rtol = atol = 2e-5, the JAX tests' float32 tolerance; after three
AdamW steps the moments within rtol = 1e-5, atol = 1e-6 and the
parameters within atol = 5e-5 (AdamW's first updates divide each
gradient by its own size: ``tests/test_torch_lm_train.py``'s
``ADAMW_PARAMS``), the metrics within rtol = 1e-5.
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

from repro.configs import bert4rec as ref_bert_cfg  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recsys as ref_recsys  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_state as ref_ts  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.configs import bert4rec as port_bert_cfg  # noqa: E402
from repro_torch.configs import train as port_train  # noqa: E402
from repro_torch.dataplane.pipeline import device_put  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import recsys as port_recsys  # noqa: E402
from repro_torch.train import optimizer as port_opt  # noqa: E402
from repro_torch.train import train_state as port_ts  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
STEPS = dict(rtol=1e-5, atol=1e-6)
ADAMW_PARAMS = dict(rtol=1e-5, atol=5e-5)
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



def _ce_case(seed: int, rows=(3, 5), v=37, d=8):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(*rows, d)).astype(np.float32)
    table = (rng.normal(size=(v, d)) * 0.5).astype(np.float32)
    labels = rng.integers(0, v, rows).astype(np.int32)
    weights = (rng.random(rows) < 0.7).astype(np.float32)
    return h, table, labels, weights


# -- the chunked tied cross-entropy -------------------------------------------

class TestChunkedCrossEntropy:
    @pytest.mark.parametrize("chunk", (8, 10, 37, 64))
    @pytest.mark.parametrize("weighted", (False, True))
    def test_value_dh_and_dtable_equal_jax(self, chunk, weighted):
        h, table, labels, weights = _ce_case(0)
        w = weights if weighted else None

        def ref(hh, tt):
            return ref_layers.cross_entropy_tied_chunked(
                hh, tt, jnp.asarray(labels),
                None if w is None else jnp.asarray(w), chunk=chunk)

        want, (want_dh, want_dt) = jax.value_and_grad(ref, (0, 1))(
            jnp.asarray(h), jnp.asarray(table))
        th = torch.tensor(h, requires_grad=True)
        tt = torch.tensor(table, requires_grad=True)
        got = port_layers.cross_entropy_tied_chunked(
            th, tt, torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w), chunk=chunk)
        dh, dt = torch.autograd.grad(got, (th, tt))
        np.testing.assert_allclose(float(got.detach()), float(want), **F32)
        np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), **F32)
        np.testing.assert_allclose(dt.numpy(), np.asarray(want_dt), **F32)

    def test_gradcheck_float64(self):
        h, table, labels, weights = _ce_case(1, rows=(4,), v=23, d=5)
        th = torch.tensor(h, dtype=torch.float64, requires_grad=True)
        tt = torch.tensor(table, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda a, b: port_layers.cross_entropy_tied_chunked(
                a, b, torch.from_numpy(labels),
                torch.from_numpy(weights).double(), chunk=7), (th, tt))

    def test_saved_tensors_do_not_grow_with_the_chunks(self):
        """The tensors the graph keeps for the backward: the same bytes
        at 1, 5 and 37 chunks, and less than one (rows, chunk) tile of
        logits more than ``h``, the table, the labels and one float32 a
        row."""
        h, table, labels, weights = _ce_case(2, rows=(6, 7), v=37, d=8)
        rows = 6 * 7
        saved = {}
        for chunk in (37, 8, 1):
            sizes = []

            def pack(t, sizes=sizes):
                sizes.append(t.numel() * t.element_size())
                return t

            th = torch.tensor(h, requires_grad=True)
            tt = torch.tensor(table, requires_grad=True)
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss = port_layers.cross_entropy_tied_chunked(
                    th, tt, torch.from_numpy(labels),
                    torch.from_numpy(weights), chunk=chunk)
            loss.backward()
            saved[chunk] = sum(sizes)
        assert saved[1] == saved[8] == saved[37]
        floor = h.nbytes + table.nbytes + labels.nbytes + rows * 4
        assert saved[37] < floor + rows * 37 * 4

    def test_padded_columns_are_minus_inf(self):
        """A last chunk of one real column: its padding must not enter
        the logsumexp (a 0 logit there would raise the loss)."""
        h, table, labels, _ = _ce_case(3, rows=(4,), v=9, d=3)
        got = port_layers.cross_entropy_tied_chunked(
            torch.from_numpy(h), torch.from_numpy(table),
            torch.from_numpy(labels), chunk=8)
        want = torch.nn.functional.cross_entropy(
            torch.from_numpy(h) @ torch.from_numpy(table).T,
            torch.from_numpy(labels).long())
        np.testing.assert_allclose(float(got), float(want), **F32)


# -- the loss and the train step ----------------------------------------------

def _setup(seed: int = 0):
    pcfg, jcfg = port_bert_cfg._smoke(), ref_bert_cfg._smoke()
    params = ref_recsys.bert4rec_init(jax.random.PRNGKey(seed), jcfg)
    nested = carry.transformer_from_params(pcfg, _np_tree(params),
                                           device="cpu")
    return pcfg, jcfg, params, carry.decoder_params(nested, pcfg)


def _batch(cfg, seed: int, rows: int = 4) -> dict:
    """Items, labels (the items, a few replaced) and a cloze mask with a
    different count of masked positions per row (none in one row)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, cfg.vocab - 2, (rows, cfg.max_seq)).astype(
        np.int32)
    labels = items.copy()
    labels[:, ::5] = rng.integers(0, cfg.vocab - 2, labels[:, ::5].shape)
    mask = (rng.random((rows, cfg.max_seq)) < 0.3).astype(np.float32)
    mask[0] = 0.0
    return {"items": items, "labels": labels, "mask": mask}


class TestBert4RecLoss:
    @pytest.mark.parametrize("seed", (0, 1))
    def test_loss_and_every_gradient_equal_jax(self, seed):
        pcfg, jcfg, params, flat = _setup(seed)
        batch = _batch(pcfg, seed + 10)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want, want_g = jax.value_and_grad(
            lambda p: ref_recsys.bert4rec_loss(p, jcfg, jb))(params)
        loss, _, grads = port_ts.value_and_grad(
            port_train.loss_for("bert4rec", flat, pcfg), flat,
            device_put(batch, "cpu"))
        np.testing.assert_allclose(float(loss), float(want), **F32)
        want = _paths(want_g)
        assert set(grads) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(grads[path].numpy(), w, **F32,
                                       err_msg=path)

    def test_only_the_masked_positions_reach_the_head(self, monkeypatch):
        """The CE sees at most ``MAX_MASKED`` positions a row, the masked
        ones first in position order."""
        pcfg, _, _, flat = _setup()
        batch = device_put(_batch(pcfg, 3), "cpu")
        seen = {}
        real = port_recsys.cross_entropy_tied_chunked

        def spy(h, table, labels, weights, chunk):
            seen.update(h=h, labels=labels, weights=weights, chunk=chunk)
            return real(h, table, labels, weights, chunk=chunk)

        monkeypatch.setattr(port_recsys, "cross_entropy_tied_chunked", spy)
        with torch.no_grad():
            port_recsys.bert4rec_loss(carry.decoder_tree(flat, pcfg), pcfg,
                                      batch)
        k = min(port_recsys.MAX_MASKED, pcfg.max_seq)
        assert seen["h"].shape == (4, k, pcfg.d_model)
        assert seen["chunk"] == 4096
        for r in range(4):
            pos = np.flatnonzero(batch["mask"][r].numpy())[:k]
            np.testing.assert_array_equal(
                seen["labels"][r, :len(pos)].numpy(),
                batch["labels"][r].numpy()[pos])
            assert float(seen["weights"][r].sum()) == len(pos)


class TestTrainSteps:
    def test_three_steps_equal_jax(self):
        fields = dict(kind="adamw", lr=1e-3, warmup_steps=2, total_steps=10)
        ref_oc = ref_opt.OptimizerConfig(**fields)
        port_oc = port_opt.OptimizerConfig(**fields)
        pcfg, jcfg, params, flat = _setup(4)
        state = ref_ts.init_train_state(params, ref_oc)
        ref_step = jax.jit(ref_ts.make_train_step(
            lambda p, b: (ref_recsys.bert4rec_loss(p, jcfg, b), {}), ref_oc))
        pstate = carry.train_state_from_tree(flat, _np_tree(state))
        port_step = port_ts.make_train_step(
            port_train.loss_for("bert4rec", flat, pcfg), port_oc)
        for i in range(3):
            batch = _batch(pcfg, 20 + i)
            state, want = ref_step(state, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
            pstate, got = port_step(pstate, device_put(batch, "cpu"))
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]),
                                           **METRICS, err_msg=f"{i} {k}")
        got, want = _paths(carry.train_state_to_tree(pstate)), _paths(state)
        assert set(got) == set(want)
        for key, w in want.items():
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(got[key], w, err_msg=key)
            else:
                tol = ADAMW_PARAMS if key.startswith("params/") else STEPS
                np.testing.assert_allclose(got[key], w, **tol, err_msg=key)

    def test_smoke_set_up_is_the_jax_smoke(self):
        ref = ref_bert_cfg.get().smoke()
        port = port_train.smoke("bert4rec", device="cpu")
        for k, v in ref["batch"].items():
            np.testing.assert_array_equal(port["batch"][k], np.asarray(v),
                                          err_msg=k)
        assert port["kind"] == "bert4rec" and port["family"] == "recsys"
        assert dataclasses.asdict(port_bert_cfg._opt()) == \
            dataclasses.asdict(ref_opt.OptimizerConfig(
                kind="adamw", lr=1e-3, warmup_steps=100,
                total_steps=300_000))
        _, metrics = port["step"](port["state"],
                                  device_put(port["batch"], "cpu"))
        assert np.isfinite(float(metrics["loss"]))

    def test_launcher_two_steps(self, tmp_path):
        """``python -m repro_torch.launch.train --arch bert4rec --device
        cpu --steps 2`` exits 0."""
        out = _launch(["--arch", "bert4rec", "--device", "cpu", "--steps",
                       "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)])
        assert out.returncode == 0, out.stderr
        assert "done: 2 steps" in out.stdout
