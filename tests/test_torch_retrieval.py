"""The port's two-tower retrieval and BERT4Rec serving == the JAX
package's, on the CPU.

Two-tower's lookups are kernel B1 (``gather_rows``), which runs its plain
PyTorch version on the CPU: its rows are byte-equal to ``jnp.take`` for
ids in range.  BERT4Rec is the port's decoder without the causal mask and
with learned positions.  Weights are drawn by the JAX initialisers and
carried across with ``repro_torch.carry``; inputs come from numpy seeds.
The towers, the scores, the trunk and the logits agree within 1e-5
absolute: XLA orders the float32 products and sums its own way, and the
outputs are of order 1 (unit vectors, final-normed states) or smaller
(logits through a 0.02-scaled tied head).  The engine's greedy streams
equal the JAX engine's, round by round, for prompts within ``max_seq``.

Past the tables the two packages differ on purpose (ROADMAP C12): the
JAX ``jnp.take`` returns a NaN row for id N and the last row for -1, and
a NaN position poisons every position of a non-causal model; the port
raises ``IndexError`` for such ids and positions, and its engine refuses
a request longer than the position table with ``ValueError``.  Both
sides are pinned here.

Also here: ``layers.layernorm`` and ``gather_plan_rows``, B1's
extraction-plan adapter, against the JAX functions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import bert4rec as ref_bert_cfg  # noqa: E402
from repro.configs import two_tower_retrieval as ref_tt_cfg  # noqa: E402
from repro.core import (All, Box, OrderedAxis, Request,  # noqa: E402
                        Slicer, TensorDatacube)
from repro.kernels.gather import ops as ref_gather_ops  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recsys as ref_recsys  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402

from repro_torch import carry, configs  # noqa: E402
from repro_torch.configs import bert4rec as port_bert_cfg  # noqa: E402
from repro_torch.configs import \
    two_tower_retrieval as port_tt_cfg  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import recsys as port_recsys  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402

# Absolute, as stated in the module docstring.
ABS = dict(rtol=0, atol=1e-5)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.") if isinstance(
        cfg.dtype, torch.dtype) else str(np.dtype(cfg.dtype))
    return out


# -- configurations ----------------------------------------------------------

class TestConfigs:
    @pytest.mark.parametrize("which", ("_cfg", "_smoke"))
    @pytest.mark.parametrize("port_mod,ref_mod", (
        (port_tt_cfg, ref_tt_cfg), (port_bert_cfg, ref_bert_cfg)),
        ids=("two-tower-retrieval", "bert4rec"))
    def test_values_equal_jax_field_by_field(self, port_mod, ref_mod, which):
        """Every field of the port's configuration equals the JAX one's
        (BERT4Rec's JAX ``scan_unroll``, read only by XLA, has no port
        field)."""
        assert port_mod.ID == ref_mod.ID
        ours, theirs = getattr(port_mod, which)(), getattr(ref_mod, which)()
        mine, their = _fields(ours), _fields(theirs)
        assert set(their) - set(mine) <= {"scan_unroll", "remat"}
        for key, value in mine.items():
            assert value == their[key], key
        assert configs.get_config(port_mod.ID,
                                  smoke=which == "_smoke") == ours

    def test_published_sizes(self):
        tt = configs.get_config("two-tower-retrieval")
        assert (tt.n_users + tt.n_items) * tt.embed_dim * 4 == 2_048_000_000
        bert = configs.get_config("bert4rec")
        assert bert.vocab == 2 ** 20 and bert.max_seq == 200
        assert not bert.causal and bert.learned_pos


# -- two-tower ---------------------------------------------------------------

def _narrow_tt(mod):
    return dataclasses.replace(mod._smoke(), name="two-tower-narrow",
                               n_users=300, n_items=500, embed_dim=32,
                               tower=(64, 32))


TT_CASES = {"smoke": lambda mod: mod._smoke(), "narrow": _narrow_tt}


def _two_tower(case, seed=0):
    """(port model, JAX params, JAX config) from one JAX init."""
    port_cfg = TT_CASES[case](port_tt_cfg)
    ref_cfg = TT_CASES[case](ref_tt_cfg)
    jp = ref_recsys.twotower_init(jax.random.PRNGKey(seed), ref_cfg)
    return carry.twotower_from_params(port_cfg, _np_tree(jp),
                                      device="cpu"), jp, ref_cfg


@pytest.mark.parametrize("case", tuple(TT_CASES))
class TestTwoTower:
    def test_towers_and_scores_match_jax(self, case):
        model, jp, ref_cfg = _two_tower(case, seed=1)
        rng = np.random.default_rng(2)
        users = rng.integers(0, ref_cfg.n_users, 9).astype(np.int32)
        items = rng.integers(0, ref_cfg.n_items, 37).astype(np.int32)
        with torch.no_grad():
            u = model.user(torch.from_numpy(users))
            i = model.item(items)                   # numpy ids too
            s = model.score_candidates(users, torch.from_numpy(items))
        np.testing.assert_allclose(u.numpy(), np.asarray(
            ref_recsys.twotower_user(jp, ref_cfg, jnp.asarray(users))), **ABS)
        np.testing.assert_allclose(i.numpy(), np.asarray(
            ref_recsys.twotower_item(jp, ref_cfg, jnp.asarray(items))), **ABS)
        want = ref_recsys.twotower_score_candidates(
            jp, ref_cfg, jnp.asarray(users), jnp.asarray(items))
        assert s.shape == (9, 37)
        np.testing.assert_allclose(s.numpy(), np.asarray(want), **ABS)
        np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=-1), 1.0,
                                   rtol=0, atol=1e-6)

    def test_lookups_equal_jnp_take(self, case):
        """B1's plain version gives the rows ``jnp.take`` gives, byte for
        byte, with repeated ids and the table's first and last rows."""
        model, jp, ref_cfg = _two_tower(case, seed=3)
        rng = np.random.default_rng(4)
        ids = rng.integers(0, ref_cfg.n_items, 64).astype(np.int32)
        ids[:4] = (0, ref_cfg.n_items - 1, ids[5], ids[5])
        got = gops.gather_rows(model.item_embed.detach(), ids).numpy()
        want = np.asarray(jnp.take(jp["item_embed"]["table"],
                                   jnp.asarray(ids), axis=0))
        assert got.tobytes() == want.tobytes()

    def test_cpu_lookups_launch_nothing(self, case):
        model, _, _ = _two_tower(case)
        before = dict(LAUNCHES)
        with torch.no_grad():
            model.score_candidates(np.array([0, 1], np.int32),
                                   np.arange(5, dtype=np.int32))
        assert LAUNCHES == before


class TestC12IdsPastTheTable:
    @pytest.mark.parametrize("bad", ("n", "minus_one", "far"))
    @pytest.mark.parametrize("tower", ("user", "item"))
    def test_port_raises(self, tower, bad):
        model, _, cfg = _two_tower("smoke")
        n = cfg.n_users if tower == "user" else cfg.n_items
        ids = np.array([0, {"n": n, "minus_one": -1, "far": 10 * n}[bad]],
                       np.int32)
        for given in (ids, torch.from_numpy(ids)):
            with pytest.raises(IndexError):
                getattr(model, tower)(given)
        with pytest.raises(IndexError):
            model.score_candidates(ids if tower == "user" else ids[:1],
                                   ids if tower == "item" else ids[:1])

    def test_jax_take_gives_nan_for_n_and_wraps_minus_one(self):
        table = np.arange(12, dtype=np.float32).reshape(4, 3)
        rows = np.asarray(jnp.take(jnp.asarray(table),
                                   jnp.asarray([4, -1, 1]), axis=0))
        assert np.isnan(rows[0]).all()
        np.testing.assert_array_equal(rows[1], table[-1])
        np.testing.assert_array_equal(rows[2], table[1])
        _, jp, cfg = _two_tower("smoke")
        u = np.asarray(ref_recsys.twotower_user(
            jp, cfg, jnp.asarray([cfg.n_users], jnp.int32)))
        assert np.isnan(u).all()


# -- BERT4Rec ----------------------------------------------------------------

def _narrow_bert(make):
    return dataclasses.replace(make(n_items=300, seq_len=24),
                               name="bert4rec-narrow", d_model=32,
                               n_layers=3, n_heads=4, n_kv_heads=2,
                               d_head=8, d_ff=48)


BERT_CASES = {
    "smoke": lambda side: (port_bert_cfg if side == "port"
                           else ref_bert_cfg)._smoke(),
    "narrow3": lambda side: _narrow_bert(
        port_recsys.bert4rec_config if side == "port"
        else ref_recsys.bert4rec_config),
}


def _bert(case, seed=0):
    """(port params, port config, JAX params, JAX config)."""
    port_cfg, ref_cfg = BERT_CASES[case]("port"), BERT_CASES[case]("ref")
    jp = ref_recsys.bert4rec_init(jax.random.PRNGKey(seed), ref_cfg)
    return (carry.transformer_from_params(port_cfg, _np_tree(jp),
                                          device="cpu"),
            port_cfg, jp, ref_cfg)


def _items(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("case", tuple(BERT_CASES))
class TestBert4Rec:
    def test_trunk_and_score_match_jax(self, case):
        params, cfg, jp, ref_cfg = _bert(case, seed=1)
        assert params["pos_embed"]["table"].shape == (cfg.max_seq,
                                                      cfg.d_model)
        items = _items(cfg, (3, cfg.max_seq), 2)
        h, _ = port_tf.trunk(params, cfg, torch.from_numpy(items))
        jh, _ = ref_tf.trunk(jp, ref_cfg, jnp.asarray(items))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **ABS)
        short = items[:, :7]
        got = port_recsys.bert4rec_score(params, cfg, torch.from_numpy(short))
        want = ref_recsys.bert4rec_score(jp, ref_cfg, jnp.asarray(short))
        assert got.shape == (3, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ABS)

    def test_not_causal_and_positions_count(self, case):
        """A later item moves the first position's state (no causal
        mask), and so does a permutation of the items (learned
        positions)."""
        params, cfg, _, _ = _bert(case, seed=2)
        items = torch.from_numpy(_items(cfg, (1, 6), 3))
        h, _ = port_tf.trunk(params, cfg, items)
        later = items.clone()
        later[0, -1] = (later[0, -1] + 1) % cfg.vocab
        assert not torch.equal(port_tf.trunk(params, cfg, later)[0][0, 0],
                               h[0, 0])
        cfg_np = dataclasses.replace(cfg, learned_pos=False)
        params_np = {k: v for k, v in params.items() if k != "pos_embed"}
        assert not torch.allclose(port_tf.trunk(params_np, cfg_np, items)[0],
                                  h)

    def test_prefill_and_decode_step_match_jax(self, case):
        params, cfg, jp, ref_cfg = _bert(case, seed=3)
        toks = _items(cfg, (2, 5), 4)
        max_seq = cfg.max_seq
        lg, cache = port_tf.prefill(params, cfg, torch.from_numpy(toks),
                                    max_seq=max_seq)
        jlg, jcache = ref_tf.prefill(jp, ref_cfg, jnp.asarray(toks),
                                     max_seq=max_seq)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **ABS)
        pos = np.array([5, 5], np.int32)
        for _ in range(cfg.max_seq - 5):
            nxt = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
            lg, cache = port_tf.decode_step(params, cfg, cache,
                                            torch.from_numpy(nxt),
                                            torch.from_numpy(pos))
            jlg, jcache = ref_tf.decode_step(jp, ref_cfg, jcache,
                                             jnp.asarray(nxt),
                                             jnp.asarray(pos))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **ABS)
            pos = pos + 1
        for ours, theirs in zip(cache, jcache):
            for key in theirs:
                np.testing.assert_allclose(ours[key].numpy(),
                                           np.asarray(theirs[key]), **ABS)

    def test_engine_streams_equal_jax_engine(self, case):
        """Round by round: the same live set, queue, pager state and
        tokens, for prompts plus new tokens within ``max_seq``."""
        params, cfg, jp, ref_cfg = _bert(case, seed=4)
        ecfg = dict(max_batch=2, max_seq=32, page_size=4, n_pages=24)
        ours = port_engine.ServeEngine(
            params, cfg, port_engine.EngineConfig(**ecfg), device="cpu")
        theirs = ref_engine.ServeEngine(jp, ref_cfg,
                                        ref_engine.EngineConfig(**ecfg))
        rng = np.random.default_rng(5)
        for rid, n in enumerate((3, cfg.max_seq - 6, 9, 1)):
            prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
            new = min(6, cfg.max_seq - n)
            ours.submit(port_engine.Request(prompt=prompt, rid=rid,
                                            max_new_tokens=new))
            theirs.submit(ref_engine.Request(prompt=prompt, rid=rid,
                                             max_new_tokens=new))
        done_ours, done_theirs, rounds = [], [], 0
        while theirs.queue or theirs.live:
            for eng in (ours, theirs):
                eng._admit()
            assert list(ours.live) == list(theirs.live)
            assert [r.rid for r in ours.queue] == \
                [r.rid for r in theirs.queue]
            for eng in (ours, theirs):
                eng._decode_round()
            assert ours.pager.tables == theirs.pager.tables
            done_ours += ours._collect()
            done_theirs += theirs._collect()
            rounds += 1
            assert rounds < 100
        assert not (ours.queue or ours.live)
        assert [(r.rid, r.out_tokens) for r in done_ours] == \
            [(r.rid, r.out_tokens) for r in done_theirs]
        assert ours.pager.utilization == 0.0


class TestC12PositionsPastTheTable:
    def test_port_raises_for_positions_and_items(self):
        params, cfg, _, _ = _bert("smoke")
        long = torch.from_numpy(_items(cfg, (1, cfg.max_seq + 1), 0))
        with pytest.raises(IndexError, match="learned position table"):
            port_tf.trunk(params, cfg, long)
        with pytest.raises(IndexError, match="learned position table"):
            port_tf.prefill(params, cfg, long, max_seq=32)
        with pytest.raises(IndexError, match="learned position table"):
            port_tf.trunk(params, cfg, long[:, :3],
                          positions=torch.tensor([[0, 1, -1]]))
        _, cache = port_tf.prefill(params, cfg, long[:, :4], max_seq=32)
        with pytest.raises(IndexError, match="learned position table"):
            port_tf.decode_step(params, cfg, cache, torch.tensor([1]),
                                torch.tensor([cfg.max_seq]))
        k_pool, v_pool = port_tf.init_paged_cache(cfg, 8, 4, device="cpu")
        with pytest.raises(IndexError, match="learned position table"):
            port_tf.prefill_paged(params, cfg, long, k_pool, v_pool,
                                  torch.arange(5))
        with pytest.raises(IndexError, match="learned position table"):
            port_tf.decode_paged(params, cfg, k_pool, v_pool,
                                 torch.tensor([1]),
                                 torch.tensor([cfg.max_seq]),
                                 torch.zeros((1, 5), dtype=torch.int32),
                                 torch.tensor([cfg.max_seq + 1]))
        for bad in (-1, cfg.vocab):
            items = torch.tensor([[0, bad]])
            with pytest.raises(IndexError, match="item ids"):
                port_recsys.bert4rec_score(params, cfg, items)

    def test_port_engine_refuses_requests_past_the_table(self):
        params, cfg, _, _ = _bert("smoke")
        eng = port_engine.ServeEngine(params, cfg, port_engine.EngineConfig(
            max_batch=2, max_seq=64, page_size=8, n_pages=16), device="cpu")
        eng.submit(port_engine.Request(
            prompt=np.arange(cfg.max_seq - 3, dtype=np.int32),
            max_new_tokens=3))                              # fits exactly
        with pytest.raises(ValueError, match="16 learned positions"):
            eng.submit(port_engine.Request(
                prompt=np.arange(20, dtype=np.int32), max_new_tokens=3))
        with pytest.raises(ValueError, match="learned positions"):
            eng.submit(port_engine.Request(
                prompt=np.arange(cfg.max_seq - 3, dtype=np.int32),
                max_new_tokens=4))
        assert len(eng.queue) == 1
        assert len(eng.run()[0].out_tokens) == 3

    def test_jax_engine_emits_zeros_from_nan_logits(self):
        """The JAX engine on the smoke model (``max_seq`` 16) with a
        20-token prompt: positions 16-19 take NaN rows, and with no
        causal mask every position's logits are NaN; argmax gives 0."""
        _, _, jp, ref_cfg = _bert("smoke")
        prompt = _items(ref_cfg, (20,), 6)
        logits, _ = ref_tf.prefill(jp, ref_cfg, jnp.asarray(prompt[None]),
                                   max_seq=32)
        assert np.isnan(np.asarray(logits)).all()
        eng = ref_engine.ServeEngine(jp, ref_cfg, ref_engine.EngineConfig(
            max_batch=1, max_seq=32, page_size=8, n_pages=8))
        eng.submit(ref_engine.Request(prompt=prompt, max_new_tokens=3))
        assert eng.run()[0].out_tokens == [0, 0, 0]


class TestLauncher:
    def test_serves_bert4rec(self, capsys):
        run = launcher.run_lm(launcher.parse_args(
            ["--device", "cpu", "--arch", "bert4rec", "--requests", "3",
             "--max-new-tokens", "4"]))
        assert "served 3 requests / 12 tokens" in capsys.readouterr().out
        assert all(len(r.prompt) + 4 <= run.engine.cfg.max_seq
                   for r in run.done)
        assert run.engine.pager.utilization == 0.0

    def test_request_past_the_table_exits(self):
        with pytest.raises(SystemExit, match="16 learned positions of "
                                             "bert4rec-smoke"):
            launcher.main(["--device", "cpu", "--arch", "bert4rec",
                           "--requests", "1", "--max-new-tokens", "13"])

    def test_two_tower_is_not_an_lm(self):
        with pytest.raises(SystemExit, match="not an LM"):
            launcher.main(["--device", "cpu",
                           "--arch", "two-tower-retrieval"])


# -- layernorm and B1's plan adapter ------------------------------------------

class TestLayernorm:
    @pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
    def test_matches_jax(self, dtype):
        rng = np.random.default_rng(7)
        x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
        scale = rng.normal(size=(48,)).astype(np.float32)
        bias = rng.normal(size=(48,)).astype(np.float32)
        t = getattr(torch, dtype)
        got = port_layers.layernorm(
            {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
            torch.from_numpy(x).to(t))
        want = ref_layers.layernorm(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            jnp.asarray(x, jnp.dtype(dtype)))
        assert got.dtype == t
        # float32: XLA's mean and variance sum in their own order;
        # bfloat16: the output's own rounding, an ulp of |y| up to ~10.
        close = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else \
            dict(rtol=2 ** -7, atol=2 ** -7)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **close)

    def test_init_equals_jax(self):
        got = port_layers.layernorm_init(24, device=torch.device("cpu"),
                                         dtype=torch.float32)
        want = ref_layers.layernorm_init(24)
        assert set(got) == set(want) == {"scale", "bias"}
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


class TestGatherPlanRows:
    @pytest.mark.parametrize("row", (1, 6))
    def test_matches_jax_on_a_plans_rows(self, row):
        """A box over (lat, lon) with every level: each point's ``row``
        levels are one block, and the plan's offsets that start a block
        are the rows' block-aligned offsets."""
        cube = TensorDatacube([
            OrderedAxis("lat", np.linspace(-40.0, 40.0, 17)),
            OrderedAxis("lon", np.arange(0.0, 360.0, 15.0)),
            OrderedAxis("level", np.arange(float(row)))], dtype=np.float32)
        plan, _ = Slicer(cube).extract_plan(Request([
            Box(("lat", "lon"), (-12.0, 40.0), (22.0, 160.0)),
            All("level")]))
        offsets = plan.offsets[plan.offsets % row == 0]
        assert len(offsets) == plan.n_points // row > 1
        rng = np.random.default_rng(row)
        flat = rng.normal(size=cube.n_elements + 3).astype(np.float32)
        want = np.asarray(ref_gather_ops.gather_plan_rows(
            jnp.asarray(flat), jnp.asarray(offsets), row))
        for idx in (offsets, torch.from_numpy(offsets)):
            got = gops.gather_plan_rows(torch.from_numpy(flat), idx, row)
            assert got.shape == (len(offsets), row)
            assert got.numpy().tobytes() == want.tobytes()
        np.testing.assert_array_equal(
            want.reshape(-1), flat[plan.offsets])
