"""The port's MoE and MLA layers == the JAX package's, on the CPU.

Each case runs the JAX function and the port's on the same seeded numpy
inputs, with the JAX parameters carried across as they are, within
rtol = atol = 2e-5 (XLA orders the float32 products and sums its own
way; the MoE combine sums each token's slots in choice order, XLA's
scatter-add in its own) unless stated.

Routing (``moe.route``) is held against the jnp expressions of
``src/repro/models/moe.py:97-111`` on the same logits: expert ids,
positions in the expert buffers, kept slots and capacity equal, on
random logits and on logits with planted ties (``jax.lax.top_k`` puts
the lower expert first; so must the port).  The gates agree within
2^-20 relative (a few float32 ulps): the port takes the softmax in
float64 and rounds once, so that the card and the CPU give the same
bytes, where XLA rounds each float32 ``exp`` its own way (about 1 value
in 11 differs in the last bit) and its float32 sum over up to 256
experts (3.3e-7 relative at most here).

The decoders of DeepSeek-V3 and Arctic (their smoke configurations) are
held against the JAX package, and served in lockstep with the JAX
engine, by ``tests/test_torch_lm.py``'s cases over ``ARCHS``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import arctic_480b as ref_arctic  # noqa: E402
from repro.configs import deepseek_v3_671b as ref_deepseek  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402

from repro_torch import carry  # noqa: E402
from repro_torch.configs import arctic_480b, deepseek_v3_671b  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
GATES = dict(rtol=2.0 ** -20, atol=0)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# -- routing -----------------------------------------------------------------

def _jax_route(logits, cfg, dropless):
    """``_moe_group``'s routing, lines 97-111, on one group's logits."""
    t = logits.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)
    capacity = t if dropless else max(1, int(cfg.capacity_factor * t * k
                                             / e))
    onehot = jax.nn.one_hot(expert_ids, e, dtype=jnp.int32)
    flat = onehot.reshape(t * k, e)
    pos_in_expert = (jnp.cumsum(flat, axis=0) - 1)
    pos = jnp.sum(pos_in_expert * flat, axis=-1)
    keep = pos < capacity
    return gate_vals, expert_ids, pos, keep, capacity


def _logits(kind, t, e, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(t, e)) * 2).astype(np.float32)
    if kind == "ties":
        # The top value repeated at random experts, whole rows equal, and
        # pairs of equal values everywhere.
        for i in range(t):
            x[i, rng.choice(e, 3, replace=False)] = x[i].max()
        x[::5] = 0.5
        x[1::3, 1::2] = x[1::3, 0:e - e % 2:2][:, :x[1::3, 1::2].shape[1]]
    elif kind == "integers":
        x = rng.integers(-2, 3, (t, e)).astype(np.float32)
    return x


ROUTE_CASES = [(8, 2, 16, 2.0), (8, 2, 13, 1.0), (128, 2, 64, 1.25),
               (256, 8, 40, 1.25)]


@pytest.mark.parametrize("kind", ("normal", "ties", "integers"))
@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=[f"E{c[0]}k{c[1]}t{c[2]}" for c in ROUTE_CASES])
@pytest.mark.parametrize("dropless", (False, True))
def test_route_matches_jax(kind, case, dropless):
    e, k, t, cf = case
    cfg = port_moe.MoEConfig(d_model=4, d_ff=4, n_experts=e, top_k=k,
                             capacity_factor=cf)
    logits = _logits(kind, t, e, seed=e + t)
    got = port_moe.route(torch.from_numpy(logits), cfg, dropless)
    gates, ids, pos, keep, cap = _jax_route(jnp.asarray(logits), cfg,
                                            dropless)
    assert got.capacity == cap
    np.testing.assert_array_equal(got.expert_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(keep))
    np.testing.assert_allclose(got.gates.numpy(), np.asarray(gates), **GATES)
    assert got.gates.dtype == torch.float32
    if not dropless and cf <= 1.25:
        assert not bool(got.keep.all())          # the capacity drops


def test_route_breaks_ties_by_the_lower_expert():
    cfg = port_moe.MoEConfig(d_model=4, d_ff=4, n_experts=6, top_k=3)
    logits = torch.tensor([[0.0, 1.0, 1.0, 0.0, 1.0, 1.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 3.0]])
    r = port_moe.route(logits, cfg, dropless=True)
    assert r.expert_ids.tolist() == [[1, 2, 4], [0, 1, 2], [5, 0, 1]]
    assert r.gates[1].tolist() == [pytest.approx(1 / 3)] * 3


def test_route_groups_are_independent():
    """Leading axes are groups: each routes as it would alone."""
    cfg = port_moe.MoEConfig(d_model=4, d_ff=4, n_experts=8, top_k=2,
                             capacity_factor=1.0)
    logits = torch.from_numpy(np.stack([_logits("normal", 12, 8, s)
                                        for s in range(3)]))
    both = port_moe.route(logits, cfg, dropless=False)
    for gi in range(3):
        one = port_moe.route(logits[gi], cfg, dropless=False)
        for a, b in zip(both[:5], one[:5]):
            assert torch.equal(a[gi], b)


# -- moe_ffn -------------------------------------------------------------------

def _moe_case(n_shared, n_groups, cf, seed, e=8, k=2):
    ref_cfg = ref_moe.MoEConfig(d_model=16, d_ff=24, n_experts=e, top_k=k,
                                n_shared=n_shared, capacity_factor=cf,
                                n_groups=n_groups)
    port_cfg = port_moe.MoEConfig(**dataclasses.asdict(ref_cfg))
    jp = ref_moe.moe_init(jax.random.PRNGKey(seed), ref_cfg)
    return port_cfg, ref_cfg, jp


@pytest.mark.parametrize("n_shared", (0, 1))
@pytest.mark.parametrize("n_groups,shape", [(1, (2, 12)), (2, (2, 12)),
                                            (4, (2, 12)), (4, (1, 6))],
                         ids=("g1", "g2", "g4", "g4_falls_back_to_1"))
@pytest.mark.parametrize("dropless", (False, True))
def test_moe_ffn_matches_jax(n_shared, n_groups, shape, dropless):
    port_cfg, ref_cfg, jp = _moe_case(n_shared, n_groups, 1.0,
                                      seed=n_groups + n_shared)
    x = np.random.default_rng(n_groups).normal(
        size=(*shape, 16)).astype(np.float32)
    got, aux = port_moe.moe_ffn(_torch_tree(jp), port_cfg,
                                torch.from_numpy(x), dropless=dropless)
    want, jaux = ref_moe.moe_ffn(jp, ref_cfg, jnp.asarray(x),
                                 dropless=dropless)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)
    t = shape[0] * shape[1]
    g = n_groups if t % n_groups == 0 else 1
    logits = port_moe.router_logits(
        _torch_tree(jp), torch.from_numpy(x).reshape(g, t // g, 16))
    r = port_moe.route(logits, port_cfg, dropless)
    assert bool(r.keep.all()) == dropless     # the capacity cases drop


def test_moe_ffn_deepseek_width_routing():
    """256 experts, top 8, a shared expert, 32 groups of 4 tokens and a
    capacity of 1: most slots dropped, and the same function."""
    port_cfg, ref_cfg, jp = _moe_case(1, 32, 1.25, seed=7, e=256, k=8)
    x = np.random.default_rng(3).normal(size=(4, 32, 16)).astype(np.float32)
    got, aux = port_moe.moe_ffn(_torch_tree(jp), port_cfg,
                                torch.from_numpy(x))
    want, jaux = ref_moe.moe_ffn(jp, ref_cfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(jaux), **F32)


# -- MLA -----------------------------------------------------------------------

def _mla_cfgs(q_lora_rank):
    kw = dict(d_model=32, n_heads=4, n_kv_heads=4, d_head=16,
              rope_theta=10_000.0, q_lora_rank=q_lora_rank,
              kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8, v_head_dim=12)
    return port_attn.AttnConfig(**kw), ref_attn.AttnConfig(**kw)


def _mla_params(ref_cfg, seed):
    return ref_attn.mla_init(jax.random.PRNGKey(seed), ref_cfg)


@pytest.mark.parametrize("q_lora_rank", (None, 24))
@pytest.mark.parametrize("q_chunk", (None, 4))
def test_mla_forward_matches_jax(q_lora_rank, q_chunk):
    port_cfg, ref_cfg = _mla_cfgs(q_lora_rank)
    assert port_cfg.is_mla and ref_cfg.is_mla
    jp = _mla_params(ref_cfg, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    got, cache = port_attn.mla_forward(
        _torch_tree(jp), port_cfg, torch.from_numpy(x), torch.from_numpy(pos),
        q_chunk=q_chunk, return_cache=True)
    want, jcache = ref_attn.mla_forward(jp, ref_cfg, jnp.asarray(x),
                                        jnp.asarray(pos), q_chunk=q_chunk,
                                        return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **F32)


@pytest.mark.parametrize("q_lora_rank", (None, 24))
def test_mla_decode_matches_jax(q_lora_rank):
    port_cfg, ref_cfg = _mla_cfgs(q_lora_rank)
    jp = _mla_params(ref_cfg, seed=3)
    params = _torch_tree(jp)
    rng = np.random.default_rng(4)
    s_max = 10
    cache = {"c_kv": rng.normal(size=(3, s_max, 16)).astype(np.float32),
             "k_rope": rng.normal(size=(3, s_max, 8)).astype(np.float32)}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    pos = np.array([0, 4, 7], np.int32)
    for _ in range(3):
        x = rng.normal(size=(3, 1, 32)).astype(np.float32)
        got, cache = port_attn.mla_decode(params, port_cfg,
                                          torch.from_numpy(x), cache,
                                          torch.from_numpy(pos))
        want, jcache = ref_attn.mla_decode(jp, ref_cfg, jnp.asarray(x),
                                           jcache, jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(jcache[key]), **F32)
        pos = pos + 1


@pytest.mark.parametrize("q_lora_rank", (None, 24))
def test_mla_paged_decode_equals_dense_decode(q_lora_rank):
    """The paged decode over shuffled pages (pages outside the plan and
    slots past each length poisoned with NaN) against the dense decode,
    sequence by sequence."""
    port_cfg, ref_cfg = _mla_cfgs(q_lora_rank)
    params = _torch_tree(_mla_params(ref_cfg, seed=5))
    rng = np.random.default_rng(6)
    ps, n_pages, lens = 4, 20, [3, 8, 13]
    pager = PagedKVCache(n_pages=n_pages, page_size=ps, max_pages_per_seq=5)
    c_pool = torch.full((n_pages, ps, 16), float("nan"))
    r_pool = torch.full((n_pages, ps, 8), float("nan"))
    dense = []
    for rid, n in enumerate(lens):
        pages = torch.tensor(pager.allocate(rid, n))
        x = torch.from_numpy(rng.normal(size=(1, n, 32)).astype(np.float32))
        _, kv = port_attn.mla_forward(params, port_cfg, x,
                                      torch.arange(n)[None],
                                      return_cache=True)
        t = torch.arange(n)
        c_pool[pages[t // ps], t % ps] = kv["c_kv"][0]
        r_pool[pages[t // ps], t % ps] = kv["k_rope"][0]
        cache = {"c_kv": torch.zeros(1, 20, 16), "k_rope": torch.zeros(1, 20, 8)}
        cache["c_kv"][0, :n] = kv["c_kv"][0]
        cache["k_rope"][0, :n] = kv["k_rope"][0]
        dense.append(cache)
        pager.extend(rid)
    for _ in range(4):
        table, seq_lens = pager.plan([0, 1, 2])
        pos = torch.from_numpy(seq_lens - 1)
        x = torch.from_numpy(rng.normal(size=(3, 1, 32)).astype(np.float32))
        got = port_attn.mla_decode_paged(
            params, port_cfg, x, c_pool, r_pool, pos,
            torch.from_numpy(table), torch.from_numpy(seq_lens))
        assert bool(torch.isfinite(got).all())
        for i in range(3):
            want, dense[i] = port_attn.mla_decode(
                params, port_cfg, x[i:i + 1], dense[i], pos[i:i + 1])
            np.testing.assert_allclose(got[i:i + 1].numpy(), want.numpy(),
                                       **F32)
        for rid in range(3):
            pager.extend(rid)


# -- the carry -----------------------------------------------------------------

SMOKE = {"deepseek-v3-671b": (deepseek_v3_671b, ref_deepseek),
         "arctic-480b": (arctic_480b, ref_arctic)}


def _jax_tree(ref_cfg, seed=0):
    return jax.tree.map(np.asarray, ref_tf.init_params(
        jax.random.PRNGKey(seed), ref_cfg))


class TestCarry:
    def test_groups_unstack_in_execution_order(self):
        port_cfg = deepseek_v3_671b._smoke()
        tree = _jax_tree(ref_deepseek._smoke())
        assert len(tree["groups"]) == len(port_cfg.layer_groups()) == 2
        params = carry.transformer_from_params(port_cfg, tree, device="cpu")
        assert len(params["layers"]) == port_cfg.n_layers
        assert port_cfg.layer_uses_moe() == [False, True, True, True]
        np.testing.assert_array_equal(
            params["layers"][0]["ffn"]["w_up"].numpy(),
            tree["groups"][0]["ffn"]["w_up"][0])
        for j in range(3):
            np.testing.assert_array_equal(
                params["layers"][1 + j]["moe"]["w_down"].numpy(),
                tree["groups"][1]["moe"]["w_down"][j])
        np.testing.assert_array_equal(
            params["mtp"]["layer"]["attn"]["wkv_a"].numpy(),
            tree["mtp"]["layer"]["attn"]["wkv_a"])
        assert port_tf.count_params(params) == sum(
            a.size for a in jax.tree.leaves(tree))

    @pytest.mark.parametrize("arch", tuple(SMOKE))
    def test_router_stays_float32_under_bf16(self, arch):
        port_mod, ref_mod = SMOKE[arch]
        port_cfg = dataclasses.replace(port_mod._smoke(),
                                       dtype=torch.bfloat16)
        params = carry.transformer_from_params(
            port_cfg, _jax_tree(ref_mod._smoke()), device="cpu")
        for lp, use_moe in zip(params["layers"], port_cfg.layer_uses_moe()):
            if use_moe:
                assert lp["moe"]["router"].dtype == torch.float32
                assert lp["moe"]["w_gate"].dtype == torch.bfloat16
        drawn = port_tf.init_params(port_cfg, device="cpu")
        routers = [lp["moe"]["router"] for lp in drawn["layers"]
                   if "moe" in lp]
        assert routers and all(r.dtype == torch.float32 for r in routers)
        others = [t for t in port_tf.tree_leaves(drawn)
                  if not any(t is r for r in routers)]
        assert all(t.dtype == torch.bfloat16 for t in others)

    def test_wrong_group_count_is_refused(self):
        port_cfg = deepseek_v3_671b._smoke()
        tree = _jax_tree(ref_deepseek._smoke())
        tree["groups"] = tree["groups"][1:]
        with pytest.raises(ValueError, match="1 layer groups"):
            carry.transformer_from_params(port_cfg, tree, device="cpu")
        tree = _jax_tree(ref_deepseek._smoke())
        tree["groups"][1]["moe"]["router"] = \
            tree["groups"][1]["moe"]["router"][:2]
        with pytest.raises(ValueError, match="group 1"):
            carry.transformer_from_params(port_cfg, tree, device="cpu")
        tree = _jax_tree(ref_deepseek._smoke())
        del tree["mtp"]
        with pytest.raises(ValueError, match="keys"):
            carry.transformer_from_params(port_cfg, tree, device="cpu")


# -- the launcher ----------------------------------------------------------------

@pytest.mark.parametrize("arch", tuple(SMOKE))
def test_launcher_serves_the_moe_archs_on_cpu(arch, capsys):
    run = launcher.run_lm(launcher.parse_args(
        ["--device", "cpu", "--arch", arch, "--requests", "3",
         "--max-new-tokens", "3"]))
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
    assert run.engine.pager.utilization == 0.0
    cfg = SMOKE[arch][0]._smoke()
    if cfg.attn_type == "mla":
        assert run.engine.k_pool.shape == (cfg.n_layers, 256, 16,
                                           cfg.kv_lora_rank)
        assert run.engine.v_pool.shape == (cfg.n_layers, 256, 16,
                                           cfg.qk_rope_dim)
    else:
        assert run.engine.k_pool.shape == (cfg.n_layers, 256, cfg.n_kv_heads,
                                           16, cfg.d_head)
