"""The port's LM serving path == the JAX package's, on the CPU.

On the CPU, kernel B8 (``paged_decode_attention``) runs its plain
PyTorch version.  It is held against the JAX package's oracle
(``kernels/paged_attn/ref.py``) and its Pallas kernel in interpret mode
at the JAX tests' tolerances (``tests/test_kernels.py``: rtol = atol =
2e-5 in float32, 2e-2 in bfloat16; both sum in float32, in their own
order), on the JAX tests' MHA, GQA and MQA shapes and at G = 7, Yi's
group width.  At ``seq_lens == 0`` the port gives zeros (ROADMAP C3), and
pages outside the plan, poisoned with NaN, leave the output unchanged.

The dense decoder is held against ``models/transformer.py`` with the
parameters drawn by the JAX ``init_params`` and carried across with
``repro_torch.carry.transformer_from_params``, on the smoke
configurations of GLM-4 9B, Granite-3 8B and Yi-34B, within
rtol = atol = 2e-5 (XLA orders the float32 products and softmax sums its
own way).  The engine is held against the JAX engine: the same token
streams, admission order and pager state after every round.  Its
batched paged decode agrees with the port's own dense ``decode_step``
within the same 2e-5.  The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py``.
"""

import dataclasses

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
from repro.configs.common import LM_SHAPES as REF_LM_SHAPES  # noqa: E402
from repro.kernels.paged_attn import kernel as ref_pk  # noqa: E402
from repro.kernels.paged_attn import ref as ref_pr  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve.kv_cache import PagedKVCache as RefPagedKVCache  # noqa: E402

from repro_torch import carry, configs  # noqa: E402
from repro_torch.configs import common as port_common  # noqa: E402
from repro_torch.configs import (arctic_480b, deepseek_v3_671b,  # noqa: E402
                                 glm4_9b, granite_3_8b, yi_34b)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.paged_attn import ops as pops  # noqa: E402
from repro_torch.kernels.paged_attn import ref as pref  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as port_tf  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from repro_torch.serve.kv_cache import PagedKVCache  # noqa: E402

# XLA orders the float32 products and softmax sums its own way.
F32 = dict(rtol=2e-5, atol=2e-5)


def tol(dtype):
    """The JAX kernel tests' tolerances (``tests/test_kernels.py``)."""
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else F32


ARCHS = {"glm4-9b": (glm4_9b, ref_glm),
         "granite-3-8b": (granite_3_8b, ref_granite),
         "yi-34b": (yi_34b, ref_yi),
         "deepseek-v3-671b": (deepseek_v3_671b, ref_deepseek),
         "arctic-480b": (arctic_480b, ref_arctic)}


# -- kernel B8 ---------------------------------------------------------------

def _attn_case(b, h, kvh, dh, ps, pmax, seed, lens=None):
    """float32 numpy inputs with each sequence's pages drawn without
    replacement from a pool of b * pmax + 3."""
    rng = np.random.default_rng(seed)
    n_pages = b * pmax + 3
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    kp = rng.normal(size=(n_pages, kvh, ps, dh)).astype(np.float32)
    vp = rng.normal(size=(n_pages, kvh, ps, dh)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, ps * pmax + 1, b)
    lens = np.asarray(lens, np.int32)
    bt = np.full((b, pmax), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for i in range(b):
        for j in range(int(np.ceil(lens[i] / ps))):
            bt[i, j] = free.pop()
    return q, kp, vp, bt, lens


def _port_attn(q, kp, vp, bt, lens, dtype="float32"):
    t = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out = pops.paged_decode_attention(
        torch.from_numpy(q).to(t), torch.from_numpy(kp).to(t),
        torch.from_numpy(vp).to(t), torch.from_numpy(bt),
        torch.from_numpy(lens))
    assert out.dtype == t
    return out.float().numpy()


def _jax_attn(fn, q, kp, vp, bt, lens, dtype="float32"):
    t = jnp.dtype(dtype)
    out = fn(jnp.asarray(q, t), jnp.asarray(kp, t), jnp.asarray(vp, t),
             jnp.asarray(bt), jnp.asarray(lens))
    return np.asarray(out, np.float32)


ATTN_SHAPES = [(2, 4, 4, 8, 4, 3),     # MHA
               (3, 8, 2, 16, 4, 6),    # GQA
               (1, 8, 1, 32, 8, 4),    # MQA
               (3, 14, 2, 8, 4, 5)]    # G = 7, Yi's group width
ATTN_IDS = ["mha", "gqa", "mqa", "g7"]


class TestPagedAttention:
    @pytest.mark.parametrize("shape", ATTN_SHAPES, ids=ATTN_IDS)
    @pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
    def test_plain_matches_jax_oracle(self, shape, dtype):
        b, h, kvh, dh, ps, pmax = shape
        case = _attn_case(*shape, seed=b * h + dh)
        np.testing.assert_allclose(
            _port_attn(*case, dtype=dtype),
            _jax_attn(ref_pr.paged_decode_attention, *case, dtype=dtype),
            **tol(dtype))

    @pytest.mark.parametrize("shape", ATTN_SHAPES, ids=ATTN_IDS)
    @pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
    def test_plain_matches_pallas_kernel(self, shape, dtype):
        b, h, kvh, dh, ps, pmax = shape
        case = _attn_case(*shape, seed=b * h + dh + 1)
        pallas = lambda *a: ref_pk.paged_decode_attention(  # noqa: E731
            *a, interpret=True)
        np.testing.assert_allclose(_port_attn(*case, dtype=dtype),
                                   _jax_attn(pallas, *case, dtype=dtype),
                                   **tol(dtype))

    @pytest.mark.parametrize("shape", ATTN_SHAPES, ids=ATTN_IDS)
    def test_pages_outside_the_plan_are_never_read(self, shape):
        """NaN in every page outside the plan and in the dead slots of
        the last live page: a masked read would still give NaN."""
        q, kp, vp, bt, lens = _attn_case(*shape, seed=7)
        ps = kp.shape[2]
        want = _port_attn(q, kp, vp, bt, lens)
        live = set(bt[bt >= 0].tolist())
        kp2, vp2 = kp.copy(), vp.copy()
        for pg in range(kp.shape[0]):
            if pg not in live:
                kp2[pg] = np.nan
                vp2[pg] = np.nan
        for i, n in enumerate(lens):
            if n % ps:
                kp2[bt[i, n // ps], :, n % ps:] = np.nan
                vp2[bt[i, n // ps], :, n % ps:] = np.nan
        got = _port_attn(q, kp2, vp2, bt, lens)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)

    def test_empty_sequence_gives_zeros(self):
        """C3: the JAX oracle gives NaN and the Pallas kernel the mean of
        page 0's V; the port's choice is zeros."""
        q, kp, vp, bt, lens = _attn_case(3, 8, 2, 16, 4, 6, seed=3,
                                         lens=[5, 0, 11])
        got = _port_attn(q, kp, vp, bt, lens)
        assert not got[1].any()
        rest = [0, 2]
        np.testing.assert_allclose(
            got[rest], _jax_attn(ref_pr.paged_decode_attention, q[rest],
                                 kp, vp, bt[rest], lens[rest]), **F32)

    def test_shared_and_repeated_page_ids(self):
        """Two sequences reading the same pages, one page twice."""
        q, kp, vp, _, _ = _attn_case(2, 8, 2, 16, 4, 4, seed=5)
        bt = np.array([[6, 2, 6, -1], [2, 6, 2, 6]], np.int32)
        lens = np.array([10, 16], np.int32)
        np.testing.assert_allclose(
            _port_attn(q, kp, vp, bt, lens),
            _jax_attn(ref_pr.paged_decode_attention, q, kp, vp, bt, lens),
            **F32)

    def test_cpu_tensors_launch_nothing(self):
        before = dict(LAUNCHES)
        _port_attn(*_attn_case(2, 4, 2, 8, 4, 3, seed=1))
        assert LAUNCHES == before

    def test_plan_indices_are_checked(self):
        q, kp, vp, bt, lens = _attn_case(2, 4, 2, 8, 4, 3, seed=2)
        bad = bt.copy()
        bad[0, 0] = kp.shape[0]
        with pytest.raises(IndexError, match="block_table"):
            _port_attn(q, kp, vp, bad, lens)
        bad[0, 0] = -2
        with pytest.raises(IndexError, match="block_table"):
            _port_attn(q, kp, vp, bad, lens)
        with pytest.raises(IndexError, match="seq_lens"):
            _port_attn(q, kp, vp, bt, np.array([3, 13], np.int32))
        with pytest.raises(ValueError, match="no paged attention path"):
            pops.paged_decode_attention(
                torch.zeros((2, 4, 8), device="meta"), torch.from_numpy(kp),
                torch.from_numpy(vp), bt, lens)

    @pytest.mark.parametrize("which", ("first", "last"))
    def test_minus_one_among_live_pages_is_refused(self, which):
        """A -1 entry is padding only past ceil(seq_lens / PS): inside
        that range it raises (the kernel would read it as a page id),
        and past it the same table is accepted."""
        q, kp, vp, bt, lens = _attn_case(3, 8, 2, 16, 4, 6, seed=4,
                                         lens=[9, 24, 1])
        ps = kp.shape[2]
        _port_attn(q, kp, vp, bt, lens)              # -1 past the live range
        bad = bt.copy()
        for i, n in enumerate(lens):
            live = -(-int(n) // ps)
            bad[i, 0 if which == "first" else live - 1] = -1
            with pytest.raises(IndexError, match="live pages"):
                _port_attn(q, kp, vp, bad, lens)
            bad[i] = bt[i]


# The card's bf16 shapes of B8's tensor-core kernel (csrc/paged_attn_tc.cu):
# G = 4 (Granite), 7 (Yi), 16 (GLM-4) at Dh = 128, PS = 16, B <= 5.
TC_SHAPES = [(4, 16, 4, 128, 16, 24), (3, 56, 8, 128, 16, 20),
             (5, 32, 2, 128, 16, 40)]
TC_IDS = ["g4", "g7", "g16"]
# The bounds chip_smoke.py holds the kernel to on the card: the JAX
# kernel tests' bf16 tolerance, and within 2^-7 of the largest |output|.
B8_REL = 2.0 ** -7


def _tc_emulation(q, kp, vp, bt, lens, n_split, p_halves=2, warps=4,
                  step=16, min_pages=pops.kernel.TC_MIN_SPLIT_PAGES):
    """The tensor-core kernel's arithmetic in plain float32 PyTorch, for
    bf16 tensors: per (sequence, KV head, split of at least
    ``min_pages`` pages), the split's live
    tokens in steps of ``step``, warp ``w`` taking steps w, w + warps,
    ...; per step S = Q K^T scaled by 1/sqrt(Dh), m and the float32 l
    updated online, and P V with P rounded to bf16 (``p_halves`` 1) or
    as bf16 hi + lo halves (2, the kernel); then the warps merged and
    the splits merged with the merge pass's formula, the output
    rounded to bf16.  Sums run in float32 in another order than the
    tensor cores', so this models the roundings, not every bit."""
    b, h, dh = q.shape
    _, kvh, ps, _ = kp.shape
    g = h // kvh
    scale = torch.tensor(1.0) / torch.sqrt(torch.tensor(float(dh)))
    out = torch.zeros((b, h, dh))

    def merged(states):
        big = torch.stack([m for m, _, _ in states]).max(0).values
        l_sum, o_sum = torch.zeros(g), torch.zeros((g, dh))
        for m, l, o in states:
            w = torch.where(big == -torch.inf, 0.0, torch.exp(m - big))
            l_sum, o_sum = l_sum + l * w, o_sum + o * w[:, None]
        return big, l_sum, o_sum

    for i in range(b):
        n = int(lens[i])
        pages = -(-n // ps)
        per = max(-(-pages // n_split), min_pages)
        for k in range(kvh):
            qf = q[i, k * g:(k + 1) * g].float()
            parts = []
            for s in range(n_split):
                t0 = s * per * ps
                t1 = min(min(s * per + per, pages) * ps, n)
                states = []
                for w in range(warps):
                    m = torch.full((g,), -torch.inf)
                    l, o = torch.zeros(g), torch.zeros((g, dh))
                    for st in range(t0 + w * step, t1, warps * step):
                        tok = torch.arange(st, min(st + step, t1))
                        rows = bt[i, tok // ps].long()
                        kk = kp[rows, k, tok % ps].float()
                        vv = vp[rows, k, tok % ps].float()
                        sc = (qf @ kk.T) * scale
                        mn = torch.maximum(m, sc.max(1).values)
                        alpha = torch.exp(m - mn)
                        pr = torch.exp(sc - mn[:, None])
                        l = l * alpha + pr.sum(1)
                        hi = pr.bfloat16().float()
                        pv = hi @ vv
                        if p_halves == 2:
                            pv = pv + (pr - hi).bfloat16().float() @ vv
                        o = o * alpha[:, None] + pv
                        m = mn
                    states.append((m, l, o))
                parts.append(merged(states))
            if n:
                _, l_sum, o_sum = merged(parts)
                out[i, k * g:(k + 1) * g] = o_sum / l_sum[:, None]
    return out.bfloat16()


def _within_b8_bounds(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return (torch.allclose(got, want, rtol=2e-2, atol=2e-2)
            and err <= B8_REL * float(want.abs().max())), err


class TestTensorCoreRounding:
    """B8's tensor-core kernel rounds P to bf16 for the P V product,
    where the JAX kernel and the plain version multiply in float32.  Its
    emulation stays within the card's bounds of the plain version and of
    the Pallas kernel (interpret mode) at the card's G = 4, 7, 16 shapes:
    the kernel's bf16 hi + lo halves of P with room to spare, one bf16 P
    too (at up to 0.0071 of the largest |output| against 2^-7 = 0.0078
    on these cases: the reason the kernel takes the two halves)."""

    @pytest.mark.parametrize("p_halves", (2, 1), ids=("hi_lo", "bf16"))
    @pytest.mark.parametrize("n_split", (1, 3))
    @pytest.mark.parametrize("shape", TC_SHAPES, ids=TC_IDS)
    def test_emulation_within_bounds_of_plain(self, shape, n_split,
                                              p_halves):
        for scale in (0.2, 1.0, 3.0):          # flat to peaked softmax
            q, kp, vp, bt, lens = _attn_case(*shape, seed=sum(shape))
            t = [torch.from_numpy(a) for a in (q * scale, kp, vp, bt, lens)]
            t[:3] = [a.bfloat16() for a in t[:3]]
            ok, err = _within_b8_bounds(
                _tc_emulation(*t, n_split=n_split, p_halves=p_halves),
                pref.paged_decode_attention(*t))
            assert ok, (scale, err)

    @pytest.mark.parametrize("shape", TC_SHAPES, ids=TC_IDS)
    def test_emulation_within_bounds_of_pallas_kernel(self, shape):
        q, kp, vp, bt, lens = _attn_case(*shape, seed=sum(shape) + 1)
        pallas = lambda *a: ref_pk.paged_decode_attention(  # noqa: E731
            *a, interpret=True)
        want = torch.from_numpy(_jax_attn(pallas, q, kp, vp, bt, lens,
                                          dtype="bfloat16"))
        t = [torch.from_numpy(a) for a in (q, kp, vp, bt, lens)]
        t[:3] = [a.bfloat16() for a in t[:3]]
        ok, err = _within_b8_bounds(_tc_emulation(*t, n_split=3), want)
        assert ok, err

    def test_emulation_models_the_hi_lo_gain(self):
        """The two halves carry p to ~16 bits: their emulation is closer
        to the plain version than one bf16 P on every case."""
        for shape in TC_SHAPES:
            q, kp, vp, bt, lens = _attn_case(*shape, seed=sum(shape))
            t = [torch.from_numpy(a) for a in (q * 0.2, kp, vp, bt, lens)]
            t[:3] = [a.bfloat16() for a in t[:3]]
            want = pref.paged_decode_attention(*t)
            _, two = _within_b8_bounds(_tc_emulation(*t, n_split=1), want)
            _, one = _within_b8_bounds(
                _tc_emulation(*t, n_split=1, p_halves=1), want)
            assert two < one, (shape, two, one)


# -- the layers and the decoder ---------------------------------------------

def _smoke(arch):
    port_mod, ref_mod = ARCHS[arch]
    return port_mod._smoke(), ref_mod._smoke()


def _jax_params(ref_cfg, seed=0):
    return ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)


def _carried(port_cfg, jparams):
    return carry.transformer_from_params(
        port_cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _dtype_name(dtype) -> str:
    return str(np.dtype(dtype)) if not isinstance(dtype, torch.dtype) \
        else str(dtype).removeprefix("torch.")


class TestLayers:
    def test_rmsnorm(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3
        scale = rng.normal(size=(64,)).astype(np.float32)
        got = port_layers.rmsnorm({"scale": torch.from_numpy(scale)},
                                  torch.from_numpy(x))
        want = ref_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                  jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    @pytest.mark.parametrize("theta", (10_000.0, 5_000_000.0))
    @pytest.mark.parametrize("d", (8, 16, 128))
    @pytest.mark.parametrize("span", ("short", "long"))
    def test_rope(self, theta, d, span):
        """Positions 0-47 at the model tolerance.  At positions up to
        4095 the float32 angle ``p · inv`` itself is rounded to about
        p · 2⁻²⁴ rad, and XLA's and PyTorch's ``pow``/``cos``/``sin``
        may round it differently: atol 4095 · 2⁻²¹ ≈ 2e-3 there."""
        rng = np.random.default_rng(d)
        pos = np.arange(48) if span == "short" else \
            np.array([0, 1, 300, 1000, 2047, 4095])
        pos = np.stack([pos, pos[::-1]]).astype(np.int32)      # (2, S)
        x = rng.normal(size=(*pos.shape, 3, d)).astype(np.float32)
        cos, sin = port_layers.rope_freqs(torch.from_numpy(pos), d, theta)
        jcos, jsin = ref_layers.rope_freqs(jnp.asarray(pos), d, theta)
        close = F32 if span == "short" else dict(rtol=0, atol=4095 * 2**-21)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **close)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **close)
        # the rotation itself, on the same tables
        got = port_layers.apply_rope(torch.from_numpy(x), cos, sin)
        want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(cos.numpy()),
                                     jnp.asarray(sin.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_glu_ffn_and_embeddings(self):
        rng = np.random.default_rng(1)
        p = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in (
            ("w_gate", (16, 40)), ("w_up", (16, 40)), ("w_down", (40, 16)))}
        x = rng.normal(size=(2, 3, 16)).astype(np.float32)
        got = port_layers.glu_ffn({k: torch.from_numpy(v)
                                   for k, v in p.items()},
                                  torch.from_numpy(x))
        want = ref_layers.glu_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        table = rng.normal(size=(50, 16)).astype(np.float32)
        ids = _tokens(50, (2, 3), 4)
        emb = port_layers.embed({"table": torch.from_numpy(table)},
                                torch.from_numpy(ids))
        np.testing.assert_array_equal(emb.numpy(), table[ids])
        np.testing.assert_allclose(
            port_layers.unembed({"table": torch.from_numpy(table)},
                                torch.from_numpy(x)).numpy(),
            np.asarray(ref_layers.unembed({"table": jnp.asarray(table)},
                                          jnp.asarray(x))), **F32)


def _assert_caches_close(cache, jcache):
    """The dense caches, group by group and key by key (``{"k", "v"}``
    or MLA's ``{"c_kv", "k_rope"}``)."""
    assert len(cache) == len(jcache)
    for ours, theirs in zip(cache, jcache):
        assert set(ours) == set(theirs)
        for key in theirs:
            np.testing.assert_allclose(ours[key].numpy(),
                                       np.asarray(theirs[key]), **F32)


@pytest.mark.parametrize("arch", tuple(ARCHS))
class TestDecoder:
    def test_forward(self, arch):
        port_cfg, ref_cfg = _smoke(arch)
        jp = _jax_params(ref_cfg)
        params = _carried(port_cfg, jp)
        toks = _tokens(ref_cfg.vocab, (2, 13), 1)
        got, _ = port_tf.forward(params, port_cfg, torch.from_numpy(toks))
        want, _ = ref_tf.forward(jp, ref_cfg, jnp.asarray(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_q_chunked_forward(self, arch):
        port_cfg, ref_cfg = _smoke(arch)
        port_cfg = dataclasses.replace(port_cfg, q_chunk=4)
        ref_cfg = dataclasses.replace(ref_cfg, q_chunk=4)
        jp = _jax_params(ref_cfg, seed=2)
        toks = _tokens(ref_cfg.vocab, (2, 12), 2)
        got, _ = port_tf.forward(_carried(port_cfg, jp), port_cfg,
                                 torch.from_numpy(toks))
        want, _ = ref_tf.forward(jp, ref_cfg, jnp.asarray(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_prefill_and_decode_step(self, arch):
        port_cfg, ref_cfg = _smoke(arch)
        jp = _jax_params(ref_cfg, seed=1)
        params = _carried(port_cfg, jp)
        toks = _tokens(ref_cfg.vocab, (2, 9), 3)
        lg, cache = port_tf.prefill(params, port_cfg, torch.from_numpy(toks),
                                    max_seq=16)
        jlg, jcache = ref_tf.prefill(jp, ref_cfg, jnp.asarray(toks),
                                     max_seq=16)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32)
        _assert_caches_close(cache, jcache)
        pos = np.array([9, 9], np.int32)
        for step in range(4):
            nxt = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
            lg, cache = port_tf.decode_step(params, port_cfg, cache,
                                            torch.from_numpy(nxt),
                                            torch.from_numpy(pos))
            jlg, jcache = ref_tf.decode_step(jp, ref_cfg, jcache,
                                             jnp.asarray(nxt),
                                             jnp.asarray(pos))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32)
            pos = pos + 1
        _assert_caches_close(cache, jcache)

    def test_paged_decode_equals_dense_decode(self, arch):
        """The engine's paged prefill and batched paged decode (B8's
        plain version) against the port's dense prefill and
        ``decode_step``, sequence by sequence."""
        port_cfg, ref_cfg = _smoke(arch)
        params = _carried(port_cfg, _jax_params(ref_cfg, seed=3))
        ps, lens = 4, (5, 8, 11)
        pager = PagedKVCache(n_pages=24, page_size=ps, max_pages_per_seq=6)
        k_pool, v_pool = port_tf.init_paged_cache(port_cfg, 24, ps,
                                                  device="cpu")
        prompts = [torch.from_numpy(_tokens(port_cfg.vocab, (1, n), n))
                   for n in lens]
        dense, nxt = [], []
        for rid, prompt in enumerate(prompts):
            pages = pager.allocate(rid, prompt.shape[1])
            lg = port_tf.prefill_paged(params, port_cfg, prompt, k_pool,
                                       v_pool, torch.tensor(pages))
            dlg, cache = port_tf.prefill(params, port_cfg, prompt,
                                         max_seq=24)
            np.testing.assert_allclose(lg.numpy(), dlg.numpy(), **F32)
            dense.append(cache)
            nxt.append(int(torch.argmax(dlg[0])))
            pager.extend(rid)
        for _ in range(5):
            table, seq_lens = pager.plan([0, 1, 2])
            pos = torch.from_numpy(seq_lens - 1)
            got = port_tf.decode_paged(
                params, port_cfg, k_pool, v_pool,
                torch.tensor(nxt, dtype=torch.int32), pos,
                torch.from_numpy(table), torch.from_numpy(seq_lens))
            for i in range(3):
                want, dense[i] = port_tf.decode_step(
                    params, port_cfg, dense[i], torch.tensor([nxt[i]]),
                    pos[i:i + 1])
                np.testing.assert_allclose(got[i:i + 1].numpy(),
                                           want.numpy(), **F32)
            nxt = torch.argmax(got, -1).tolist()
            for rid in range(3):
                pager.extend(rid)


class TestParams:
    @pytest.mark.parametrize("arch", tuple(ARCHS))
    def test_full_size_counts_equal_jax(self, arch):
        port_mod, ref_mod = ARCHS[arch]
        shapes = jax.eval_shape(
            lambda k: ref_tf.init_params(k, ref_mod._cfg()),
            jax.random.PRNGKey(0))
        want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        params = port_tf.init_params(port_mod._cfg(), device="meta")
        assert port_tf.count_params(params) == want
        assert params["embed"]["table"].is_meta
        if arch == "glm4-9b":
            assert want == 8_779_010_048

    def test_carry_checks_shapes(self):
        port_cfg, ref_cfg = _smoke("glm4-9b")
        tree = jax.tree.map(np.asarray, _jax_params(ref_cfg))
        tree["groups"][0]["attn"]["wq"] = tree["groups"][0]["attn"]["wq"][
            :, :, :-1]
        with pytest.raises(ValueError, match="wq"):
            carry.transformer_from_params(port_cfg, tree, device="cpu")
        tree = jax.tree.map(np.asarray, _jax_params(ref_cfg))
        tree["groups"][0]["ffn"]["w_up"] = tree["groups"][0]["ffn"]["w_up"][
            :1]
        with pytest.raises(ValueError, match="layers"):
            carry.transformer_from_params(port_cfg, tree, device="cpu")
        tree = jax.tree.map(np.asarray, _jax_params(ref_cfg))
        tree["extra"] = tree["embed"]
        with pytest.raises(ValueError, match="keys"):
            carry.transformer_from_params(port_cfg, tree, device="cpu")

    def test_init_is_seeded_and_in_the_config_dtype(self):
        cfg = dataclasses.replace(glm4_9b._smoke(), dtype=torch.bfloat16)
        state = torch.random.get_rng_state()
        a = port_tf.init_params(cfg, device="cpu", seed=4)
        b = port_tf.init_params(cfg, device="cpu", seed=4)
        assert torch.equal(torch.random.get_rng_state(), state)
        for x, y in zip(port_tf.tree_leaves(a), port_tf.tree_leaves(b)):
            assert x.dtype == torch.bfloat16 and torch.equal(x, y)
        wq = a["layers"][0]["attn"]["wq"].float()
        assert abs(float(wq.std()) - 1 / 8) < 0.02          # 1/sqrt(64)
        assert not a["layers"][0]["attn_norm"]["scale"].float().sub(1).any()

    @pytest.mark.parametrize("change", (
        dict(attn_type="mla", kv_lora_rank=16, qk_nope_dim=8,
             qk_rope_dim=8, v_head_dim=16),
        dict(moe=port_moe.MoEConfig(d_model=64, d_ff=32, n_experts=4,
                                    top_k=2)),
        dict(mtp=True),
        dict(learned_pos=True)), ids=("mla", "moe", "mtp", "learned_pos"))
    def test_unported_paths_raise(self, change):
        """Nothing is left unported: MLA, MoE, MTP and learned-position
        (ROADMAP A10c) configurations build and run one forward."""
        cfg = dataclasses.replace(glm4_9b._smoke(), **change)
        params = port_tf.init_params(cfg, device="cpu", seed=1)
        assert ("mtp" in params) == cfg.mtp
        assert ("pos_embed" in params) == cfg.learned_pos
        logits, aux = port_tf.forward(params, cfg, torch.from_numpy(
            _tokens(cfg.vocab, (2, 7), 0)))
        assert logits.shape == (2, 7, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
        assert (float(aux) > 0) == (cfg.moe is not None)

    def test_entry_points_default_to_the_card(self):
        cfg = glm4_9b._smoke()
        if torch.cuda.is_available():
            assert port_tf.init_params(cfg)["embed"]["table"].is_cuda
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_tf.init_params(cfg)
            params = port_tf.init_params(cfg, device="cpu")
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port_engine.ServeEngine(params, cfg,
                                        port_engine.EngineConfig())


class TestConfigs:
    @pytest.mark.parametrize("arch", tuple(ARCHS))
    @pytest.mark.parametrize("which", ("_cfg", "_smoke"))
    def test_values_equal_jax_field_by_field(self, arch, which):
        port_mod, ref_mod = ARCHS[arch]
        assert port_mod.ID == ref_mod.ID == arch
        ours = dataclasses.asdict(getattr(port_mod, which)())
        theirs = dataclasses.asdict(getattr(ref_mod, which)())
        for key, value in ours.items():
            if key == "dtype":
                assert _dtype_name(value) == _dtype_name(theirs[key])
            else:
                assert value == theirs[key], key
        assert configs.get_config(arch, smoke=which == "_smoke") == \
            getattr(port_mod, which)()

    def test_lm_shapes(self):
        assert port_common.LM_SHAPES == REF_LM_SHAPES


# -- the pager and the engine ------------------------------------------------

def tiny_cfgs():
    """``tests/test_serve.py``'s tiny configuration, in both packages."""
    kw = dict(name="tiny", vocab=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_head=8, d_ff=64, q_chunk=None)
    return port_tf.TransformerConfig(**kw), ref_tf.TransformerConfig(**kw)


def _pager_state(pager):
    return (list(pager.free_pages), {k: list(v) for k, v in
                                     pager.tables.items()},
            dict(pager.lengths))


def _engines(port_cfg, ref_cfg, ecfg_kw, seed=0):
    jp = _jax_params(ref_cfg, seed)
    ours = port_engine.ServeEngine(_carried(port_cfg, jp), port_cfg,
                                   port_engine.EngineConfig(**ecfg_kw),
                                   device="cpu")
    theirs = ref_engine.ServeEngine(jp, ref_cfg,
                                    ref_engine.EngineConfig(**ecfg_kw))
    return ours, theirs


def _submit(ours, theirs, prompts, max_new_tokens):
    for rid, prompt in enumerate(prompts):
        ours.submit(port_engine.Request(prompt=prompt, rid=rid,
                                        max_new_tokens=max_new_tokens))
        theirs.submit(ref_engine.Request(prompt=prompt, rid=rid,
                                         max_new_tokens=max_new_tokens))


def _lockstep(ours, theirs) -> tuple[list, list]:
    """Both engines round by round (``run``'s loop), comparing the live
    set, the queue and the pager after each step."""
    done_ours, done_theirs, rounds = [], [], 0
    while theirs.queue or theirs.live:
        for eng in (ours, theirs):
            eng._admit()
        assert list(ours.live) == list(theirs.live)
        assert [r.rid for r in ours.queue] == [r.rid for r in theirs.queue]
        assert _pager_state(ours.pager) == _pager_state(theirs.pager)
        for eng in (ours, theirs):
            eng._decode_round()
        assert _pager_state(ours.pager) == _pager_state(theirs.pager)
        done_ours += ours._collect()
        done_theirs += theirs._collect()
        assert [r.rid for r in done_ours] == [r.rid for r in done_theirs]
        assert _pager_state(ours.pager) == _pager_state(theirs.pager)
        rounds += 1
        assert rounds < 200
    assert not (ours.queue or ours.live)
    for a, b in zip(done_ours, done_theirs):
        assert a.out_tokens == b.out_tokens, a.rid
    return done_ours, done_theirs


class TestEngine:
    def test_reference_engine_config_constructs(self):
        """ROADMAP C9: a configuration written for the JAX engine (its
        ``greedy`` field included) carries over."""
        theirs = ref_engine.EngineConfig()
        ours = port_engine.EngineConfig(**dataclasses.asdict(theirs))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.greedy is True

    def test_end_to_end_batch(self):
        ours, theirs = _engines(*tiny_cfgs(), dict(
            max_batch=4, max_seq=64, page_size=8, n_pages=64))
        rng = np.random.default_rng(0)
        _submit(ours, theirs, [rng.integers(0, 64, 12).astype(np.int32)
                               for _ in range(6)], 6)
        done, _ = _lockstep(ours, theirs)
        assert len(done) == 6 and all(len(r.out_tokens) == 6 for r in done)
        assert ours.pager.utilization == 0.0

    def test_greedy_matches_manual_decode(self):
        ours, theirs = _engines(*tiny_cfgs(), dict(
            max_batch=1, max_seq=32, page_size=4, n_pages=32))
        _submit(ours, theirs, [np.arange(8, dtype=np.int32)], 4)
        done, _ = _lockstep(ours, theirs)
        port_cfg, _ = tiny_cfgs()
        logits, cache = port_tf.prefill(ours.params, port_cfg,
                                        torch.arange(8)[None], max_seq=32)
        toks = [int(torch.argmax(logits[0]))]
        for pos in range(8, 11):
            logits, cache = port_tf.decode_step(
                ours.params, port_cfg, cache, torch.tensor([toks[-1]]),
                torch.tensor([pos]))
            toks.append(int(torch.argmax(logits[0])))
        assert done[0].out_tokens == toks

    def test_admission_control_no_deadlock(self):
        ours, theirs = _engines(*tiny_cfgs(), dict(
            max_batch=4, max_seq=32, page_size=4, n_pages=12))
        rng = np.random.default_rng(1)
        _submit(ours, theirs, [rng.integers(0, 64, 8).astype(np.int32)
                               for _ in range(3)], 4)
        done, _ = _lockstep(ours, theirs)
        assert len(done) == 3

    @pytest.mark.parametrize("arch", tuple(ARCHS))
    def test_smoke_configs_mid_stream_admission(self, arch):
        """More requests than slots, of mixed lengths, on each smoke
        configuration: admission runs while others decode."""
        ours, theirs = _engines(*_smoke(arch), dict(
            max_batch=3, max_seq=48, page_size=4, n_pages=40), seed=5)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, 256, n).astype(np.int32)
                   for n in rng.integers(3, 20, 7)]
        _submit(ours, theirs, prompts, 9)
        done, _ = _lockstep(ours, theirs)
        assert sorted(r.rid for r in done) == list(range(7))

    def test_run_equals_jax_run(self):
        ours, theirs = _engines(*_smoke("granite-3-8b"), dict(
            max_batch=2, max_seq=40, page_size=8, n_pages=16), seed=6)
        rng = np.random.default_rng(3)
        _submit(ours, theirs, [rng.integers(0, 256, n).astype(np.int32)
                               for n in (5, 17, 9, 2)], 6)
        a, b = ours.run(), theirs.run()
        assert [(r.rid, r.out_tokens) for r in a] == \
            [(r.rid, r.out_tokens) for r in b]

    def test_pool_exhaustion_raises_as_in_jax(self):
        """C4: admission reserves nothing, so two admitted sequences grow
        into the same free pages and decode runs out."""
        ours, theirs = _engines(*_smoke("glm4-9b"), dict(
            max_batch=4, max_seq=256, page_size=4, n_pages=6))
        rng = np.random.default_rng(4)
        _submit(ours, theirs, [rng.integers(0, 256, 3).astype(np.int32)
                               for _ in range(2)], 16)
        with pytest.raises(MemoryError, match="KV cache exhausted"):
            theirs.run()
        with pytest.raises(MemoryError, match="KV cache exhausted"):
            ours.run()
        assert _pager_state(ours.pager) == _pager_state(theirs.pager)
        assert len(ours.live) == 2 and not ours.pager.free_pages

    def test_request_that_never_fits_raises(self):
        port_cfg, _ = _smoke("glm4-9b")
        eng = port_engine.ServeEngine(
            port_tf.init_params(port_cfg, device="cpu"), port_cfg,
            port_engine.EngineConfig(max_batch=2, max_seq=64, page_size=4,
                                     n_pages=4), device="cpu")
        with pytest.raises(MemoryError, match="pool has 4"):
            eng.submit(port_engine.Request(
                prompt=np.arange(10, dtype=np.int32), max_new_tokens=8))
        with pytest.raises(ValueError, match="max_seq"):
            eng.submit(port_engine.Request(
                prompt=np.arange(60, dtype=np.int32), max_new_tokens=8))
        assert eng.run() == []


class TestPager:
    @pytest.mark.parametrize("cls", (PagedKVCache, RefPagedKVCache),
                             ids=("port", "jax"))
    def test_slot_is_one_past_the_pending_token(self, cls):
        """C5: after ``extend`` (the engine's order), ``slot()`` names
        position ``lengths``, one past the token whose K/V is pending."""
        pager = cls(n_pages=8, page_size=4, max_pages_per_seq=4)
        pager.allocate(1, 5)
        pager.extend(1)                       # token at position 5
        pages = pager.tables[1]
        assert pager.slot(1) == (pages[1], 2)          # position 6
        _, lens = pager.plan([1])
        pos = int(lens[0]) - 1                          # the engine's write
        assert (pages[pos // 4], pos % 4) == (pages[1], 1)
        pager.allocate(2, 3)
        pager.extend(2)                       # token at position 3
        with pytest.raises(IndexError):
            pager.slot(2)                              # position 4: no page

    def test_same_decisions_as_jax_pager(self):
        rng = np.random.default_rng(9)
        ours, theirs = PagedKVCache(20, 4, 8), RefPagedKVCache(20, 4, 8)
        live = []
        for step in range(200):
            op = "allocate" if not live else \
                ("allocate", "extend", "release")[int(rng.integers(3))]
            if op == "allocate":
                arg = (step, int(rng.integers(1, 12)))
            else:
                arg = (live[int(rng.integers(len(live)))],)
            outcomes = []
            for pager in (ours, theirs):
                try:
                    outcomes.append(getattr(pager, op)(*arg))
                except MemoryError:
                    outcomes.append(MemoryError)
            assert outcomes[0] == outcomes[1]
            if op == "allocate" and outcomes[0] is not MemoryError:
                live.append(step)
            elif op == "release":
                live.remove(arg[0])
            assert _pager_state(ours) == _pager_state(theirs)
            if live:
                for a, b in zip(ours.plan(live), theirs.plan(live)):
                    np.testing.assert_array_equal(a, b)


# -- the launcher ------------------------------------------------------------

class TestLauncher:
    @pytest.mark.parametrize("arch", ("glm4-9b", "yi-34b"))
    def test_lm_mode_on_cpu(self, arch, capsys):
        run = launcher.run_lm(launcher.parse_args(
            ["--mode", "lm", "--device", "cpu", "--arch", arch,
             "--requests", "5", "--max-new-tokens", "3"]))
        assert "served 5 requests / 15 tokens" in capsys.readouterr().out
        assert len(run.done) == 5 and run.tokens == 15
        assert all(len(r.out_tokens) == 3 for r in run.done)
        assert run.engine.device.type == "cpu"
        assert run.engine.pager.utilization == 0.0
        assert run.engine.k_pool.shape == (2, 256, _smoke(arch)[0].n_kv_heads,
                                           16, _smoke(arch)[0].d_head)

    def test_lm_is_the_default_mode(self, capsys):
        """ROADMAP C8: with no ``--mode`` the launcher serves the LM, as
        the JAX package's does."""
        launcher.main(["--device", "cpu", "--requests", "2",
                       "--max-new-tokens", "2"])
        assert "served 2 requests / 4 tokens" in capsys.readouterr().out

    def test_lm_mode_guards(self):
        assert launcher.parse_args([]).arch == "glm4-9b"
        assert launcher.parse_args([]).max_new_tokens == 16
        with pytest.raises(SystemExit, match="not an LM"):
            launcher.main(["--mode", "lm", "--device", "cpu",
                           "--arch", "nequip"])
        with pytest.raises(SystemExit, match="unknown arch"):
            launcher.main(["--mode", "lm", "--device", "cpu",
                           "--arch", "no-such-arch"])
        # BERT4Rec serves (ROADMAP A10c), but its smoke model's 16
        # learned positions hold no 4-token prompt and 16 new tokens
        # (ROADMAP C12).
        with pytest.raises(SystemExit, match="learned positions"):
            launcher.main(["--mode", "lm", "--device", "cpu",
                           "--arch", "bert4rec"])
        launcher.main(["--mode", "lm", "--device", "cpu",
                       "--arch", "bert4rec", "--requests", "2",
                       "--max-new-tokens", "3"])
