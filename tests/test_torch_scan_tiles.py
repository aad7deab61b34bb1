"""Plain emulations of the work order of two CUDA kernels, held byte for
byte against the port's plain versions and the JAX package.

The kernels themselves run only on the card (``test_torch_cuda.py``).
These emulations, in numpy, follow their order of work step by step, so
that the order itself is shown to give the reference's bytes:

* B3 ``plan_runs_2d`` (``csrc/plan_runs_2d.cu``): a warp per job, its row
  range by a warp-wide search (32 chunks a step), its rows in 32-row
  steps, each live slot ranked by ballots in (row, segment) order; tiles
  of 4 jobs whose exclusive prefixes come from a decoupled look-back over
  published (flag, value) descriptors, 32 a step, under seeded random
  interleavings of the tiles; every run written straight into a zeroed
  buffer.  Held against ``ref.plan_runs_2d`` and
  ``repro.kernels.plan.ref.plan_runs_2d`` under ``jax.enable_x64(True)``
  (float64) and without it (float32).
* B6's tiled kernel (``csrc/gather.cu``, ``gather_rows_bag_tiled``): a warp
  per tile of 32 bags (256 at one pack a row), lane i owning packs i,
  i + 32, ... with each pack's bag and column stepped as the kernel steps
  them, its id passed from the bag's lane, the adds in ``l`` order from
  +0.0.  Held against ``ref.gather_rows_bag`` and the Pallas kernel in
  interpret mode.

Every comparison is exact: both kernels produce integers or add in the
references' order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.gather import kernel as ref_gather_kernel  # noqa: E402
from repro.kernels.plan import ref as ref_plan  # noqa: E402

from repro_torch.kernels.gather import ref as gref  # noqa: E402
from repro_torch.kernels.plan import ref as pref  # noqa: E402
from torch_plan_cases import PLAN_SCAN_CASES, plan_scan_case  # noqa: E402

PLAN_WARPS = 4          # jobs per tile (csrc/plan_runs_2d.cu)
BAGS_PER_LANE = 8       # the tiled B6 kernel's K at one pack a row
WARP = 32


def _bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


# -- B3 ----------------------------------------------------------------------

def warp_count(sv, x, le: bool) -> int:
    """B3's warp-wide count of sorted ``sv`` below ``x`` (at most ``x``
    with ``le``): chunks of at most 32 tested at their last value, then
    one value a lane."""
    lane = np.arange(WARP)
    test = (lambda v: v <= x) if le else (lambda v: v < x)
    lo, hi = 0, len(sv)
    while hi - lo > WARP:
        c = -(-(hi - lo) // WARP)
        e = lo + (lane + 1) * c - 1
        t = (e < hi) & test(sv[np.minimum(e, hi - 1)])
        assert not (t[1:] & ~t[:-1]).any()        # the true tests: a prefix
        lo += c * int(t.sum())
        hi = min(lo + c, hi)
    i = lo + lane
    t = (i < hi) & test(sv[np.minimum(i, max(hi - 1, 0))]) if hi else i < 0
    return lo + int(t.sum())


def _job_spans(verts, valid, sv0, eps0, rows):
    """Live rows of each job: the warp-wide searches' i1 - i0, clamped
    to [0, rows]."""
    x = verts[:, :, 0]
    lo0 = np.where(valid, x, np.inf).min(1)
    hi0 = np.where(valid, x, -np.inf).max(1)
    i0 = np.array([warp_count(sv0, v - eps0, le=False) for v in lo0])
    i1 = np.array([warp_count(sv0, v + eps0, le=True) for v in hi0])
    return np.clip(i1 - i0, 0, rows)


def _look_back(aggregates, rng, p_finish=0.5):
    """Exclusive prefix of each tile by decoupled look-back, tiles
    interleaved at random: each publishes its aggregate when it starts
    (in ticket order); a started tile later walks back over the
    descriptors 32 at a time (one a lane, the nearest first; before tile
    0 an empty prefix), adding aggregates up to and including the nearest
    inclusive prefix, and publishes its own.  After each start, a tile
    still waiting finishes with probability ``p_finish`` (at 0 every tile
    starts before any finishes).  Tile 0 publishes its prefix at once."""
    n = len(aggregates)
    flags = np.zeros(n, np.int64)        # 1: aggregate, 2: inclusive prefix
    values = np.zeros(n, np.int64)
    exclusive = np.full(n, -1, np.int64)
    waiting = []

    def finish(t):
        s = 0
        for end in range(t - 1, -WARP - 1, -WARP):
            window = end - np.arange(WARP)
            inside = window >= 0
            flag = np.where(inside, flags[np.maximum(window, 0)], 2)
            value = np.where(inside, values[np.maximum(window, 0)], 0)
            assert (flag > 0).all()       # every started tile has published
            prefix = np.flatnonzero(flag == 2)
            stop = prefix[0] if len(prefix) else WARP - 1
            s += int(value[:stop + 1].sum())
            if len(prefix):
                break
        exclusive[t] = s
        flags[t], values[t] = 2, s + aggregates[t]

    for t in range(n):
        if t == 0:
            exclusive[0] = 0
            flags[0], values[0] = 2, aggregates[0]
        else:
            flags[t], values[t] = 1, aggregates[t]
            waiting.append(t)
        while waiting and rng.random() < p_finish:
            finish(waiting.pop(rng.integers(len(waiting))))
    while waiting:
        finish(waiting.pop(rng.integers(len(waiting))))
    return exclusive


def emulate_plan_runs_2d(args, kw, seed, p_finish=0.5):
    """B3's buffers and meta, computed in the kernel's order from the
    uncompacted slots of ``ref.row_slots_2d``."""
    tensors = [torch.from_numpy(a) for a in args]
    starts, lengths, ok, _, _ = (t.numpy() for t in pref.row_slots_2d(
        *tensors, **kw))
    verts, valid, _, sv0, _, _, scalars = args
    jobs, rows = ok.shape[0], kw["max_rows"]
    span = _job_spans(verts, valid, sv0, scalars[0], rows)
    lane = np.arange(WARP)
    below = lane[:, None] > lane[None, :]          # ballot & lanes below
    ranks, runs = [], np.zeros(jobs, np.int64)
    for j in range(jobs):
        # Every live slot beyond the job's live rows would be a fault.
        assert not ok[j, span[j]:].any()
        job_ranks, carry = [], 0
        for k in range(0, rows, WARP):
            r = k + lane
            inside = r < rows
            o = np.zeros((WARP, 2), bool)
            o[inside] = ok[j, r[inside]]
            rank0 = carry + (below & o[:, 0]).sum(1) + (below & o[:, 1]).sum(1)
            for ln in lane[o[:, 0]]:
                job_ranks.append((rank0[ln], r[ln], 0))
            for ln in lane[o[:, 1]]:
                job_ranks.append((rank0[ln] + o[ln, 0], r[ln], 1))
            carry += int(o.sum())
        ranks.append(job_ranks)
        runs[j] = carry
    n_tiles = -(-jobs // PLAN_WARPS)
    tile_runs = np.zeros(n_tiles * PLAN_WARPS, np.int64)
    tile_runs[:jobs] = runs
    tile_runs = tile_runs.reshape(n_tiles, PLAN_WARPS)
    exclusive = _look_back(tile_runs.sum(1), np.random.default_rng(seed),
                           p_finish)
    in_tile = np.cumsum(tile_runs, 1) - tile_runs
    m = jobs * rows * 2
    run_start = np.zeros(m, np.int32)
    run_len = np.zeros(m, np.int32)
    for j in range(jobs):
        first = exclusive[j // PLAN_WARPS] + in_tile[j // PLAN_WARPS,
                                                     j % PLAN_WARPS]
        for rank, r, seg in ranks[j]:
            run_start[first + rank] = starts[j, r, seg]
            run_len[first + rank] = lengths[j, r, seg]
    points = np.where(ok, lengths, 0).sum()
    meta = np.array([runs.sum(), span.sum(), points], np.int32)
    return run_start, run_len, meta


def _jax_plan(args, kw):
    return [np.asarray(o) for o in ref_plan.plan_runs_2d(
        *(jnp.asarray(a) for a in args), **kw)]


class TestPlanScanOrder:
    @pytest.mark.parametrize("jobs,max_rows,kind", PLAN_SCAN_CASES)
    def test_emulation_equals_plain_and_jax_float64(self, jobs, max_rows,
                                                    kind):
        args, kw = plan_scan_case(jobs, max_rows, kind, seed=jobs + max_rows)
        got = emulate_plan_runs_2d(args, kw, seed=jobs)
        plain = pref.plan_runs_2d(*(torch.from_numpy(a) for a in args),
                                  **kw)
        with jax.enable_x64(True):
            want = _jax_plan(args, kw)
        for g, p, w in zip(got, plain, want):
            assert np.array_equal(_bytes(g), _bytes(p.numpy()))
            assert np.array_equal(_bytes(g), _bytes(w))
        assert (got[2][0] == 0) == (kind == "none")

    @pytest.mark.parametrize("jobs,max_rows,kind", PLAN_SCAN_CASES[1:4])
    def test_emulation_equals_plain_and_jax_float32(self, jobs, max_rows,
                                                    kind):
        args, kw = plan_scan_case(jobs, max_rows, kind, seed=jobs,
                                  dtype=np.float32)
        got = emulate_plan_runs_2d(args, kw, seed=jobs + 1)
        plain = pref.plan_runs_2d(*(torch.from_numpy(a) for a in args),
                                  **kw)
        want = _jax_plan(args, kw)
        for g, p, w in zip(got, plain, want):
            assert np.array_equal(_bytes(g), _bytes(p.numpy()))
            assert np.array_equal(_bytes(g), _bytes(w))

    @pytest.mark.parametrize("p_finish", (0.0, 0.1, 0.5, 0.9))
    def test_any_interleaving_of_tiles_gives_the_same_buffer(self,
                                                             p_finish):
        """300 jobs, 75 tiles, under interleavings from every tile
        started before any finishes (look-backs past one 32-descriptor
        step) to each finishing soon after it starts."""
        args, kw = plan_scan_case(300, 24, "seam", seed=5)
        got = emulate_plan_runs_2d(args, kw, seed=7, p_finish=p_finish)
        plain = pref.plan_runs_2d(*(torch.from_numpy(a) for a in args),
                                  **kw)
        for g, p in zip(got, plain):
            assert np.array_equal(_bytes(g), _bytes(p.numpy()))

    @pytest.mark.parametrize("n", (0, 1, 31, 32, 33, 640, 1024, 1025, 5000))
    def test_warp_count_is_the_comparison_count(self, n):
        """The row range's warp-wide search equals searchsorted (the
        reference's comparison count) on sorted values with repeats, at
        values below, inside, on and above them."""
        rng = np.random.default_rng(n)
        sv = np.sort(np.round(rng.uniform(-90, 90, n), 1))
        xs = np.concatenate([[-np.inf, -100.0, 100.0, np.inf],
                             rng.uniform(-95, 95, 40), sv[::max(n // 7, 1)]])
        for x in xs:
            assert warp_count(sv, x, le=False) == np.searchsorted(
                sv, x, side="left")
            assert warp_count(sv, x, le=True) == np.searchsorted(
                sv, x, side="right")

    def test_cases_hold_what_they_claim(self):
        """The seam case has rows of two segments, jobs with rows but no
        runs and jobs with no rows; the row loop runs past 32 rows."""
        args, kw = plan_scan_case(33, 72, "seam", seed=33 + 72)
        tensors = [torch.from_numpy(a) for a in args]
        _, _, ok, _, _ = (t.numpy() for t in pref.row_slots_2d(*tensors,
                                                                **kw))
        verts, valid, _, sv0, _, _, scalars = args
        span = _job_spans(verts, valid, sv0, scalars[0], 72)
        assert ok.all(axis=2).any()                       # two segments
        assert ((span > 0) & ~ok.any(axis=(1, 2))).any()  # rows, no runs
        assert (span == 0).any() and span.max() > WARP


# -- B6, the tiled kernel -----------------------------------------------------

def emulate_tiled_bag(table, bags, vec):
    """B6's tiled kernel in numpy: tiles of 32 bags (32 * 8 at one pack a
    row), lane i owning the tile's packs i, i + 32, ... with (bag,
    column) stepped by 32 = q * dv + r as the kernel steps them."""
    b, n_slots = bags.shape
    d = table.shape[1]
    dv = d // vec
    k = BAGS_PER_LANE if dv == 1 else 1
    tile = WARP * k
    owned = k if k > 1 else dv
    q, r = divmod(WARP, dv)
    lane = np.arange(WARP)
    packs = table.reshape(table.shape[0], dv, vec)
    out = np.full((b, dv, vec), np.nan, table.dtype)
    # Each owned pack's bag and column, stepped as in the kernel.
    bag, col, where = lane // dv, lane % dv, []
    for j in range(owned):
        if k > 1:
            where.append((WARP * j + lane, np.zeros(WARP, np.int64)))
        else:
            assert np.array_equal(bag * dv + col, lane + WARP * j)
            where.append((bag.copy(), col.copy()))
        bag, col = bag + q, col + r
        wrap = col >= dv
        col[wrap] -= dv
        bag[wrap] += 1
    for first in range(0, b, tile):
        acc = np.zeros((owned, WARP, vec), table.dtype)
        for s in range(n_slots):
            held = [np.where(first + WARP * kk + lane < b,
                             bags[np.minimum(first + WARP * kk + lane,
                                             b - 1), s], -1)
                    for kk in range(k)]
            rows = np.zeros_like(acc)
            for j, (bj, cj) in enumerate(where):
                ids = held[j] if k > 1 else held[0][bj]   # the shuffle
                live = ids >= 0
                rows[j, live] = packs[ids[live], cj[live]]
            acc = acc + rows                               # l order
        live = min(b - first, tile) * dv
        for j, (bj, cj) in enumerate(where):
            p = lane + WARP * j
            keep = p < live
            out[first + bj[keep], cj[keep]] = acc[j, keep]
    assert not np.isnan(out).any()                # every element written
    return out.reshape(b, d)


def _bag_case(n, d, b, n_slots, dtype, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(dtype)
    table[3] = -0.0
    bags = rng.integers(-1, n, (b, n_slots)).astype(np.int32)
    bags[0] = -1
    bags[1] = 3                                   # -0.0 rows, in l order
    return table, bags


# (D, elements a pack): every pack width that divides D, as the kernel
# picks them by D and the pointers' alignment.
WIDTHS = [(d, vec) for d in (1, 2, 3, 10, 64) for vec in (1, 2, 4)
          if d % vec == 0]


class TestTiledBagOrder:
    @pytest.mark.parametrize("l", (1, 3, 8))
    @pytest.mark.parametrize("d,vec", WIDTHS)
    def test_emulation_equals_plain_and_pallas(self, d, vec, l):
        table, bags = _bag_case(60, d, 32 * 8 + 45, l, np.float32,
                                seed=100 * d + l)
        got = emulate_tiled_bag(table, bags, vec)
        plain = gref.gather_rows_bag(torch.from_numpy(table),
                                     torch.from_numpy(bags)).numpy()
        want = np.asarray(ref_gather_kernel.gather_rows_bag(
            jnp.asarray(table), jnp.asarray(bags), interpret=True))
        assert np.array_equal(_bytes(got), _bytes(plain))
        assert np.array_equal(_bytes(got), _bytes(want))

    @pytest.mark.parametrize("d,vec", [(1, 1), (3, 1), (10, 1), (10, 2)])
    def test_float64(self, d, vec):
        table, bags = _bag_case(50, d, 300, 3, np.float64, seed=d)
        got = emulate_tiled_bag(table, bags, vec)
        plain = gref.gather_rows_bag(torch.from_numpy(table),
                                     torch.from_numpy(bags)).numpy()
        with jax.enable_x64(True):
            want = np.asarray(ref_gather_kernel.gather_rows_bag(
                jnp.asarray(table), jnp.asarray(bags), interpret=True))
        assert want.dtype == np.float64
        assert np.array_equal(_bytes(got), _bytes(plain))
        assert np.array_equal(_bytes(got), _bytes(want))
