"""B1's layout and work order on the CPU, and its entry points against the
JAX package.

* ``kernel.rows_layout``: the pack width, the group of lanes and the rows
  a group takes, chosen on the host from the row's bytes, the number of
  rows and the two addresses (``csrc/gather.cu``'s
  ``polytope_gather_rows`` refuses another pack or group).
* A numpy emulation of ``gather_rows_kernel``'s order: a warp's tile of
  32 / group * R rows, its ids loaded 32 a slot and passed to the groups
  by lane and slot, lane i of a group moving packs i, i + group, ... of
  its R rows.  Every output pack is written exactly once, from the right
  table pack.
* ``ops.gather_rows`` and ``ops.gather_plan_rows`` (the plain version on
  a CPU tensor) byte-equal to the JAX ``ref.gather_rows`` and to the
  Pallas ``gather_rows`` in interpret mode, on wide rows and on a
  payload view one element off 16-byte alignment.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.gather import kernel as ref_gather_kernel  # noqa: E402
from repro.kernels.gather import ops as ref_gather_ops  # noqa: E402
from repro.kernels.gather import ref as ref_gather  # noqa: E402

from repro_torch.kernels.gather import kernel as gk  # noqa: E402
from repro_torch.kernels.gather import ops as gops  # noqa: E402


# (d, element bytes, table address, output address) -> (vec, group).
LAYOUT_CASES = [
    ((1, 8, 0, 0), (8, 1)),            # the plain extract's float64 read
    ((256, 4, 0, 512), (16, 32)),      # two-tower's 1 KB rows
    ((256, 4, 4, 512), (4, 32)),       # the same table 4 bytes off
    ((256, 4, 0, 8), (8, 32)),         # an output 8 bytes off
    ((250, 4, 0, 0), (8, 32)),         # 1000-byte rows
    ((3, 1, 0, 0), (1, 4)),            # 3-byte rows
    ((2, 4, 0, 0), (8, 1)),
    ((8, 4, 0, 0), (16, 2)),
    ((32, 4, 0, 0), (16, 8)),
    ((128, 4, 0, 0), (16, 32)),
    ((1024, 4, 0, 0), (16, 32)),
    ((7, 2, 0, 0), (2, 8)),
    ((7, 2, 2, 0), (2, 8)),
    ((16, 1, 1, 0), (1, 16)),
    ((1, 1, 0, 0), (1, 1)),
    ((64, 8, 8, 16), (8, 32)),
]


@pytest.mark.parametrize("args,want", LAYOUT_CASES)
def test_rows_layout(args, want):
    d, size, tp, op = args
    vec, group, rows = gk.rows_layout(d, size, 1 << 20, tp, op)
    assert (vec, group) == want
    assert rows == gk.ROWS_PER_GROUP[group]
    assert rows in (1, 2, 4, 8)
    assert (d * size) % vec == 0 and tp % vec == 0 and op % vec == 0
    # The widest: twice as wide (up to 16) would not divide all three.
    if vec < 16:
        assert (d * size) % (2 * vec) or tp % (2 * vec) or op % (2 * vec)


# (d, element bytes, m) -> rows a group: halved while the call would give
# fewer than MIN_WARPS warps.
SMALL_M_CASES = [
    ((256, 4, 1 << 20), 4),            # two-tower's retrieval_cand
    ((256, 4, 8448), 4),               # 2112 warps at 4 rows
    ((256, 4, 8440), 2),               # 2110 at 4, 4220 at 2
    ((256, 4, 512), 1),                # two-tower's serve_p99
    ((1, 8, 174_640), 2),              # the plain extract's read
    ((1, 8, 100_000), 1),
    ((8, 4, 1), 1),
]


@pytest.mark.parametrize("args,want", SMALL_M_CASES)
def test_rows_per_group_at_small_m(args, want):
    d, size, m = args
    vec, group, rows = gk.rows_layout(d, size, m, 0, 0)
    assert rows == want
    warps = -(-m * group // (32 * rows))
    assert rows == 1 or warps >= gk.MIN_WARPS


@pytest.mark.parametrize("packs,group", [(1, 1), (2, 2), (3, 4), (5, 8),
                                         (16, 16), (17, 32), (32, 32),
                                         (64, 32), (125, 32)])
def test_group_for(packs, group):
    assert gk.group_for(packs) == group


def emulate_rows_kernel(table: np.ndarray, idx: np.ndarray, vec: int,
                        group: int, rows: int) -> np.ndarray:
    """``gather_rows_kernel``'s work order in numpy over a (n, row_bytes)
    uint8 table: returns the output and asserts that each output pack is
    written once."""
    n, row_bytes = table.shape
    packs = row_bytes // vec
    tbl = table.reshape(n * packs, vec)
    m = idx.size
    out = np.zeros((m * packs, vec), np.uint8)
    writes = np.zeros(m * packs, np.int64)
    groups = 32 // group
    tile = groups * rows
    lanes = np.arange(32)
    for t in range(-(-m // tile)):               # each warp's tile
        first = t * tile
        held = np.zeros((rows, 32), np.int64)
        for s in range(rows):
            j = 32 * s + lanes
            live = (j < tile) & (first + j < m)
            held[s, live] = idx[first + j[live]]
        for lane in range(32):
            lig, q = lane & (group - 1), lane // group
            for k in range(rows):
                j = q + k * groups
                row = first + j
                if row >= m:
                    continue
                src = held[j >> 5, j & 31] * packs
                for c in range(lig, packs, group):
                    out[row * packs + c] = tbl[src + c]
                    writes[row * packs + c] += 1
    assert (writes == 1).all()
    return out.reshape(m, row_bytes)


@pytest.mark.parametrize("row_bytes,vec", [(8, 8), (3, 1), (32, 16),
                                           (1000, 8), (1024, 16),
                                           (4096, 16), (14, 2)])
@pytest.mark.parametrize("m", (1, 31, 33, 261))
def test_work_order_writes_each_pack_once(row_bytes, vec, m):
    rng = np.random.default_rng(row_bytes * 1000 + m)
    n = 53
    table = rng.integers(0, 256, (n, row_bytes), dtype=np.uint8)
    idx = rng.integers(0, n, m)
    idx[0], idx[-1] = n - 1, 0
    group = gk.group_for(row_bytes // vec)
    for rows in (1, 2, 4, 8):
        got = emulate_rows_kernel(table, idx, vec, group, rows)
        np.testing.assert_array_equal(got, table[idx])


@pytest.mark.parametrize("d", (16, 250, 256))
@pytest.mark.parametrize("dtype", (np.float32, np.int16, np.uint8,
                                   np.float64))
def test_gather_rows_equals_jax(d, dtype):
    rng = np.random.default_rng(d)
    table = (rng.normal(size=(40, d)) * 100).astype(dtype)
    idx = rng.integers(0, 40, 37)
    idx[0], idx[-1] = 39, 0
    got = gops.gather_rows(torch.from_numpy(table), idx).numpy()
    with jax.enable_x64(True):
        want = np.asarray(ref_gather.gather_rows(jnp.asarray(table), idx))
        pallas = np.asarray(ref_gather_kernel.gather_rows(
            jnp.asarray(table), idx, interpret=True))
    assert got.dtype == want.dtype == pallas.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("d", (16, 250, 256))
@pytest.mark.parametrize("shift", (0, 1))
def test_gather_plan_rows_on_a_view_equals_jax(d, shift):
    """``gather_plan_rows`` on a flat payload and on its view one element
    in (a table whose rows start 4 bytes off 16-byte alignment): equal to
    the JAX ``gather_plan_rows`` through its jnp path and its Pallas
    kernel (interpret mode)."""
    rng = np.random.default_rng(100 + d)
    big = rng.normal(size=41 * d + 1).astype(np.float32)
    flat = big[shift:shift + 40 * d + 3]            # a ragged tail
    offsets = rng.integers(0, 40, 29) * d
    view = torch.from_numpy(big)[shift:shift + 40 * d + 3]
    got = gops.gather_plan_rows(view, offsets, d).numpy()
    want = np.asarray(ref_gather_ops.gather_plan_rows(jnp.asarray(flat),
                                                      offsets, d))
    pallas = np.asarray(ref_gather_ops.gather_plan_rows(
        jnp.asarray(flat), offsets, d, use_pallas=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, flat[:40 * d].reshape(40, d)
                                  [offsets // d])
