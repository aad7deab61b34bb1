// The extraction read: kernel B1 (gather_rows), B2 (gather_plan_runs)
// and the serving window's union read with its slices
// (gather_union_slices); and the EmbeddingBag sum of the recsys models:
// kernel B6 (gather_rows_bag).
//
// Replaces the Pallas kernels of the JAX package's
// kernels/gather/kernel.py: gather_rows (line 43; _gather_kernel, the
// pallas_call at line 71: one scalar-prefetched row DMA per grid step),
// gather_rows_bag (_bag_kernel, the pallas_call at line 123: a (B, L)
// grid, one row DMA per bag slot, summed into the bag's output row over
// the sequential L axis) and gather_runs (_runs_kernel, the pallas_call
// at line 181: one block-wide DMA per coalesced-run chunk, into a (C,
// 128) lattice that kernels/gather/ops.py compacts with a second
// gather).  gather_union_slices replaces the JAX service's union read
// (gather_rows over the union) and its per-plan slices (one more
// gather_rows each), which that package runs as 1 + K gathers.
//
// Bound on the H100: bytes.  All are copies with no or one add per
// element read: each output element costs one read of the payload (plus
// its index or its run's descriptor) and one write, so the floor is
// (bytes read + bytes written) / 3.35 TB/s.  For B6 the rows read are
// the distinct ids of the batch: Zipf traffic re-reads hot rows from L2.
// At the extraction read's sizes (10^3-10^5 points) every one of these
// is one launch's latency, so the designs cut launches and dependent
// loads first.
//
// Design.  gather_rows (B1) moves a row as packs of VEC bytes, the
// largest power of two up to 16 that divides the row's bytes and both
// base addresses, chosen on the host (kernels/gather/kernel.py's
// rows_layout; the C entry refuses any other layout).  A row of P packs
// gets a group of g lanes of one warp, the smallest power of two up to
// 32 that covers P (rows.cuh's group_for); lane i of the group moves
// packs i, i + g, ..., so no division is left in the loop, and a row
// wider than 32 packs is looped over by its group.  Each group takes R
// rows (R = 1, 2, 4 or 8, a template parameter; for g = 1, one thread
// takes R rows, the plain extract's 8-byte float64 rows) and issues the
// loads of all R before its first store.  A warp loads its tile's ids
// (32 / g * R rows) once, up to 32 a coalesced load, and passes each to
// its group by __shfl_sync.  The table is read through the read-only
// path.  Measured on an NVIDIA H100 80GB HBM3 at 700 W by device time
// (chip_ablate.py --kernel b1): at two-tower's 1 KB rows, M = 2^20
// (bound 0.642 ms), R = 1, 2, 4, 8 took 0.746, 0.740, 0.737, 0.736 ms
// and index_select 0.725; at the plain extract's read (D = 1 float64, M
// = 174,640; bound 0.00104) 0.0026, 0.0023, 0.0026, 0.0035 ms, where
// index_select took 0.0047 (at 8 rows a thread that call has only 682
// warps).  So R goes by the group (kernel.py's ROWS_PER_GROUP): 2 for a
// lane a row, 8 for 2 lanes, 4 for 4, 2 for 8, 4 for 16 and 32 lanes,
// the best or within 1% of it at each width of chip_smoke.py's sweep,
// which holds a width for every group (64 B rows, 4 lanes: R = 4 took
// 0.4717 ms, the others 0.4753-0.4857; 256 B, 16 lanes: 0.3696 against
// 0.3704-0.3846), but 1000-byte rows: R goes by the group alone, and
// their 8-byte packs take 32 lanes at R = 4, 3-4% behind R = 1
// (0.4519-0.4531 against 0.4354-0.4365, index_select 0.4975-0.4978);
// R is halved while a call would have fewer than 16 warps an SM
// (kernel.py's MIN_WARPS): at two-tower's M = 512, R = 4 gave 128 warps
// and took 0.00271 ms, where index_select took 0.00166 (chip_smoke.py,
// phase 12).  128 or 512 threads a block were within 1% of
// 256, a grid capped at 8 blocks an SM 1-4% slower than 32; at 1 KB
// rows, R = 4, streaming stores (__stcs) took 0.7347 ms and plain loads
// 0.7383 against 0.7366 (the same call), so the stores are plain and
// the loads stay on the read-only path.  A second design, Hopper's
// 1-D bulk copy (a warp a block whose lane 0 kept a ring of 16 rows in
// shared memory, filled by cp.async.bulk loads completed on mbarriers
// and drained by cp.async.bulk stores), took 0.763-0.764 ms at 1 KB
// rows, 0.373-0.388 ms at 512 B-4 KB rows (512 MB of output) and 1.37
// ms at 32 B rows, slower than this kernel at every width, and was
// deleted.  B1 stays 1.5% behind index_select at 1 KB rows (87% of the
// bound); at 8-byte rows both read a whole 32-byte sector a row (2.33-
// 2.41 ms against the 0.40 ms of the bytes asked for).
// gather_plan_runs copies a plan's runs straight into its N
// points, with no lattice and no second gather: the TPU needed a fixed
// 128-element DMA block, the H100 does not.  Its inputs are the runs'
// starts and lengths and the exclusive prefix of the lengths (the
// output offset of each run, int64, computed on the host over the
// runs).  A warp takes one window of RUN_WINDOW output elements, finds
// the run holding the window's first element by a warp-wide search over
// the offsets, and walks the window 32 runs at a time: lane j holds run
// r + j's overlap with the window, an inclusive scan over the lanes
// numbers the elements of the short overlaps, and each lane finds the
// run of each of its elements by a 5-step __shfl_sync search over the
// lanes' prefixes, so that both the reads (within a run) and the writes
// (the window is contiguous) stay coalesced whatever the runs' lengths.
// An overlap of LONG_RUN elements or more is copied by the whole warp
// as 16-byte words where source and destination are congruent mod 16
// (8-byte words where they are congruent mod 8), with element words
// for the head and the tail.  A window bounds every warp's work, so a
// run of a whole field is spread over many warps (a window of 128
// elements was within 3% of 256 at the all-levels plan's 175 K points;
// capping the registers at 64 spilled and was slower).  gather_union_slices
// reads out[j] = flat[union[positions[j]]]: each thread takes
// SLICE_EPT positions and issues all their union loads, then all their
// payload loads, before any store; the union is never materialised,
// and plans that overlap re-read the union's bytes from L2.  Two
// positions a thread, not eight: at a window's ~4 K positions on an
// H100 eight a thread filled 2 blocks and took 3x as long as two a
// thread over 8 blocks (the loads an SM keeps in flight bound it, not
// the chains of a thread); one a thread, or 128-thread blocks, were no
// faster.  All
// addresses are int64_t: an output or payload past 2^31 elements must
// not wrap.  Elements move as opaque 1-, 2-, 4- or 8-byte words, so one
// instantiation serves every dtype of that width.
//
// gather_rows_bag has two kernels, chosen by the wrapper on the row's
// width; both read rows as packs of VEC elements (16-byte loads where D
// and both pointers allow them, else 8 or 4).
// * Wide rows (D * size >= 128 bytes: DLRM's D = 64), gather_rows_bag:
//   each bag gets a group of 8-32 lanes of one warp, the smallest power
//   of two that covers the row (D = 64 float takes 16 lanes of float4).
//   Groups walk the bags in a grid-stride loop.  The lanes of a group
//   load a run of the bag's ids together, one id each, and pass them
//   round with __shfl_sync, so each id is read once per bag (for D up to
//   32 packs; a wider row takes several passes over the columns, each
//   reading the ids again from L1).
// * Narrow rows (D * size < 128 bytes: DeepFM's D = 10 and D = 1),
//   gather_rows_bag_tiled: a row fills only part of a group, and one
//   bag per group leaves one dependent id -> row chain in flight.  So a
//   warp takes a tile of 32 bags (32 * K at one pack a row, K bags a
//   lane), whose output is one contiguous run of packs.  Lane i loads
//   the id of bag i of each slot (one coalesced load a slot), owns packs
//   i, i + 32, ... of the tile (a pack's bag is p / dv, its id comes by
//   __shfl_sync from that bag's lane), starts the row loads of all its
//   packs before the first add, and stores its packs coalesced over the
//   tile.
// In both a -1 slot loads nothing and adds +0.0.  The sum starts at zero
// and adds the slots in l order, in the table's dtype: the Pallas
// kernel's order, so the kernels, the plain version and the Pallas
// kernel agree byte for byte.  float and double only.
#include "common.cuh"
#include "rows.cuh"

// The width, in bytes, below which a row takes the tiled kernel: the
// wrapper's NARROW_ROW_BYTES (kernels/gather/kernel.py).  Each entry
// refuses the rows of the other, so the two cannot disagree unseen.
static constexpr int64_t kNarrowRowBytes = 128;

constexpr unsigned FULL = 0xffffffffu;
// B1's threads a block and its grid's cap in blocks an SM (past it the
// warps stride over the tiles): measured on an H100, see the note at the
// top.
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_BLOCKS_PER_SM = 32;

// One pack of B1: K words of W, VEC = K * sizeof(W) bytes (W is uint32_t
// where K > 1), read through the read-only path: the table does not
// change during the call.
template <typename W, int K>
__device__ __forceinline__ Pack<W, K> load_pack(const Pack<W, K>* p) {
    Pack<W, K> r;
    if constexpr (K == 4) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
        r.v[0] = w.x;
        r.v[1] = w.y;
        r.v[2] = w.z;
        r.v[3] = w.w;
    } else if constexpr (K == 2) {
        const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
        r.v[0] = w.x;
        r.v[1] = w.y;
    } else {
        r.v[0] = __ldg(reinterpret_cast<const W*>(p));
    }
    return r;
}

// out (m, packs) = table (n, packs)[idx], a row of `packs` packs.  A
// group of `group` lanes (a power of two, 1-32) takes R rows of its
// warp's tile of 32 / group * R rows: the warp loads the tile's ids, up
// to 32 a coalesced load, and group q's row k is tile row q + k * (32 /
// group), its id passed from the lane that loaded it.  Lane i of the
// group moves packs i, i + group, ... of each of its R rows, all R loads
// before the first store.
template <typename W, int K, int R>
__global__ void __launch_bounds__(ROWS_THREADS)
gather_rows_kernel(const Pack<W, K>* __restrict__ table, int64_t packs,
                   const int32_t* __restrict__ idx, int64_t m, int group,
                   Pack<W, K>* __restrict__ out) {
    using P = Pack<W, K>;
    const int lane = threadIdx.x & 31;
    const int lig = lane & (group - 1);           // lane within the group
    const int groups = 32 / group;                // groups a warp
    const int q = lane / group;                   // this lane's group
    const int tile = groups * R;                  // rows a warp a step
    const int64_t n_tiles = (m + tile - 1) / tile;
    const int64_t warps = (int64_t)gridDim.x * (ROWS_THREADS / 32);
    for (int64_t t = (int64_t)blockIdx.x * (ROWS_THREADS / 32) +
                     (threadIdx.x >> 5);
         t < n_tiles; t += warps) {               // the whole warp
        const int64_t first = t * tile;
        // Slot s of lane i holds the id of tile row 32 s + i.
        int32_t held[R];
#pragma unroll
        for (int s = 0; s < R; ++s) {
            const int j = 32 * s + lane;
            held[s] = j < tile && first + j < m ? idx[first + j] : 0;
        }
        // This group's rows: their first packs in the table and in the
        // output (-1 for a row past m).
        int64_t src[R], dst[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const int j = q + k * groups;
            int32_t h = held[0];
#pragma unroll
            for (int s = 1; s < R; ++s)
                if ((j >> 5) == s) h = held[s];
            const int32_t id = __shfl_sync(FULL, h, j & 31);
            src[k] = (int64_t)id * packs;
            dst[k] = first + j < m ? (first + j) * packs : -1;
        }
        for (int64_t c = lig; c < packs; c += group) {
            P v[R];
#pragma unroll
            for (int k = 0; k < R; ++k)
                if (dst[k] >= 0) v[k] = load_pack(table + src[k] + c);
#pragma unroll
            for (int k = 0; k < R; ++k)
                if (dst[k] >= 0) out[dst[k] + c] = v[k];
        }
    }
}
// Output elements a warp of gather_plan_runs copies (its window), and
// the elements a lane issues before its stores.  A run's overlap with a
// window of LONG_RUN elements or more is copied by the whole warp in
// 16- or 8-byte words; a shorter one gives each lane elements.
constexpr int RUN_WINDOW = 256;
constexpr int RUN_EPT = 8;
constexpr int LONG_RUN = 64;
// Positions a thread of gather_union_slices reads before its stores
// (measured against 1, 4 and 8: see the note at the top).
constexpr int SLICE_EPT = 2;
// Words of 16 or 8 bytes a lane of a long-run copy loads before storing.
constexpr int SPAN_UNROLL = 4;

// The number of values of sorted v[0, n) at most x, by the whole warp:
// each step cuts [lo, hi) into at most 32 chunks, lane i tests the last
// value of chunk i, and the count of true tests (a prefix: the values
// are sorted) names the chunk that holds the count.  B3's warp_count
// (plan_runs_2d.cu) over int64 values.
__device__ __forceinline__ int64_t warp_count_le(const int64_t* __restrict__ v,
                                                 int64_t n, int64_t x,
                                                 int lane) {
    int64_t lo = 0, hi = n;
    while (hi - lo > 32) {
        const int64_t c = (hi - lo + 31) / 32;
        const int64_t e = lo + (lane + 1) * c - 1;
        const bool t = e < hi && v[e] <= x;
        lo += c * __popc(__ballot_sync(FULL, t));
        hi = lo + c < hi ? lo + c : hi;
    }
    const int64_t i = lo + lane;
    return lo + __popc(__ballot_sync(FULL, i < hi && v[i] <= x));
}

// dst[0, n) = src[0, n) by the 32 lanes of a warp, the aligned interior
// as words of V: src and dst must be congruent mod sizeof(V).  The head
// (elements until dst is V-aligned) and the tail move as elements.
template <typename W, typename V>
__device__ __forceinline__ void copy_words(const W* __restrict__ src,
                                           W* __restrict__ dst, int64_t n,
                                           int lane) {
    constexpr int PER = sizeof(V) / sizeof(W);
    const uintptr_t mis = reinterpret_cast<uintptr_t>(dst) % sizeof(V);
    int64_t head = (int64_t)((sizeof(V) - mis) % sizeof(V) / sizeof(W));
    head = head < n ? head : n;
    for (int64_t j = lane; j < head; j += 32) dst[j] = src[j];
    const int64_t nv = (n - head) / PER;
    const V* vs = reinterpret_cast<const V*>(src + head);
    V* vd = reinterpret_cast<V*>(dst + head);
    for (int64_t j0 = 0; j0 < nv; j0 += 32 * SPAN_UNROLL) {
        V w[SPAN_UNROLL];
#pragma unroll
        for (int u = 0; u < SPAN_UNROLL; ++u) {
            const int64_t j = j0 + u * 32 + lane;
            if (j < nv) w[u] = vs[j];
        }
#pragma unroll
        for (int u = 0; u < SPAN_UNROLL; ++u) {
            const int64_t j = j0 + u * 32 + lane;
            if (j < nv) vd[j] = w[u];
        }
    }
    for (int64_t j = head + nv * PER + lane; j < n; j += 32) dst[j] = src[j];
}

// One long overlap, copied by the whole warp in the widest words that
// its source and destination addresses allow.
template <typename W>
__device__ __forceinline__ void copy_span(const W* __restrict__ src,
                                          W* __restrict__ dst, int64_t n,
                                          int lane) {
    const uintptr_t diff = reinterpret_cast<uintptr_t>(src) ^
                           reinterpret_cast<uintptr_t>(dst);
    if ((diff & 15) == 0) {
        copy_words<W, uint4>(src, dst, n, lane);
    } else if (sizeof(W) < 8 && (diff & 7) == 0) {
        copy_words<W, uint2>(src, dst, n, lane);
    } else {
        copy_words<W, W>(src, dst, n, lane);
    }
}

// out[offsets[r] + k] = flat[starts[r] + k] for k < lengths[r]; offsets
// is the exclusive prefix of lengths, offsets[R] = n_points.  One warp a
// window of RUN_WINDOW output elements.
template <typename W>
__global__ void __launch_bounds__(256)
gather_plan_runs_kernel(const W* __restrict__ flat,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ lengths,
                        const int64_t* __restrict__ offsets, int64_t n_runs,
                        int64_t n_points, W* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t w0 =
        (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * RUN_WINDOW;
    if (w0 >= n_points) return;                       // the whole warp
    const int64_t w1 = w0 + RUN_WINDOW < n_points ? w0 + RUN_WINDOW
                                                  : n_points;
    // The run holding w0: the last r with offsets[r] <= w0 (an empty run
    // shares its offset with the next, which the count then names).
    int64_t r = warp_count_le(offsets, n_runs + 1, w0, lane) - 1;
    int64_t pos = w0;
    while (pos < w1) {                                // the whole warp
        // Lane j: run r + j's overlap [lo, hi) with [pos, w1).
        const int64_t rr = r + lane;
        const bool live = rr < n_runs;
        const int64_t o = live ? offsets[rr] : n_points;
        const int64_t len = live ? (int64_t)lengths[rr] : 0;
        const int64_t src0 = live ? (int64_t)starts[rr] : 0;
        const int64_t lo = o > pos ? o : pos;
        const int64_t hi = o + len < w1 ? o + len : w1;
        const int ov = hi > lo ? (int)(hi - lo) : 0;
        const bool is_long = ov >= LONG_RUN;
        // The short overlaps' elements, numbered by an inclusive scan.
        const int mine = is_long ? 0 : ov;
        int inc = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += up;
        }
        const int excl = inc - mine;
        const int total = __shfl_sync(FULL, inc, 31);
        // Element e of lane k's overlap reads src_at + e, writes dst_at + e.
        const int64_t src_at = src0 + (lo - o) - excl;
        const int64_t dst_at = lo - excl;
        for (int base = 0; base < total; base += 32 * RUN_EPT) {
            W v[RUN_EPT];
            int64_t at[RUN_EPT];
#pragma unroll
            for (int i = 0; i < RUN_EPT; ++i) {
                const int e = base + i * 32 + lane;
                // The last lane k with excl_k <= e: the overlap holding e.
                int k = 0;
#pragma unroll
                for (int step = 16; step; step >>= 1) {
                    if (__shfl_sync(FULL, excl, k + step) <= e) k += step;
                }
                const int64_t s = __shfl_sync(FULL, src_at, k);
                const int64_t d = __shfl_sync(FULL, dst_at, k);
                at[i] = e < total ? d + e : -1;
                if (e < total) v[i] = flat[s + e];
            }
#pragma unroll
            for (int i = 0; i < RUN_EPT; ++i)
                if (at[i] >= 0) out[at[i]] = v[i];
        }
        // The long overlaps, one at a time, by the whole warp.
        unsigned longs = __ballot_sync(FULL, is_long);
        while (longs) {
            const int k = __ffs(longs) - 1;
            longs &= longs - 1;
            const int64_t s = __shfl_sync(FULL, src0 + (lo - o), k);
            const int64_t d = __shfl_sync(FULL, lo, k);
            const int n = __shfl_sync(FULL, ov, k);
            copy_span(flat + s, out + d, n, lane);
        }
        // These 32 runs cover [pos, hi of lane 31): runs are contiguous
        // in the output; a lane past the last run has reached w1.
        pos = __shfl_sync(FULL, live ? hi : w1, 31);
        r += 32;
    }
}

// out[j] = flat[uni[pos[j]]]: each thread reads SLICE_EPT positions, then
// their union entries, then their payload elements, then stores.
template <typename W>
__global__ void __launch_bounds__(256)
gather_union_slices_kernel(const W* __restrict__ flat,
                           const int32_t* __restrict__ uni,
                           const int32_t* __restrict__ pos, int64_t p,
                           W* __restrict__ out) {
    const int64_t tile = (int64_t)blockDim.x * SLICE_EPT;
    for (int64_t b = (int64_t)blockIdx.x * tile; b < p;
         b += (int64_t)gridDim.x * tile) {
        int32_t q[SLICE_EPT];
        W v[SLICE_EPT];
#pragma unroll
        for (int i = 0; i < SLICE_EPT; ++i) {
            const int64_t j = b + (int64_t)i * blockDim.x + threadIdx.x;
            q[i] = j < p ? pos[j] : 0;
        }
#pragma unroll
        for (int i = 0; i < SLICE_EPT; ++i) {
            const int64_t j = b + (int64_t)i * blockDim.x + threadIdx.x;
            q[i] = j < p ? uni[q[i]] : 0;
        }
#pragma unroll
        for (int i = 0; i < SLICE_EPT; ++i) {
            const int64_t j = b + (int64_t)i * blockDim.x + threadIdx.x;
            if (j < p) v[i] = flat[(int64_t)q[i]];
        }
#pragma unroll
        for (int i = 0; i < SLICE_EPT; ++i) {
            const int64_t j = b + (int64_t)i * blockDim.x + threadIdx.x;
            if (j < p) out[j] = v[i];
        }
    }
}

template <typename T, int VEC>
__global__ void gather_rows_bag_kernel(const T* __restrict__ table,
                                       int64_t d,
                                       const int32_t* __restrict__ bags,
                                       int64_t b, int64_t l, int group,
                                       T* __restrict__ out) {
    using P = Pack<T, VEC>;
    const int g = threadIdx.x & (group - 1);      // lane within the group
    const unsigned mask = group_mask(group);
    const int64_t per_block = blockDim.x / group;
    const int64_t stride = (int64_t)gridDim.x * per_block;
    const int64_t dv = d / VEC;                   // packs per row
    for (int64_t bag = (int64_t)blockIdx.x * per_block + threadIdx.x / group;
         bag < b; bag += stride) {
        const int32_t* ids = bags + bag * l;
        P* orow = reinterpret_cast<P*>(out + bag * d);
        for (int64_t c0 = 0; c0 < dv; c0 += group) {
            const int64_t c = c0 + g;
            const bool mine = c < dv;
            P acc;
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc.v[j] = T(0);
            for (int64_t s0 = 0; s0 < l; s0 += group) {
                const int32_t held = s0 + g < l ? ids[s0 + g] : -1;
                const int n = (int)(l - s0 < group ? l - s0 : group);
                for (int k = 0; k < n; ++k) {
                    const int32_t id = __shfl_sync(mask, held, k, group);
                    P row;
                    if (mine && id >= 0) {
                        row = reinterpret_cast<const P*>(
                            table + (int64_t)id * d)[c];
                    } else {
#pragma unroll
                        for (int j = 0; j < VEC; ++j) row.v[j] = T(0);
                    }
#pragma unroll
                    for (int j = 0; j < VEC; ++j)
                        acc.v[j] = acc.v[j] + row.v[j];
                }
            }
            if (mine) orow[c] = acc;
        }
    }
}

// Narrow rows: a warp per tile of 32 * K bags.  K > 1 only at one pack a
// row (dv == 1), where lane i owns bags i, i + 32, ... of the tile and
// needs no shuffle; else K == 1 and lane i owns the tile's packs i, i +
// 32, ..., dv of them.  MAXP >= the packs a lane owns (a power of two,
// so the unrolled loops are few; MAXP * VEC * size <= 128 bytes).  Up to
// 8 packs and 64 bytes a lane (DeepFM's D = 10 and D = 1), the registers
// are held to 64 a thread, so that 32 warps an SM keep their row loads
// in flight; held so at 16 packs of one float, ptxas spilled.
template <typename T, int VEC, int K, int MAXP>
__global__ void __launch_bounds__(
    256, MAXP <= 8 && MAXP * VEC * sizeof(T) <= 64 ? 4 : 1)
gather_rows_bag_tiled_kernel(const T* __restrict__ table, int64_t d,
                             const int32_t* __restrict__ bags, int64_t b,
                             int64_t l, T* __restrict__ out) {
    using P = Pack<T, VEC>;
    constexpr int TILE = 32 * K;
    const int lane = threadIdx.x & 31;
    const int dv = (int)(d / VEC);                // packs per row
    const int np = K > 1 ? K : dv;                // packs this lane owns
    // Pack lane + 32 j lies in bag (of the tile) bag0 + j * q + carry and
    // column col0 + j * r - carry * dv: 32 = q * dv + r.
    const int q = 32 / dv, r = 32 % dv;
    const int64_t n_tiles = (b + TILE - 1) / TILE;
    const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
    for (int64_t tile = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
         tile < n_tiles; tile += warps) {
        const int64_t first = tile * TILE;
        P acc[MAXP];
#pragma unroll
        for (int j = 0; j < MAXP; ++j)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j].v[e] = T(0);
        for (int64_t s = 0; s < l; ++s) {
            int32_t held[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const int64_t bag = first + 32 * k + lane;
                held[k] = bag < b ? bags[bag * l + s] : -1;
            }
            P row[MAXP];
            int bag = lane / dv, col = lane % dv;
#pragma unroll
            for (int j = 0; j < MAXP; ++j) {
                if (j >= np) break;
                const int32_t id = K > 1 ? held[j]
                                         : __shfl_sync(0xffffffffu, held[0],
                                                       bag);
                if (id >= 0) {
                    row[j] = reinterpret_cast<const P*>(
                        table + (int64_t)id * d)[K > 1 ? 0 : col];
                } else {
#pragma unroll
                    for (int e = 0; e < VEC; ++e) row[j].v[e] = T(0);
                }
                bag += q;
                col += r;
                if (col >= dv) {
                    col -= dv;
                    ++bag;
                }
            }
#pragma unroll
            for (int j = 0; j < MAXP; ++j) {
                if (j >= np) break;
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    acc[j].v[e] = acc[j].v[e] + row[j].v[e];
            }
        }
        // The tile's output is packs [first * dv, (first + TILE) * dv).
        P* o = reinterpret_cast<P*>(out) + first * dv;
        const int64_t live = (b - first < TILE ? b - first : TILE) * dv;
#pragma unroll
        for (int j = 0; j < MAXP; ++j) {
            if (j >= np) break;
            const int p = lane + 32 * j;
            if (p < live) o[p] = acc[j];
        }
    }
}

template <typename W, int K, int R>
static void launch_rows(const void* table, int64_t packs, const void* idx,
                        int64_t m, int group, void* out, cudaStream_t s) {
    const int64_t tile = 32 / group * R;
    const int64_t warps = (m + tile - 1) / tile;
    const int64_t want = (warps + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32);
    const int64_t cap = 132 * ROWS_BLOCKS_PER_SM;
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    gather_rows_kernel<W, K, R><<<blocks, ROWS_THREADS, 0, s>>>(
        static_cast<const Pack<W, K>*>(table), packs,
        static_cast<const int32_t*>(idx), m, group,
        static_cast<Pack<W, K>*>(out));
}

template <typename W, int K>
static int launch_rows_r(const void* table, int64_t packs, const void* idx,
                         int64_t m, int group, int rows_per_group, void* out,
                         cudaStream_t s) {
    switch (rows_per_group) {
        case 1: launch_rows<W, K, 1>(table, packs, idx, m, group, out, s);
                break;
        case 2: launch_rows<W, K, 2>(table, packs, idx, m, group, out, s);
                break;
        case 4: launch_rows<W, K, 4>(table, packs, idx, m, group, out, s);
                break;
        case 8: launch_rows<W, K, 8>(table, packs, idx, m, group, out, s);
                break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}

template <typename W>
static void launch_plan_runs(const void* flat, const void* starts,
                             const void* lengths, const void* offsets,
                             int64_t n_runs, int64_t n_points, void* out,
                             cudaStream_t s) {
    const int threads = 256;
    const int64_t warps = (n_points + RUN_WINDOW - 1) / RUN_WINDOW;
    const unsigned blocks = (unsigned)((warps + threads / 32 - 1) /
                                       (threads / 32));
    gather_plan_runs_kernel<W><<<blocks, threads, 0, s>>>(
        static_cast<const W*>(flat), static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(lengths),
        static_cast<const int64_t*>(offsets), n_runs, n_points,
        static_cast<W*>(out));
}

template <typename W>
static void launch_slices(const void* flat, const void* uni,
                          const void* pos, int64_t p, void* out,
                          cudaStream_t s) {
    const int threads = 256;
    const int64_t want = (p + threads * SLICE_EPT - 1) / (threads * SLICE_EPT);
    const int64_t cap = 132 * 16;  // grid-stride past 16 blocks per SM
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    gather_union_slices_kernel<W><<<blocks, threads, 0, s>>>(
        static_cast<const W*>(flat), static_cast<const int32_t*>(uni),
        static_cast<const int32_t*>(pos), p, static_cast<W*>(out));
}

template <typename T, int VEC>
static void launch_bag(const void* table, int64_t d, const void* bags,
                       int64_t b, int64_t l, void* out, cudaStream_t s) {
    const int group = group_for(d / VEC);
    const int threads = 256;
    const int64_t per_block = threads / group;
    const int64_t want = (b + per_block - 1) / per_block;
    const int64_t cap = 132 * 32;  // grid-stride past 32 blocks per SM
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    gather_rows_bag_kernel<T, VEC><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(table), d, static_cast<const int32_t*>(bags),
        b, l, group, static_cast<T*>(out));
}

template <typename T, int VEC, int K, int MAXP>
static void launch_tiled(const void* table, int64_t d, const void* bags,
                         int64_t b, int64_t l, void* out, cudaStream_t s) {
    const int threads = 256;
    const int64_t tiles = (b + 32 * K - 1) / (32 * K);
    const int64_t want = (tiles + threads / 32 - 1) / (threads / 32);
    const int64_t cap = 132 * 32;  // grid-stride past 32 blocks per SM
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    gather_rows_bag_tiled_kernel<T, VEC, K, MAXP><<<blocks, threads, 0, s>>>(
        static_cast<const T*>(table), d, static_cast<const int32_t*>(bags),
        b, l, static_cast<T*>(out));
}

// The smallest MAXP that holds the dv packs a lane owns; dv * VEC * size
// < kNarrowRowBytes, so MAXP * VEC * size <= kNarrowRowBytes.
template <typename T, int VEC>
static void launch_narrow(const void* table, int64_t d, const void* bags,
                          int64_t b, int64_t l, void* out, cudaStream_t s) {
    constexpr int MAXP = (int)kNarrowRowBytes / (VEC * (int)sizeof(T));
    const int64_t dv = d / VEC;
    if (dv == 1)
        launch_tiled<T, VEC, 8, 8>(table, d, bags, b, l, out, s);
    else if (dv <= 4)
        launch_tiled<T, VEC, 1, 4>(table, d, bags, b, l, out, s);
    else if (dv <= 8 || MAXP <= 8)
        launch_tiled<T, VEC, 1, (MAXP < 8 ? MAXP : 8)>(table, d, bags, b, l,
                                                      out, s);
    else if (dv <= 16 || MAXP <= 16)
        launch_tiled<T, VEC, 1, (MAXP < 16 ? MAXP : 16)>(table, d, bags, b,
                                                        l, out, s);
    else
        launch_tiled<T, VEC, 1, MAXP>(table, d, bags, b, l, out, s);
}

// The widest pack B1 may move a row in: the largest power of two, up to
// 16 bytes, that divides the row's bytes and both addresses
// (kernels/gather/kernel.py's rows_layout holds the same rule).
static int widest_pack(int64_t row_bytes, const void* table,
                       const void* out) {
    int vec = 16;
    while (vec > 1 && (row_bytes % vec != 0 || !aligned(table, vec) ||
                       !aligned(out, vec)))
        vec >>= 1;
    return vec;
}

// out (m, d) = table (n, d)[idx (m,)]; elem_bytes is the dtype's width.
// The layout is the wrapper's (rows_layout): rows in packs of vec_bytes,
// a group of `group` lanes a row, rows_per_group rows a group.  A layout
// other than the rule's (the widest pack, group_for of the row's packs,
// 1, 2, 4 or 8 rows) is refused, so the two sides cannot disagree unseen.
extern "C" int polytope_gather_rows(int device, const void* table, int64_t d,
                                    const void* idx, int64_t m,
                                    int elem_bytes, int vec_bytes, int group,
                                    int rows_per_group, void* out,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 &&
        elem_bytes != 8)
        return (int)cudaErrorInvalidValue;
    const int64_t row_bytes = d * elem_bytes;
    if (vec_bytes != widest_pack(row_bytes, table, out))
        return (int)cudaErrorInvalidValue;
    const int64_t packs = row_bytes / vec_bytes;
    if (group != group_for(packs)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int r = rows_per_group;
    switch (vec_bytes) {
        case 16: return launch_rows_r<uint32_t, 4>(table, packs, idx, m,
                                                   group, r, out, s);
        case 8: return launch_rows_r<uint32_t, 2>(table, packs, idx, m,
                                                  group, r, out, s);
        case 4: return launch_rows_r<uint32_t, 1>(table, packs, idx, m,
                                                  group, r, out, s);
        case 2: return launch_rows_r<uint16_t, 1>(table, packs, idx, m,
                                                  group, r, out, s);
        default: return launch_rows_r<uint8_t, 1>(table, packs, idx, m,
                                                  group, r, out, s);
    }
}

// out (n_points,): run r's lengths[r] elements from flat[starts[r]] at
// out[offsets[r]]; offsets (n_runs + 1,) int64 is the exclusive prefix of
// the lengths.
extern "C" int polytope_gather_plan_runs(int device, const void* flat,
                                         const void* starts,
                                         const void* lengths,
                                         const void* offsets, int64_t n_runs,
                                         int64_t n_points, int elem_bytes,
                                         void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (elem_bytes) {
        case 1: launch_plan_runs<uint8_t>(flat, starts, lengths, offsets,
                                          n_runs, n_points, out, s);
                break;
        case 2: launch_plan_runs<uint16_t>(flat, starts, lengths, offsets,
                                           n_runs, n_points, out, s);
                break;
        case 4: launch_plan_runs<uint32_t>(flat, starts, lengths, offsets,
                                           n_runs, n_points, out, s);
                break;
        case 8: launch_plan_runs<uint64_t>(flat, starts, lengths, offsets,
                                           n_runs, n_points, out, s);
                break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}

// out (p,): out[j] = flat[uni[pos[j]]].
extern "C" int polytope_gather_union_slices(int device, const void* flat,
                                            const void* uni, const void* pos,
                                            int64_t p, int elem_bytes,
                                            void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (elem_bytes) {
        case 1: launch_slices<uint8_t>(flat, uni, pos, p, out, s); break;
        case 2: launch_slices<uint16_t>(flat, uni, pos, p, out, s); break;
        case 4: launch_slices<uint32_t>(flat, uni, pos, p, out, s); break;
        case 8: launch_slices<uint64_t>(flat, uni, pos, p, out, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}

// out (b, d): out[i] = sum over k < l of table[bags[i, k]], with -1
// slots adding zero; elem_bytes 4 is float, 8 double.  Wide rows only
// (d * elem_bytes >= kNarrowRowBytes), so a group is 8-32 lanes.
extern "C" int polytope_gather_rows_bag(int device, const void* table,
                                        int64_t d, const void* bags,
                                        int64_t b, int64_t l, int elem_bytes,
                                        void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (d * elem_bytes < kNarrowRowBytes) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool a16 = aligned(table, 16) && aligned(out, 16);
    const bool a8 = aligned(table, 8) && aligned(out, 8);
    switch (elem_bytes) {
        case 4:
            if (d % 4 == 0 && a16)
                launch_bag<float, 4>(table, d, bags, b, l, out, s);
            else if (d % 2 == 0 && a8)
                launch_bag<float, 2>(table, d, bags, b, l, out, s);
            else
                launch_bag<float, 1>(table, d, bags, b, l, out, s);
            break;
        case 8:
            if (d % 2 == 0 && a16)
                launch_bag<double, 2>(table, d, bags, b, l, out, s);
            else
                launch_bag<double, 1>(table, d, bags, b, l, out, s);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}

// The same for narrow rows (d * elem_bytes < kNarrowRowBytes), by the
// tiled kernel.
extern "C" int polytope_gather_rows_bag_tiled(int device, const void* table,
                                              int64_t d, const void* bags,
                                              int64_t b, int64_t l,
                                              int elem_bytes, void* out,
                                              void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (d * elem_bytes >= kNarrowRowBytes) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool a16 = aligned(table, 16) && aligned(out, 16);
    const bool a8 = aligned(table, 8) && aligned(out, 8);
    switch (elem_bytes) {
        case 4:
            if (d % 4 == 0 && a16)
                launch_narrow<float, 4>(table, d, bags, b, l, out, s);
            else if (d % 2 == 0 && a8)
                launch_narrow<float, 2>(table, d, bags, b, l, out, s);
            else
                launch_narrow<float, 1>(table, d, bags, b, l, out, s);
            break;
        case 8:
            if (d % 2 == 0 && a16)
                launch_narrow<double, 2>(table, d, bags, b, l, out, s);
            else
                launch_narrow<double, 1>(table, d, bags, b, l, out, s);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}
