// B3 plan_runs_2d: the trailing-2-D stage of Algorithm 1 on the card.
//
// Replaces the Pallas kernel of the JAX package's kernels/plan/kernel.py
// (plan_runs_2d / _plan_kernel, the pallas_call at line 86; its per-job
// math is row_slots_2d in kernels/plan/ref.py, lines 65-143).  Per job
// (one leading-axis path x one 2-D polytope): find the candidate rows on
// the major axis, slice the polytope at each row (slice_extents.cuh),
// turn the kept-coordinate extents into column ranges on the minor axis
// (two segments when the range wraps a cyclic seam), and emit
// (run_start, run_length) pairs compacted in (job, row, segment) order,
// plus meta = [n_runs, n_rows, n_points].
//
// Bound on the H100: neither bytes nor operations at the main path's
// sizes.  A few thousand jobs of a few dozen rows move well under a
// megabyte and do a few million float64 operations, so the latency of
// one launch and of the dependent searches inside a job is what is left.
//
// Design.  The TPU kernel walks the jobs as a sequential grid and
// carries a meta[0] cursor from step to step, appending each job's runs
// at the cursor.  CUDA blocks run in no order, so the cursor becomes a
// single-pass scan over jobs with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), in one launch:
//   * one warp per job, PLAN_WARPS jobs per CTA (a tile).  The lanes
//     split the job's vertices and combine the major-axis extents by
//     shuffle (min and max do not depend on the order of visits), then
//     find the row range by two warp-wide searches.  Lane i then slices
//     rows i, i + 32, ... and gets up to two slots per row;
//   * in-job order: __ballot_sync and __popc give each live slot its
//     rank in (row, segment) order and the job's run count; warp sums
//     give its row and point counts, which each CTA adds to meta once
//     (integer sums do not depend on order);
//   * across jobs: a CTA takes its tile index from an atomic ticket (so
//     a tile never waits on one that has not started), publishes its run
//     count as a 64-bit (flag, value) descriptor, looks back over its
//     predecessors' descriptors for its exclusive prefix (a warp reads
//     32 of them a step) and publishes its inclusive prefix; the last
//     tile writes meta[0];
//   * each warp then writes its live runs straight to their final
//     positions.  The first PLAN_KEEP 32-row steps of a job stay in
//     registers between the count and the write; a job with more rows
//     slices those again for the write, with the same arithmetic.
// The entry point zeroes the output, meta, the ticket and the
// descriptors with one cudaMemsetAsync before the launch, on the same
// stream, so every position at or past n_runs reads 0.
// The comparison counts of the reference (# of axis values < x) become
// searches: the axis values are sorted, so the counts are equal.  A row's
// searches on the minor axis run in lockstep on its lane.
// Templated on float and double; the default path is double.
//
// Exactness: compiled with --fmad=false, so lo1 - m * period and the
// slicing core's interpolation round exactly as the float64 host
// planner does.  Offsets are int64_t until they are stored: every run
// start is the offset of a real element of a cube the caller has
// checked to hold fewer than 2^31 elements, so it fits the int32 output.
#include "common.cuh"
#include "slice_extents.cuh"

enum { EPS0 = 0, EPS1 = 1, PLANE_TOL_REL = 2, PERIOD = 3 };

constexpr int PLAN_WARPS = 4;       // jobs per tile (one CTA)
// 32-row steps kept in registers between the count and the write.  One
// step holds the kernel to 68 registers in float64, so 7 CTAs fit an SM
// and the all-levels request's 888 tiles run in one wave (two steps
// took 73 registers, 6 CTAs an SM, and 17 us where one takes 12).
constexpr int PLAN_KEEP = 1;
constexpr unsigned FULL = 0xffffffffu;
// A tile descriptor's flag, in its high 32 bits (0: not yet published).
constexpr unsigned TILE_AGGREGATE = 1, TILE_PREFIX = 2;

// The number of values of sorted sv[0, n) below x (LE false) or at most x
// (LE true), the reference's comparison count, by the whole warp: each step
// cuts [lo, hi) into at most 32 chunks, lane i tests the last value of
// chunk i, and the count of true tests (a prefix: the values are sorted)
// names the chunk that holds the count; a last step tests one value a
// lane.  Two dependent loads for n up to 1024, where a binary search
// takes ten.
template <bool LE, typename T>
__device__ __forceinline__ int warp_count(const T* __restrict__ sv, int n,
                                          T x, int lane) {
    int lo = 0, hi = n;
    while (hi - lo > 32) {
        const int c = (hi - lo + 31) / 32;
        const int e = lo + (lane + 1) * c - 1;
        const bool t = e < hi && (LE ? sv[e] <= x : sv[e] < x);
        lo += c * __popc(__ballot_sync(FULL, t));
        hi = lo + c < hi ? lo + c : hi;
    }
    const int i = lo + lane;
    const bool t = i < hi && (LE ? sv[i] <= x : sv[i] < x);
    return lo + __popc(__ballot_sync(FULL, t));
}

// The counts of sorted sv[0, n) below a, at most b and at most c, by one
// lane: three binary searches in lockstep, so that each step's three
// loads are in flight together.
struct Counts3 {
    int lt_a, le_b, le_c;
};

template <typename T>
__device__ __forceinline__ Counts3 counts3(const T* __restrict__ sv, int n,
                                           T a, T b, T c) {
    int lo_a = 0, hi_a = n, lo_b = 0, hi_b = n, lo_c = 0, hi_c = n;
    while (lo_a < hi_a || lo_b < hi_b || lo_c < hi_c) {
        const int mid_a = (lo_a + hi_a) >> 1;
        const int mid_b = (lo_b + hi_b) >> 1;
        const int mid_c = (lo_c + hi_c) >> 1;
        // An index whose search has ended reads sv[0]: in bounds, unused.
        const T va = sv[lo_a < hi_a ? mid_a : 0];
        const T vb = sv[lo_b < hi_b ? mid_b : 0];
        const T vc = sv[lo_c < hi_c ? mid_c : 0];
        if (lo_a < hi_a) {
            if (va < a) lo_a = mid_a + 1; else hi_a = mid_a;
        }
        if (lo_b < hi_b) {
            if (vb <= b) lo_b = mid_b + 1; else hi_b = mid_b;
        }
        if (lo_c < hi_c) {
            if (vc <= c) lo_c = mid_c + 1; else hi_c = mid_c;
        }
    }
    return {lo_a, lo_b, lo_c};
}

// The two slots of one (job, row): segment 0 is the in-window column
// range, segment 1 the wrapped pre-seam range; a slot's length is 0
// unless it is live.
struct Slots {
    int32_t s0, l0, s1, l1;
    bool o0, o1;
};

// What every row of a call shares.
template <typename T>
struct Axes {
    const T* sv0;
    const int32_t* rowoff0;
    const T* sv1;
    int n1, cyclic;
    T eps1, period;
};

template <typename T>
__device__ __forceinline__ Slots row_slots(const Axes<T>& ax,
                                           const T* __restrict__ vx,
                                           const uint8_t* __restrict__ vm,
                                           int v, int64_t base, int row,
                                           T tol) {
    Slots s{0, 0, 0, 0, false, false};
    const MinorExtents<T> e = slice_minor_extents<T>(
        vx, vx + 1, 2, vm, v, ax.sv0[row], tol);
    if (!e.hit) return s;
    const T* sv1 = ax.sv1;
    const int n1 = ax.n1;
    int ja0, ja1, jb1;
    if (ax.cyclic) {
        const T period = ax.period;
        const bool whole = (e.hi - e.lo) >= period;
        const T m = floor((e.lo - sv1[0]) / period);
        const T lo_s = e.lo - m * period;
        const T hi_s = e.hi - m * period;
        const Counts3 c = counts3(sv1, n1, lo_s - ax.eps1, hi_s + ax.eps1,
                                  hi_s - period + ax.eps1);
        ja0 = whole ? 0 : c.lt_a;
        ja1 = whole ? n1 : c.le_b;
        jb1 = whole ? 0 : c.le_c;
    } else {
        const Counts3 c = counts3(sv1, n1, e.lo - ax.eps1, e.hi + ax.eps1,
                                  e.hi + ax.eps1);
        ja0 = c.lt_a;
        ja1 = c.le_b;
        jb1 = 0;
    }
    const int64_t row_off = base + ax.rowoff0[row];
    const int len_a = ja1 - ja0 > 0 ? ja1 - ja0 : 0;
    if (len_a > 0) {
        s.s0 = (int32_t)(row_off + ja0);
        s.l0 = len_a;
        s.o0 = true;
    }
    if (ax.cyclic && jb1 > 0) {
        s.s1 = (int32_t)row_off;
        s.l1 = jb1;
        s.o1 = true;
    }
    return s;
}

__device__ __forceinline__ int live_slots(const Slots& s) {
    return __popc(__ballot_sync(FULL, s.o0)) +
           __popc(__ballot_sync(FULL, s.o1));
}

// Writes one 32-row step's live slots at pos onwards, in (row, segment)
// order, and moves pos past them.
__device__ __forceinline__ void emit(const Slots& s, int lane, int32_t& pos,
                                     int32_t* __restrict__ run_start,
                                     int32_t* __restrict__ run_len) {
    const unsigned b0 = __ballot_sync(FULL, s.o0);
    const unsigned b1 = __ballot_sync(FULL, s.o1);
    const unsigned below = (1u << lane) - 1u;
    const int32_t p = pos + __popc(b0 & below) + __popc(b1 & below);
    if (s.o0) {
        run_start[p] = s.s0;
        run_len[p] = s.l0;
    }
    if (s.o1) {
        run_start[p + s.o0] = s.s1;
        run_len[p + s.o0] = s.l1;
    }
    pos += __popc(b0) + __popc(b1);
}

__device__ __forceinline__ void publish(unsigned long long* tiles, int t,
                                        unsigned flag, int32_t value) {
    const unsigned long long word =
        (unsigned long long)flag << 32 | (uint32_t)value;
    *reinterpret_cast<volatile unsigned long long*>(tiles + t) = word;
}

// The runs of every tile before `tile`, by the first warp of the CTA:
// each step reads the 32 descriptors before the window's end, one a lane
// (the nearest on lane 0; before tile 0 an empty prefix), waits until all
// are published, and adds the aggregates up to and including the nearest
// inclusive prefix; without one, all 32, and the window moves back.
// Tile 0 publishes its prefix at once, so the walk ends.
__device__ __forceinline__ int32_t look_back(const unsigned long long* tiles,
                                             int tile, int lane) {
    int32_t sum = 0;
    for (int end = tile - 1;; end -= 32) {
        const int t = end - lane;
        unsigned long long word;
        for (;;) {
            word = t >= 0 ? *reinterpret_cast<const volatile unsigned long
                                                    long*>(tiles + t)
                          : (unsigned long long)TILE_PREFIX << 32;
            if (!__any_sync(FULL, (word >> 32) == 0)) break;
            __nanosleep(32);
        }
        const unsigned prefix =
            __ballot_sync(FULL, (unsigned)(word >> 32) == TILE_PREFIX);
        const int stop = prefix ? __ffs(prefix) - 1 : 31;
        sum += __reduce_add_sync(
            FULL, lane <= stop ? (int32_t)(uint32_t)word : 0);
        if (prefix) return sum;
    }
}

// No __launch_bounds__: with one (128 threads, or 128 and 8 CTAs an SM)
// ptxas held the kernel to 56-64 registers and spilled; without, it
// spills nothing.
template <typename T>
__global__ void plan_runs_kernel(
        const T* __restrict__ verts, const uint8_t* __restrict__ valid,
        const int32_t* __restrict__ base, const T* __restrict__ sv0,
        const int32_t* __restrict__ rowoff0, const T* __restrict__ sv1,
        const T* __restrict__ scalars, int jobs, int v, int n0, int n1,
        int rows, int cyclic, int n_tiles, int32_t* __restrict__ run_start,
        int32_t* __restrict__ run_len, int32_t* __restrict__ meta,
        int32_t* __restrict__ ticket, unsigned long long* tiles) {
    __shared__ int s_tile;
    __shared__ int32_t s_runs[PLAN_WARPS], s_rows[PLAN_WARPS],
        s_pts[PLAN_WARPS], s_before;
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();
    const int tile = s_tile;
    const int64_t job = (int64_t)tile * PLAN_WARPS + w;
    const bool has_job = job < jobs;              // the same on every lane
    const T* vx = verts + job * v * 2;
    const uint8_t* vm = valid + job * v;
    const Axes<T> ax{sv0, rowoff0, sv1, n1, cyclic, scalars[EPS1],
                     scalars[PERIOD]};

    // Row discovery on the major axis: the job's extents, lanes over the
    // vertices, then a butterfly of shuffles.
    const T big = (T)INFINITY;
    T lo0 = big, hi0 = -big, amax = (T)0;
    for (int i = lane; has_job && i < v; i += 32) {
        if (!vm[i]) continue;
        const T x = vx[2 * i];
        lo0 = x < lo0 ? x : lo0;
        hi0 = x > hi0 ? x : hi0;
        const T mag = fabs(x);
        amax = mag > amax ? mag : amax;
    }
    for (int off = 16; off > 0; off >>= 1) {
        const T lo = __shfl_xor_sync(FULL, lo0, off);
        const T hi = __shfl_xor_sync(FULL, hi0, off);
        const T am = __shfl_xor_sync(FULL, amax, off);
        lo0 = lo < lo0 ? lo : lo0;
        hi0 = hi > hi0 ? hi : hi0;
        amax = am > amax ? am : amax;
    }
    const T eps0 = scalars[EPS0];
    const int i0 = warp_count<false>(sv0, n0, lo0 - eps0, lane);
    const int i1 = warp_count<true>(sv0, n0, hi0 + eps0, lane);
    // Live rows: r < rows and i0 + r < i1.
    const int span =
        has_job ? (i1 - i0 < rows ? (i1 - i0 > 0 ? i1 - i0 : 0) : rows) : 0;
    const T scale = (T)1 > amax ? (T)1 : amax;
    const T tol = scalars[PLANE_TOL_REL] * scale;
    const int64_t job_base = has_job ? (int64_t)base[job] : 0;

    // Count: the job's runs and points.
    Slots keep[PLAN_KEEP];
    int runs = 0, pts = 0;
#pragma unroll
    for (int k = 0; k < PLAN_KEEP; ++k) {
        const int r = 32 * k + lane;
        keep[k] = r < span ? row_slots(ax, vx, vm, v, job_base, i0 + r, tol)
                           : Slots{0, 0, 0, 0, false, false};
        runs += live_slots(keep[k]);
        pts += keep[k].l0 + keep[k].l1;
    }
    for (int k = PLAN_KEEP; 32 * k < span; ++k) {
        const int r = 32 * k + lane;
        const Slots s = r < span
            ? row_slots(ax, vx, vm, v, job_base, i0 + r, tol)
            : Slots{0, 0, 0, 0, false, false};
        runs += live_slots(s);
        pts += s.l0 + s.l1;
    }
    pts = __reduce_add_sync(FULL, pts);
    if (lane == 0) {
        s_runs[w] = runs;
        s_rows[w] = span;
        s_pts[w] = pts;
    }
    __syncthreads();

    // The tile's prefix, by the first warp: publish, look back, publish
    // again.
    if (w == 0) {
        int32_t agg = 0, n_rows = 0, n_pts = 0;
        for (int i = 0; i < PLAN_WARPS; ++i) {
            agg += s_runs[i];
            n_rows += s_rows[i];
            n_pts += s_pts[i];
        }
        int32_t before = 0;
        if (tile == 0) {
            if (lane == 0) publish(tiles, 0, TILE_PREFIX, agg);
        } else {
            if (lane == 0) publish(tiles, tile, TILE_AGGREGATE, agg);
            before = look_back(tiles, tile, lane);
            if (lane == 0) publish(tiles, tile, TILE_PREFIX, before + agg);
        }
        if (lane == 0) {
            if (n_rows) atomicAdd(&meta[1], n_rows);
            if (n_pts) atomicAdd(&meta[2], n_pts);
            if (tile == n_tiles - 1) meta[0] = before + agg;
            s_before = before;
        }
    }
    __syncthreads();

    // Write: every live run straight to its final position.
    int32_t pos = s_before;
    for (int i = 0; i < w; ++i) pos += s_runs[i];
#pragma unroll
    for (int k = 0; k < PLAN_KEEP; ++k)
        emit(keep[k], lane, pos, run_start, run_len);
    for (int k = PLAN_KEEP; 32 * k < span; ++k) {
        const int r = 32 * k + lane;
        const Slots s = r < span
            ? row_slots(ax, vx, vm, v, job_base, i0 + r, tol)
            : Slots{0, 0, 0, 0, false, false};
        emit(s, lane, pos, run_start, run_len);
    }
}

// buf holds 2 * m + 4 + 2 * jobs int32 words (m = jobs * rows * 2):
// run_start (m), run_len (m), meta (3), the ticket (1), then one 64-bit
// descriptor per tile (at most one per job).
extern "C" int polytope_plan_runs_2d(
        int device, int is_f64, const void* verts, const void* valid,
        const void* base, const void* sv0, const void* rowoff0,
        const void* sv1, const void* scalars, int jobs, int v, int n0, int n1,
        int rows, int cyclic, void* buf, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t m = (int64_t)jobs * rows * 2;
    const int n_tiles = (jobs + PLAN_WARPS - 1) / PLAN_WARPS;
    int32_t* words = static_cast<int32_t*>(buf);
    int32_t* run_start = words;
    int32_t* run_len = words + m;
    int32_t* meta = words + 2 * m;
    int32_t* ticket = meta + 3;
    auto* tiles = reinterpret_cast<unsigned long long*>(ticket + 1);
    err = cudaMemsetAsync(buf, 0, (size_t)(2 * m + 4 + 2 * (int64_t)n_tiles)
                                      * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    if (is_f64)
        plan_runs_kernel<double><<<n_tiles, PLAN_WARPS * 32, 0, s>>>(
            static_cast<const double*>(verts),
            static_cast<const uint8_t*>(valid),
            static_cast<const int32_t*>(base),
            static_cast<const double*>(sv0),
            static_cast<const int32_t*>(rowoff0),
            static_cast<const double*>(sv1),
            static_cast<const double*>(scalars), jobs, v, n0, n1, rows,
            cyclic, n_tiles, run_start, run_len, meta, ticket, tiles);
    else
        plan_runs_kernel<float><<<n_tiles, PLAN_WARPS * 32, 0, s>>>(
            static_cast<const float*>(verts),
            static_cast<const uint8_t*>(valid),
            static_cast<const int32_t*>(base),
            static_cast<const float*>(sv0),
            static_cast<const int32_t*>(rowoff0),
            static_cast<const float*>(sv1),
            static_cast<const float*>(scalars), jobs, v, n0, n1, rows,
            cyclic, n_tiles, run_start, run_len, meta, ticket, tiles);
    return polytope_launch_status();
}
