// The batched crop planner in one launch: core/batched.py's
// batched_plan_2d, and batched_extract_2d's read with it.
//
// Replaces slice_minor_extents of the JAX package's kernels/slice/ref.py
// (line 31, B4) together with the jnp code of its core/batched.py
// (batched_plan_2d, lines 34-95) that XLA fuses around it: for each of P
// convex 2-D polytopes on a regular (n0 x n1) grid,
//   lo0, hi0   the polytope's extents on axis 0 over its valid vertices,
//              scale = max(1, max |x|) over all of its vertices;
//   rows       start = searchsorted(axis0, lo0 - 1e-6, "left"), row r
//              is start + r, live while it is < n0 and its value is
//              <= hi0 + 1e-6;
//   cut        B4 on each live row: the extents [lo1, hi1] of axis 1 and
//              whether the row hits (slice_extents.cuh, unchanged);
//   columns    c_start = searchsorted(axis1, lo1 - 1e-6, "left"), column
//              c is c_start + c, live while it is < n1 and its value is
//              <= hi1 + 1e-6;
// and writes the (P, R, C) int32 lattice of flat offsets row * n1 + col
// with -1 at dead slots, n_points (P,) int32, and, when a field is
// passed, the (P, R * C) values field[offset] with 0 at dead slots.
//
// Bound on the H100: bytes, and at the batched path's sizes (P = 256, a
// few microseconds of writes) the latency of one launch.  The plain
// PyTorch version is some 30-35 kinds of small kernels a call and, for
// its int32 casts, host reads of the lattice's min and max; here it is
// one launch that reads nothing back.
//
// Design.  A block per polytope, up to WARPS warps.  The block first
// copies both axes into shared memory when they fit beside its per-warp
// counts in the 48 KB a launch gets without opting in (F320's 640 + 1280
// float32 values take 7.5 KB; STAGE_UNROLL loads a thread in flight
// before its stores), else reads them where they are.  All of the
// block's shared memory is the launch's dynamic allocation, so its size
// is the whole of what the block uses.
// Meanwhile every warp computes the polytope's lo0, hi0 and scale
// itself (lanes over the vertices, then xor shuffles), and then its
// first row by a warp-wide 32-ary search (each round 32 lanes probe
// 32 evenly spaced entries and a ballot counts those below the key).
// Rows go in chunks of 32: lane r cuts row r of the chunk with B4's
// device function and finds the row's first column by its own binary
// search.  The block's warps then split the chunk's flat (row, column)
// slots, SLOT_UNROLL a lane a step, each slot taking its row's cut from
// that row's lane by __shfl_sync: the lattice and value stores are
// contiguous, and each step issues all its column tests and field
// loads before its stores.  n_points is a sum over the block's warps in
// shared memory (one barrier at the end), written once per polytope
// with no atomics.  Lanes, not warps, take the rows: a warp per row,
// walking its rows in turn, was slower on an H100 at the 256 crops of
// chip_smoke.py's batched phase, and so were the axes left in device
// memory (PERF.md, the batched planner's design steps).
//
// Exactness: byte-equal to the plain version (kernels/slice/ref.py).
// Every threshold is one rounding in T with the constant first rounded
// to T (lo0 - 1e-6, hi0 + 1e-6, PLANE_TOL * scale, lo1 - 1e-6,
// hi1 + 1e-6), as PyTorch rounds a tensor-scalar operation; built with
// --fmad=false, so B4's lerp is not fused.  lo0, hi0, lo1 and hi1 reach
// the output only through those sums, so the sign a zero extent takes in
// a min or max does not show.  Both searches count the entries below
// the key, which is searchsorted(side="left") on a sorted axis.  NaN
// coordinates are outside the contract.  Offsets are int64 until the
// store; the wrapper has checked n0 * n1 <= 2^31.  Field elements move
// as opaque 1-, 2-, 4- or 8-byte words, a dead slot's word is 0 (+0.0).
#include <math.h>

#include "common.cuh"
#include "slice_extents.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
// Warps a block takes at most (fewer when a chunk of 32 rows has fewer
// steps of slots): at P = 256 crops, 256 blocks of 8 warps fit the
// card's 132 SMs in one wave.
constexpr int WARPS = 8;
// The shared memory a launch gets without opting in: the per-warp counts
// and, when they fit beside them, the staged axes.
constexpr int64_t SHARED_BYTES = 48 * 1024;
// The per-warp counts come first, padded so that the axes after them are
// 16-byte aligned.
constexpr int64_t COUNT_BYTES = (WARPS * sizeof(int32_t) + 15) / 16 * 16;
// Slots a lane takes per step of the slot walk: their column tests and
// field loads are all issued before their stores.
constexpr int SLOT_UNROLL = 4;
// Axis values a thread loads before it stores them when staging.
constexpr int STAGE_UNROLL = 8;

// searchsorted(a, x, side="left") over the sorted a[0, n): the number of
// entries below x, by 32-ary rounds.  Every lane of the warp calls it
// with the same n and x and gets the same answer.  Invariant: the answer
// lies in [lo, hi]; lane j probes entry lo + (j + 1) * s - 1.
template <typename T>
__device__ __forceinline__ int64_t warp_lower_bound(const T* a, int64_t n,
                                                    T x) {
    const int lane = threadIdx.x & 31;
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t s = (hi - lo + 31) / 32;
        const int64_t probe = lo + (int64_t)(lane + 1) * s - 1;
        const bool below = probe < hi && a[probe] < x;
        const int k = __popc(__ballot_sync(FULL, below));
        const int64_t next_hi = lo + (int64_t)(k + 1) * s - 1;
        lo += (int64_t)k * s;
        hi = next_hi < hi ? next_hi : hi;
    }
    return lo;
}

// The same count by one lane alone: a binary search.
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* a, int64_t n, T x) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (a[mid] < x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
    for (int o = 16; o > 0; o >>= 1) {
        const T w = __shfl_xor_sync(FULL, v, o);
        v = w < v ? w : v;
    }
    return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
    for (int o = 16; o > 0; o >>= 1) {
        const T w = __shfl_xor_sync(FULL, v, o);
        v = w > v ? w : v;
    }
    return v;
}

// verts (p, v, 2), valid (p, v), axis0 (len0,), axis1 (len1,);
// offsets (p, rows, cols), n_points (p,); field (>= n0 * n1,) and
// values (p, rows * cols), both null for a plan only.  Dynamic shared
// memory: COUNT_BYTES of per-warp counts, then, with `stage`, both axes,
// which the block copies there first and the searches and column tests
// read there.
template <typename T, typename W>
__global__ void batched_plan_kernel(
        const T* __restrict__ verts, const uint8_t* __restrict__ valid,
        int v, const T* __restrict__ axis0, int64_t len0, int64_t n0,
        const T* __restrict__ axis1, int64_t len1, int64_t n1, int rows,
        int cols, int stage, const W* __restrict__ field,
        int32_t* __restrict__ offsets, int32_t* __restrict__ n_points,
        W* __restrict__ values) {
    extern __shared__ __align__(16) unsigned char shared[];
    int32_t* warp_points = reinterpret_cast<int32_t*>(shared);
    const int64_t p = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    const T* pv = verts + p * v * 2;
    const uint8_t* pm = valid + p * v;
    const T big = (T)INFINITY;
    const T eps = (T)1e-6;

    const T* a0 = axis0;
    const T* a1 = axis1;
    if (stage) {
        // axis0 then axis1, contiguous; STAGE_UNROLL loads a thread in
        // flight before its stores.
        T* s0 = reinterpret_cast<T*>(shared + COUNT_BYTES);
        const int64_t total = len0 + len1;
        for (int64_t i0 = threadIdx.x; i0 < total;
             i0 += (int64_t)blockDim.x * STAGE_UNROLL) {
            T held[STAGE_UNROLL];
#pragma unroll
            for (int u = 0; u < STAGE_UNROLL; ++u) {
                const int64_t i = i0 + (int64_t)u * blockDim.x;
                held[u] = i < len0 ? axis0[i]
                                   : (i < total ? axis1[i - len0] : (T)0);
            }
#pragma unroll
            for (int u = 0; u < STAGE_UNROLL; ++u) {
                const int64_t i = i0 + (int64_t)u * blockDim.x;
                if (i < total) s0[i] = held[u];
            }
        }
        a0 = s0;
        a1 = s0 + len0;
    }

    // The polytope's extents on axis 0 and its scale, in every warp
    // (while the axes' copies are in flight).
    T lo0 = big, hi0 = -big, amax = (T)0;
    for (int i = lane; i < v; i += 32) {
        const T x = pv[2 * i];
        const T ax = fabs(x);
        amax = ax > amax ? ax : amax;
        if (pm[i]) {
            lo0 = x < lo0 ? x : lo0;
            hi0 = x > hi0 ? x : hi0;
        }
    }
    lo0 = warp_min(lo0);
    hi0 = warp_max(hi0);
    amax = warp_max(amax);
    const T scale = (T)1 > amax ? (T)1 : amax;
    const T tol = (T)1e-6 * scale;          // ref.PLANE_TOL * scale
    const T hi0_eps = hi0 + eps;
    if (stage) __syncthreads();
    const int64_t start = warp_lower_bound(a0, len0, lo0 - eps);

    int32_t points = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
        // Lane r holds row r0 + r: its cut and its first column.
        const int r = r0 + lane;
        const int64_t row = start + r;
        int hit = 0;
        long long c_start = 0;
        T hi1_eps = (T)0;
        if (r < rows && row < n0) {
            const T row_val = a0[row];
            if (row_val <= hi0_eps) {
                const MinorExtents<T> cut = slice_minor_extents<T>(
                    pv, pv + 1, 2, pm, v, row_val, tol);
                if (cut.hit) {
                    hit = 1;
                    c_start = lower_bound(a1, len1, cut.lo - eps);
                    hi1_eps = cut.hi + eps;
                }
            }
        }
        // The block's warps split the chunk's (row, column) slots; a
        // slot takes its row's cut from that row's lane.
        const int chunk_rows = rows - r0 < 32 ? rows - r0 : 32;
        const int64_t chunk = (int64_t)chunk_rows * cols;
        const int64_t base = (p * rows + r0) * (int64_t)cols;
        for (int64_t e0 = (int64_t)warp * 32 * SLOT_UNROLL; e0 < chunk;
             e0 += (int64_t)warps * 32 * SLOT_UNROLL) {
            int64_t off[SLOT_UNROLL];
            W val[SLOT_UNROLL];
#pragma unroll
            for (int u = 0; u < SLOT_UNROLL; ++u) {
                const int64_t e = e0 + 32 * u + lane;
                const int rr = e < chunk ? (int)(e / cols) : 0;
                const int c = (int)(e - (int64_t)rr * cols);
                const int hit_r = __shfl_sync(FULL, hit, rr);
                const long long c0_r = __shfl_sync(FULL, c_start, rr);
                const T hi_r = __shfl_sync(FULL, hi1_eps, rr);
                const int64_t col = c0_r + c;
                const bool live = e < chunk && hit_r && col < n1 &&
                                  a1[col] <= hi_r;
                off[u] = live ? (start + r0 + rr) * n1 + col : -1;
            }
            if (values != nullptr) {
#pragma unroll
                for (int u = 0; u < SLOT_UNROLL; ++u)
                    val[u] = off[u] >= 0 ? field[off[u]] : W(0);
            }
#pragma unroll
            for (int u = 0; u < SLOT_UNROLL; ++u) {
                const int64_t e = e0 + 32 * u + lane;
                if (e >= chunk) continue;
                offsets[base + e] = (int32_t)off[u];
                if (values != nullptr) values[base + e] = val[u];
                points += off[u] >= 0;
            }
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        points += __shfl_xor_sync(FULL, points, o);
    if (lane == 0) warp_points[warp] = points;
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t total = 0;
        for (int w = 0; w < warps; ++w) total += warp_points[w];
        n_points[p] = total;
    }
}

template <typename T, typename W>
void launch(const void* verts, const void* valid, int v, const void* axis0,
            int64_t len0, int64_t n0, const void* axis1, int64_t len1,
            int64_t n1, int64_t p, int rows, int cols, const void* field,
            void* offsets, void* n_points, void* values, cudaStream_t s) {
    const int64_t chunk = (int64_t)(rows < 32 ? rows : 32) * cols;
    const int64_t steps = (chunk + 32 * SLOT_UNROLL - 1) / (32 * SLOT_UNROLL);
    const int warps = steps < 1 ? 1 : (steps < WARPS ? (int)steps : WARPS);
    const int64_t axes_bytes = (len0 + len1) * (int64_t)sizeof(T);
    const bool stage = COUNT_BYTES + axes_bytes <= SHARED_BYTES;
    const size_t shared = COUNT_BYTES + (stage ? axes_bytes : 0);
    batched_plan_kernel<T, W><<<(unsigned)p, 32 * warps, shared, s>>>(
        static_cast<const T*>(verts), static_cast<const uint8_t*>(valid), v,
        static_cast<const T*>(axis0), len0, n0, static_cast<const T*>(axis1),
        len1, n1, rows, cols, (int)stage, static_cast<const W*>(field),
        static_cast<int32_t*>(offsets), static_cast<int32_t*>(n_points),
        static_cast<W*>(values));
}

template <typename T>
int launch_for_width(int elem_size, const void* verts, const void* valid,
                     int v, const void* axis0, int64_t len0, int64_t n0,
                     const void* axis1, int64_t len1, int64_t n1, int64_t p,
                     int rows, int cols, const void* field, void* offsets,
                     void* n_points, void* values, cudaStream_t s) {
#define POLYTOPE_PLAN_LAUNCH(W)                                             \
    launch<T, W>(verts, valid, v, axis0, len0, n0, axis1, len1, n1, p, rows, \
                 cols, field, offsets, n_points, values, s)
    switch (elem_size) {
        case 1: POLYTOPE_PLAN_LAUNCH(uint8_t); break;
        case 2: POLYTOPE_PLAN_LAUNCH(uint16_t); break;
        case 4: POLYTOPE_PLAN_LAUNCH(uint32_t); break;
        case 8: POLYTOPE_PLAN_LAUNCH(uint64_t); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef POLYTOPE_PLAN_LAUNCH
    return polytope_launch_status();
}

}  // namespace

// is_f64 selects double coordinates and axes (else float).  field and
// values are null for a plan only; elem_size is then ignored.  Returns
// cudaErrorInvalidValue for an element width other than 1, 2, 4 or 8.
extern "C" int polytope_batched_plan_2d(
        int device, int is_f64, const void* verts, const void* valid, int v,
        const void* axis0, int64_t len0, int64_t n0, const void* axis1,
        int64_t len1, int64_t n1, int64_t p, int rows, int cols,
        const void* field, int elem_size, void* offsets, void* n_points,
        void* values, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (field == nullptr) elem_size = 4;
    if (is_f64)
        return launch_for_width<double>(elem_size, verts, valid, v, axis0,
                                        len0, n0, axis1, len1, n1, p, rows,
                                        cols, field, offsets, n_points,
                                        values, s);
    return launch_for_width<float>(elem_size, verts, valid, v, axis0, len0,
                                   n0, axis1, len1, n1, p, rows, cols, field,
                                   offsets, n_points, values, s);
}
