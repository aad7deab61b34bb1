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
// megabyte and do a few million float64 operations, so launch latency
// and the single-block scan dominate.
//
// Design.  The TPU kernel walks the jobs as a sequential grid and
// carries a meta[0] cursor from step to step, appending each job's runs
// at the cursor.  CUDA blocks run in no order, so the cursor becomes
// three kernels:
//   1. plan_slots: one thread per (job, row) writes that row's two
//      uncompacted slots, their ok flags, and adds its row and point
//      counts to meta[1] and meta[2] with integer atomics (integer sums
//      do not depend on order);
//   2. exclusive_scan: one block scans the ok flags into each slot's
//      output position and writes the total to meta[0];
//   3. scatter: every live slot moves to its position, and every slot
//      at or past n_runs is zeroed, so the buffer equals the reference
//      byte for byte.
// The comparison counts of the reference (# of axis values < x) become
// binary searches: the axis values are sorted, so the counts are equal.
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

template <typename T>
__device__ __forceinline__ int count_lt(const T* __restrict__ sv, int n, T x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sv[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

template <typename T>
__device__ __forceinline__ int count_le(const T* __restrict__ sv, int n, T x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sv[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

template <typename T>
__global__ void plan_slots_kernel(
        const T* __restrict__ verts, const uint8_t* __restrict__ valid,
        const int32_t* __restrict__ base, const T* __restrict__ sv0,
        const int32_t* __restrict__ rowoff0, const T* __restrict__ sv1,
        const T* __restrict__ scalars, int v, int n0, int n1, int rows,
        int cyclic, int32_t* __restrict__ slot_start,
        int32_t* __restrict__ slot_len, int32_t* __restrict__ ok,
        int32_t* __restrict__ meta) {
    const int64_t job = blockIdx.x;
    const int r = blockIdx.y * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const T* vx = verts + job * v * 2;
    const uint8_t* vm = valid + job * v;
    const T big = (T)INFINITY;
    const T eps0 = scalars[EPS0], eps1 = scalars[EPS1];
    const T period = scalars[PERIOD];

    // Row discovery on the major axis (the job's extents; V is small,
    // so every thread of the job recomputes them).
    T lo0 = big, hi0 = -big, amax = (T)0;
    for (int i = 0; i < v; ++i) {
        if (!vm[i]) continue;
        const T x = vx[2 * i];
        lo0 = x < lo0 ? x : lo0;
        hi0 = x > hi0 ? x : hi0;
        const T ax = fabs(x);
        amax = ax > amax ? ax : amax;
    }
    const int i0 = count_lt(sv0, n0, lo0 - eps0);
    const int i1 = count_le(sv0, n0, hi0 + eps0);
    const int row = i0 + r;

    int32_t s0 = 0, l0 = 0, o0 = 0, s1 = 0, l1 = 0, o1 = 0;
    if (row < i1) {
        atomicAdd(&meta[1], 1);
        const T scale = (T)1 > amax ? (T)1 : amax;
        const T tol = scalars[PLANE_TOL_REL] * scale;
        const MinorExtents<T> e = slice_minor_extents<T>(
            vx, vx + 1, 2, vm, v, sv0[row], tol);
        if (e.hit) {
            int ja0, ja1, jb1;
            if (cyclic) {
                const bool whole = (e.hi - e.lo) >= period;
                const T m = floor((e.lo - sv1[0]) / period);
                const T lo_s = e.lo - m * period;
                const T hi_s = e.hi - m * period;
                ja0 = whole ? 0 : count_lt(sv1, n1, lo_s - eps1);
                ja1 = whole ? n1 : count_le(sv1, n1, hi_s + eps1);
                jb1 = whole ? 0 : count_le(sv1, n1, hi_s - period + eps1);
            } else {
                ja0 = count_lt(sv1, n1, e.lo - eps1);
                ja1 = count_le(sv1, n1, e.hi + eps1);
                jb1 = 0;
            }
            const int64_t row_off = (int64_t)base[job] + rowoff0[row];
            const int len_a = ja1 - ja0 > 0 ? ja1 - ja0 : 0;
            if (len_a > 0) {
                s0 = (int32_t)(row_off + ja0);
                l0 = len_a;
                o0 = 1;
            }
            if (cyclic && jb1 > 0) {
                s1 = (int32_t)row_off;
                l1 = jb1;
                o1 = 1;
            }
            if (o0 || o1) atomicAdd(&meta[2], l0 + l1);
        }
    }
    const int64_t slot = (job * rows + r) * 2;
    slot_start[slot] = s0;
    slot_len[slot] = l0;
    ok[slot] = o0;
    slot_start[slot + 1] = s1;
    slot_len[slot + 1] = l1;
    ok[slot + 1] = o1;
}

// One block: each thread sums a contiguous stretch of ok, the block
// scans the partial sums in shared memory, then each thread writes its
// stretch's exclusive positions.
__global__ void exclusive_scan_kernel(const int32_t* __restrict__ ok,
                                      int64_t m, int32_t* __restrict__ pos,
                                      int32_t* __restrict__ meta) {
    __shared__ int32_t sums[1024];
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    const int64_t per = (m + nt - 1) / nt;
    const int64_t b = t * per;
    const int64_t e = b + per < m ? b + per : m;
    int32_t own = 0;
    for (int64_t k = b; k < e; ++k) own += ok[k];
    sums[t] = own;
    __syncthreads();
    for (int off = 1; off < nt; off <<= 1) {
        const int32_t add = t >= off ? sums[t - off] : 0;
        __syncthreads();
        sums[t] += add;
        __syncthreads();
    }
    int32_t run = sums[t] - own;
    for (int64_t k = b; k < e; ++k) {
        pos[k] = run;
        run += ok[k];
    }
    if (t == nt - 1) meta[0] = sums[t];
}

__global__ void scatter_kernel(const int32_t* __restrict__ slot_start,
                               const int32_t* __restrict__ slot_len,
                               const int32_t* __restrict__ ok,
                               const int32_t* __restrict__ pos, int64_t m,
                               const int32_t* __restrict__ meta,
                               int32_t* __restrict__ run_start,
                               int32_t* __restrict__ run_len) {
    const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= m) return;
    if (ok[k]) {
        run_start[pos[k]] = slot_start[k];
        run_len[pos[k]] = slot_len[k];
    }
    if (k >= meta[0]) {
        run_start[k] = 0;
        run_len[k] = 0;
    }
}

template <typename T>
static int launch(const void* verts, const void* valid, const void* base,
                  const void* sv0, const void* rowoff0, const void* sv1,
                  const void* scalars, int jobs, int v, int n0, int n1,
                  int rows, int cyclic, int32_t* scratch, int32_t* run_start,
                  int32_t* run_len, int32_t* meta, cudaStream_t s) {
    const int64_t m = (int64_t)jobs * rows * 2;
    int32_t* slot_start = scratch;
    int32_t* slot_len = scratch + m;
    int32_t* ok = scratch + 2 * m;
    int32_t* pos = scratch + 3 * m;
    cudaError_t err = cudaMemsetAsync(meta, 0, 3 * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;

    const int threads = 128;
    const dim3 grid((unsigned)jobs, (unsigned)((rows + threads - 1) / threads));
    plan_slots_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(verts), static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(base), static_cast<const T*>(sv0),
        static_cast<const int32_t*>(rowoff0), static_cast<const T*>(sv1),
        static_cast<const T*>(scalars), v, n0, n1, rows, cyclic, slot_start,
        slot_len, ok, meta);
    int st = polytope_launch_status();
    if (st) return st;

    exclusive_scan_kernel<<<1, 1024, 0, s>>>(ok, m, pos, meta);
    st = polytope_launch_status();
    if (st) return st;

    const int st_threads = 256;
    scatter_kernel<<<(unsigned)((m + st_threads - 1) / st_threads), st_threads,
                     0, s>>>(slot_start, slot_len, ok, pos, m, meta,
                             run_start, run_len);
    return polytope_launch_status();
}

// scratch holds 4 * m int32 words (m = jobs * rows * 2); run_start and
// run_len hold m words each, meta 3.
extern "C" int polytope_plan_runs_2d(
        int device, int is_f64, const void* verts, const void* valid,
        const void* base, const void* sv0, const void* rowoff0,
        const void* sv1, const void* scalars, int jobs, int v, int n0, int n1,
        int rows, int cyclic, void* scratch, void* run_start, void* run_len,
        void* meta, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int32_t* sc = static_cast<int32_t*>(scratch);
    int32_t* rs = static_cast<int32_t*>(run_start);
    int32_t* rl = static_cast<int32_t*>(run_len);
    int32_t* mt = static_cast<int32_t*>(meta);
    if (is_f64)
        return launch<double>(verts, valid, base, sv0, rowoff0, sv1, scalars,
                              jobs, v, n0, n1, rows, cyclic, sc, rs, rl, mt, s);
    return launch<float>(verts, valid, base, sv0, rowoff0, sv1, scalars, jobs,
                         v, n0, n1, rows, cyclic, sc, rs, rl, mt, s);
}
