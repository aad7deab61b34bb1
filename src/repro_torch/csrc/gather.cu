// The extraction read: kernels B1 (gather_rows) and B2 (gather_runs), and
// the EmbeddingBag sum of the recsys models: kernel B6 (gather_rows_bag).
//
// Replaces the Pallas kernels of the JAX package's
// kernels/gather/kernel.py: gather_rows (_gather_kernel, the
// pallas_call at line 71: one scalar-prefetched row DMA per grid step),
// gather_rows_bag (_bag_kernel, the pallas_call at line 123: a (B, L)
// grid, one row DMA per bag slot, summed into the bag's output row over
// the sequential L axis) and gather_runs (_runs_kernel, the pallas_call
// at line 181: one block-wide DMA per coalesced-run chunk).
//
// Bound on the H100: bytes.  All three are copies with no or one add per
// element read: each output element costs one read of the payload (plus
// its index or chunk start) and one write, so the floor is
// (bytes read + bytes written) / 3.35 TB/s.  For B6 the rows read are
// the distinct ids of the batch: Zipf traffic re-reads hot rows from L2.
//
// Design: the TPU kernels move one row or one chunk per sequential grid
// step.  Here every output element has its own thread.  gather_rows
// maps thread -> element (i, c) of the (M, D) output; gather_runs runs
// one block per chunk with its threads striding over the block-wide
// window, so neighbouring threads touch neighbouring addresses in both
// the window read and the output write.  All addresses are int64_t: an
// output or payload past 2^31 elements must not wrap.  gather_runs masks
// its loads with start + k < n and writes zero past the end, so the
// payload is never padded (the JAX wrapper concatenates a padded copy
// of the whole payload on every call).  Elements move as opaque 1-, 2-,
// 4- or 8-byte words, so one instantiation serves every dtype of that
// width.
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

template <typename W>
__global__ void gather_rows_kernel(const W* __restrict__ table, int64_t d,
                                   const int32_t* __restrict__ idx,
                                   int64_t m, W* __restrict__ out) {
    const int64_t total = m * d;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += step) {
        const int64_t i = e / d;
        const int64_t c = e - i * d;
        out[e] = table[(int64_t)idx[i] * d + c];
    }
}

template <typename W>
__global__ void gather_runs_kernel(const W* __restrict__ flat, int64_t n,
                                   const int32_t* __restrict__ starts,
                                   int block, W* __restrict__ out) {
    const int64_t c = blockIdx.x;
    const int64_t start = starts[c];
    W* row = out + c * block;
    for (int k = threadIdx.x; k < block; k += blockDim.x) {
        const int64_t src = start + k;
        row[k] = src < n ? flat[src] : W(0);
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

template <typename W>
static void launch_rows(const void* table, int64_t d, const void* idx,
                        int64_t m, void* out, cudaStream_t s) {
    const int threads = 256;
    const int64_t want = (m * d + threads - 1) / threads;
    const int64_t cap = 132 * 64;  // grid-stride past 64 blocks per SM
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    gather_rows_kernel<W><<<blocks, threads, 0, s>>>(
        static_cast<const W*>(table), d, static_cast<const int32_t*>(idx), m,
        static_cast<W*>(out));
}

template <typename W>
static void launch_runs(const void* flat, int64_t n, const void* starts,
                        int64_t c, int block, void* out, cudaStream_t s) {
    const int threads = block < 128 ? block : 128;
    gather_runs_kernel<W><<<(unsigned)c, threads, 0, s>>>(
        static_cast<const W*>(flat), n, static_cast<const int32_t*>(starts),
        block, static_cast<W*>(out));
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

// out (m, d) = table (n, d)[idx (m,)]; elem_bytes is the dtype's width.
extern "C" int polytope_gather_rows(int device, const void* table, int64_t d,
                                    const void* idx, int64_t m,
                                    int elem_bytes, void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (elem_bytes) {
        case 1: launch_rows<uint8_t>(table, d, idx, m, out, s); break;
        case 2: launch_rows<uint16_t>(table, d, idx, m, out, s); break;
        case 4: launch_rows<uint32_t>(table, d, idx, m, out, s); break;
        case 8: launch_rows<uint64_t>(table, d, idx, m, out, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}

// out (c, block): out[i, k] = flat[starts[i] + k], zero where that is >= n.
extern "C" int polytope_gather_runs(int device, const void* flat, int64_t n,
                                    const void* starts, int64_t c, int block,
                                    int elem_bytes, void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (elem_bytes) {
        case 1: launch_runs<uint8_t>(flat, n, starts, c, block, out, s); break;
        case 2: launch_runs<uint16_t>(flat, n, starts, c, block, out, s); break;
        case 4: launch_runs<uint32_t>(flat, n, starts, c, block, out, s); break;
        case 8: launch_runs<uint64_t>(flat, n, starts, c, block, out, s); break;
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
