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
// gather_rows_bag gives each bag a group of 1-32 lanes of one warp, the
// smallest power of two that covers the row in packs of VEC elements
// (16-byte loads where D and both pointers allow them, else 8 or 4): D
// = 64 float takes 16 lanes of float4, D = 10 takes 8 lanes of float2,
// D = 1 one lane, so a narrow row does not leave a warp idle.  Groups
// walk the bags in a grid-stride loop.  The lanes of a group load a run
// of the bag's ids together, one id each, and pass them round with
// __shfl_sync, so each id is read once per bag (for D up to 32 packs;
// a wider row takes several passes over the columns, each reading the
// ids again from L1).  A -1 slot loads nothing and adds +0.0.  The sum
// starts at zero and adds the slots in l order, in the table's dtype:
// the Pallas kernel's order, so kernel, plain version and Pallas kernel
// agree byte for byte.  float and double only.
#include "common.cuh"
#include "rows.cuh"

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
// slots adding zero; elem_bytes 4 is float, 8 double.
extern "C" int polytope_gather_rows_bag(int device, const void* table,
                                        int64_t d, const void* bags,
                                        int64_t b, int64_t l, int elem_bytes,
                                        void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
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
