// The extraction read: kernels B1 (gather_rows) and B2 (gather_runs).
//
// Replaces the Pallas kernels of the JAX package's
// kernels/gather/kernel.py: gather_rows (_gather_kernel, the
// pallas_call at line 71: one scalar-prefetched row DMA per grid step)
// and gather_runs (_runs_kernel, the pallas_call at line 181: one
// block-wide DMA per coalesced-run chunk).
//
// Bound on the H100: bytes.  Both are copies with no arithmetic: each
// output element costs one read of the payload (plus its index or
// chunk start) and one write, so the floor is
// (bytes read + bytes written) / 3.35 TB/s.
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
#include "common.cuh"

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
