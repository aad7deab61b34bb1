// The message aggregation of the GNN: kernel B7 (segment_sum).
//
// Replaces the Pallas kernel of the JAX package's
// kernels/segment/kernel.py: segment_sum (_segment_sum_kernel, the
// pallas_call at line 70), which turns the scatter-add into a one-hot
// matrix product on the MXU: for each 256-edge block, onehot(ids) (S x
// 256) @ messages (256 x D), added into an (S, D) accumulator that stays
// in VMEM for the whole grid.
//
// Function: (E, D) messages and (E,) int32 segment ids in [-1, S) give
// the (S, D) sums out[s] = sum of messages[e] over the edges with
// ids[e] == s, in the messages' dtype (float or double).  A -1 id is
// dropped; an empty segment is +0.0.
//
// Bound on the H100: bytes.  One add per element read: the rows of the
// edges with a segment (E x D elements at most), the ids, and the (S, D)
// output written once, over 3.35 TB/s.  The one-hot product does S x E x
// D multiply-adds; the card has no reason to do that work.
//
// Design: the wrapper groups the edges by segment first (a CSR: a
// stable sort of the ids gives the edge permutation, and a binary
// search the (S + 1) offsets), so that each segment's edges are
// perm[offsets[s] .. offsets[s + 1]), in ascending edge index.  Then, as
// in B6 (gather.cu), each segment gets a group of 1-32 lanes of one
// warp, sized to the row in packs of VEC elements (16-byte loads where D
// and both pointers allow them): D = 32 floats take 8 lanes of float4,
// D = 160 take 32 lanes in two passes over the columns, D = 1 one lane.
// The lanes load a run of the segment's edge numbers together and pass
// them round with __shfl_sync; each lane then loads UNROLL rows before
// adding them, so that several loads are in flight.  The sum starts at
// +0.0 and adds the edges in ascending edge index, in the messages'
// dtype, with no FMA and no atomics: every segment is summed by one
// group in one fixed order, so kernel, plain version and a sequential
// loop agree byte for byte, and the result does not depend on timing.
//
// What a hub costs: a segment with many edges is walked by its one
// group alone, edge after edge, because the order of the adds is part of
// the result.  A 10,000-edge segment is 10,000 dependent adds per
// column on one SM, with at most UNROLL rows in flight per lane: it takes
// the time of that chain and of those loads however many SMs are idle.
// Splitting it across groups would change the rounding.
#include "common.cuh"
#include "rows.cuh"

constexpr int UNROLL = 4;

template <typename T, int VEC>
__global__ void segment_sum_kernel(const T* __restrict__ msg, int64_t d,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ offsets,
                                   int64_t s, int group,
                                   T* __restrict__ out) {
    using P = Pack<T, VEC>;
    const int g = threadIdx.x & (group - 1);      // lane within the group
    const unsigned mask = group_mask(group);
    const int64_t per_block = blockDim.x / group;
    const int64_t stride = (int64_t)gridDim.x * per_block;
    const int64_t dv = d / VEC;                   // packs per row
    for (int64_t seg = (int64_t)blockIdx.x * per_block + threadIdx.x / group;
         seg < s; seg += stride) {
        const int64_t beg = offsets[seg];
        const int64_t end = offsets[seg + 1];
        P* orow = reinterpret_cast<P*>(out + seg * d);
        for (int64_t c0 = 0; c0 < dv; c0 += group) {
            const int64_t c = c0 + g;
            const bool mine = c < dv;
            P acc;
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc.v[j] = T(0);
            for (int64_t e0 = beg; e0 < end; e0 += group) {
                const int64_t held = e0 + g < end ? perm[e0 + g] : 0;
                const int n = (int)(end - e0 < group ? end - e0 : group);
                int k = 0;
                for (; k + UNROLL <= n; k += UNROLL) {
                    P rows[UNROLL];
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
                        const int64_t e = __shfl_sync(mask, held, k + u,
                                                      group);
                        if (mine) {
                            rows[u] = reinterpret_cast<const P*>(
                                msg + e * d)[c];
                        } else {
#pragma unroll
                            for (int j = 0; j < VEC; ++j) rows[u].v[j] = T(0);
                        }
                    }
#pragma unroll
                    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                        for (int j = 0; j < VEC; ++j)
                            acc.v[j] = acc.v[j] + rows[u].v[j];
                    }
                }
                for (; k < n; ++k) {
                    const int64_t e = __shfl_sync(mask, held, k, group);
                    if (mine) {
                        const P row = reinterpret_cast<const P*>(
                            msg + e * d)[c];
#pragma unroll
                        for (int j = 0; j < VEC; ++j)
                            acc.v[j] = acc.v[j] + row.v[j];
                    }
                }
            }
            if (mine) orow[c] = acc;
        }
    }
}

template <typename T, int VEC>
static void launch(const void* msg, int64_t d, const void* perm,
                   const void* offsets, int64_t s, void* out,
                   cudaStream_t stream) {
    const int group = group_for(d / VEC);
    const int threads = 256;
    const int64_t per_block = threads / group;
    const int64_t want = (s + per_block - 1) / per_block;
    const int64_t cap = 132 * 32;  // grid-stride past 32 blocks per SM
    const unsigned blocks = (unsigned)(want < cap ? want : cap);
    segment_sum_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(msg), d, static_cast<const int64_t*>(perm),
        static_cast<const int64_t*>(offsets), s, group,
        static_cast<T*>(out));
}

// out (s, d): out[i] = sum over k in [offsets[i], offsets[i + 1]) of
// msg[perm[k]], in k order from +0.0; perm and offsets are int64;
// elem_bytes 4 is float, 8 double.
extern "C" int polytope_segment_sum(int device, const void* msg, int64_t d,
                                    const void* perm, const void* offsets,
                                    int64_t s, int elem_bytes, void* out,
                                    void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool a16 = aligned(msg, 16) && aligned(out, 16);
    const bool a8 = aligned(msg, 8) && aligned(out, 8);
    switch (elem_bytes) {
        case 4:
            if (d % 4 == 0 && a16)
                launch<float, 4>(msg, d, perm, offsets, s, out, st);
            else if (d % 2 == 0 && a8)
                launch<float, 2>(msg, d, perm, offsets, s, out, st);
            else
                launch<float, 1>(msg, d, perm, offsets, s, out, st);
            break;
        case 8:
            if (d % 2 == 0 && a16)
                launch<double, 2>(msg, d, perm, offsets, s, out, st);
            else
                launch<double, 1>(msg, d, perm, offsets, s, out, st);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return polytope_launch_status();
}
