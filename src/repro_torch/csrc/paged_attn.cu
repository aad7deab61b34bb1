// Paged decode attention of the LM serving engine: kernel B8
// (paged_decode_attention) on the CUDA cores, for float32 and for the bf16
// shapes the tensor-core kernel (paged_attn_tc.cu: bf16, Dh in {16, 32,
// 64, 128}, G <= 16) does not take.  The merge pass is in paged_attn.cuh.
//
// Replaces the Pallas kernel of the JAX package's
// kernels/paged_attn/kernel.py: paged_decode_attention
// (_paged_attn_kernel, the pallas_call at line 123), whose grid step
// (b, kvh, p) copies page block_table[b, p] (a -1 entry clamped to page
// 0) of one KV head into VMEM and folds it into a flash-attention
// accumulator (m, l, acc) held in VMEM scratch across the page axis.
//
// Function: one decode token per sequence.  q (B, H, Dh) against the
// page pool k_pages, v_pages (NP, KVH, PS, Dh); sequence b's pages are
// block_table[b, :] (B, PMAX) int32, -1 for unused, and its slots are
// live while pos < seq_lens[b].  H = KVH * G (grouped-query attention):
// the G query heads k*G .. k*G + G - 1 share KV head k.  Scores
// q.k / sqrt(Dh) and the softmax are float32; the output (B, H, Dh) is
// in q's dtype (bf16 or float).  A sequence with seq_lens == 0 gets
// zeros.
//
// Bound on the H100: bytes.  Each live K and V row is read once: 2 x
// seq_lens[b] x KVH x Dh elements per sequence, plus q, the output and
// the table.  The arithmetic is 4 x B x H x S x Dh flops, G flops per
// byte of bf16 K/V: far below the tensor cores' line, near the float32
// CUDA cores' one at G = 16 (this kernel does it on the CUDA cores).
// At the decode_32k shape of GLM-4 9B (B = 128, S = 32,768, KVH = 2,
// Dh = 128, bf16) K and V are 4.29 GB a layer: 1.28 ms at 3.35 TB/s.
//
// Design (split-KV flash decoding):
// - A CTA takes one (sequence, KV head, split).  Sequence b has
//   ceil(seq_lens[b] / PS) live pages; split s of n_split walks its own
//   run of ceil(pages / n_split) of them.  The CTA reads only those
//   table entries and, of those pages, only the live slots: it never
//   reads a -1 entry, a page outside the plan or a dead slot.  (The TPU
//   kernel reads every page of the table, -1 as page 0, and masks.)
// - It stages STEP_TOKENS tokens of K and V at a time in shared memory
//   (as float32, K rows padded by one word against bank conflicts) and
//   uses each staged row for all G query rows of the group: K/V are read
//   from device memory once per group, not once per query head.
// - Per step: G x n scores (one warp covers 32 tokens of one row), an
//   online-softmax update of (m, l) per row by one warp each (expf, not
//   __expf: the build has no fast math), then acc = acc * alpha + p V
//   with acc (G x Dh) kept in shared memory, each thread owning fixed
//   elements.  Dot products use explicit __fmaf_rn (the build's
//   --fmad=false stops only implicit contraction).  All of it runs on
//   the CUDA cores in float32 with two shared-memory loads per FMA: the
//   kernel is bound by shared-memory traffic, not by the bytes it reads
//   from device memory (PERF.md has its times against the bound).
// - With one split the CTA writes the output.  With several, each writes
//   its (m, l, acc) to a float32 workspace and a second kernel merges
//   them: M = max m_s, out = sum acc_s e^(m_s - M) / sum l_s e^(m_s - M).
//   The wrapper picks n_split so that the grid fills the card at small
//   B x KVH; the merge changes the order of the float32 sums, not the
//   function.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "paged_attn.cuh"
#include "rows.cuh"

constexpr int THREADS = 128;
constexpr int STEP_TOKENS = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Shared memory of one CTA, in floats.
static inline size_t smem_floats(int g, int dh) {
    return 2 * (size_t)g * dh                       // q, acc
           + (size_t)STEP_TOKENS * (dh + 1)         // K (padded rows)
           + (size_t)STEP_TOKENS * dh               // V
           + (size_t)g * STEP_TOKENS                // scores / weights
           + 3 * (size_t)g;                         // m, l, alpha
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ table,
                  const int* __restrict__ lens, int h, int kvh, int dh,
                  int ps, int pmax, int n_split, float* __restrict__ part,
                  T* __restrict__ out) {
    const int g = h / kvh;
    const int split = blockIdx.x % n_split;
    const int bk = blockIdx.x / n_split;          // b * kvh + k
    const int b = bk / kvh;
    const int k = bk % kvh;

    extern __shared__ float smem[];
    float* q_s = smem;                            // g x dh
    float* acc_s = q_s + g * dh;                  // g x dh
    float* k_s = acc_s + g * dh;                  // STEP_TOKENS x (dh + 1)
    float* v_s = k_s + STEP_TOKENS * (dh + 1);    // STEP_TOKENS x dh
    float* w_s = v_s + STEP_TOKENS * dh;          // g x STEP_TOKENS
    float* m_s = w_s + g * STEP_TOKENS;           // g
    float* l_s = m_s + g;                         // g
    float* a_s = l_s + g;                         // g

    const int len = lens[b];
    const int pages = (len + ps - 1) / ps;
    const int per_split = (pages + n_split - 1) / n_split;
    const int p_begin = split * per_split;
    const int p_end = min(p_begin + per_split, pages);
    const int tok_begin = p_begin * ps;
    const int tok_end = min(p_end * ps, len);

    const T* qg = q + ((int64_t)b * h + (int64_t)k * g) * dh;
    for (int e = threadIdx.x; e < g * dh; e += THREADS) {
        q_s[e] = to_f(qg[e]);
        acc_s[e] = 0.0f;
    }
    for (int r = threadIdx.x; r < g; r += THREADS) {
        m_s[r] = -INFINITY;
        l_s[r] = 0.0f;
    }
    __syncthreads();

    const float root_dh = sqrtf((float)dh);
    const int* tab = table + (int64_t)b * pmax;
    const int64_t page_stride = (int64_t)kvh * ps * dh;
    const int64_t head_off = (int64_t)k * ps * dh;
    const int vecs = dh / VEC;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    using P = Pack<T, VEC>;

    for (int t0 = tok_begin; t0 < tok_end; t0 += STEP_TOKENS) {
        const int n = min(STEP_TOKENS, tok_end - t0);
        // Stage the live K and V rows of tokens t0 .. t0 + n - 1.
        for (int e = threadIdx.x; e < n * vecs; e += THREADS) {
            const int j = e / vecs;
            const int c = (e - j * vecs) * VEC;
            const int pos = t0 + j;
            const int64_t off = (int64_t)tab[pos / ps] * page_stride
                                + head_off + (int64_t)(pos % ps) * dh + c;
            const P kv = *reinterpret_cast<const P*>(kp + off);
            const P vv = *reinterpret_cast<const P*>(vp + off);
#pragma unroll
            for (int u = 0; u < VEC; ++u) {
                k_s[j * (dh + 1) + c + u] = to_f(kv.v[u]);
                v_s[j * dh + c + u] = to_f(vv.v[u]);
            }
        }
        __syncthreads();
        // Scores of the G rows against the staged tokens.
        for (int e = threadIdx.x; e < g * STEP_TOKENS; e += THREADS) {
            const int r = e / STEP_TOKENS;
            const int j = e - r * STEP_TOKENS;
            float s = -INFINITY;
            if (j < n) {
                const float* qr = q_s + r * dh;
                const float* kr = k_s + j * (dh + 1);
                float dot = 0.0f;
                for (int d = 0; d < dh; ++d)
                    dot = __fmaf_rn(qr[d], kr[d], dot);
                s = dot / root_dh;
            }
            w_s[e] = s;
        }
        __syncthreads();
        // Online softmax: one warp per row (n >= 1, so m_new is finite).
        for (int r = warp; r < g; r += THREADS / 32) {
            float* wr = w_s + r * STEP_TOKENS;
            const float mx = warp_max(lane < n ? wr[lane] : -INFINITY);
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, mx);
            const float p = lane < n ? expf(wr[lane] - m_new) : 0.0f;
            wr[lane] = p;
            const float sum = warp_sum(p);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < g * dh; e += THREADS) {
            const int r = e / dh;
            const int d = e - r * dh;
            const float* wr = w_s + r * STEP_TOKENS;
            float a = acc_s[e] * a_s[r];
            for (int j = 0; j < n; ++j)
                a = __fmaf_rn(wr[j], v_s[j * dh + d], a);
            acc_s[e] = a;
        }
        __syncthreads();
    }

    if (n_split == 1) {
        // Zeros only for an empty sequence: a NaN in a live slot stays.
        T* o = out + ((int64_t)b * h + (int64_t)k * g) * dh;
        for (int e = threadIdx.x; e < g * dh; e += THREADS)
            o[e] = from_f<T>(len > 0 ? acc_s[e] / l_s[e / dh] : 0.0f);
        return;
    }
    // Partials of split s of (b, k): G x (m, l) then G x Dh of acc.
    float* pt = part + ((int64_t)bk * n_split + split) * g * (dh + 2);
    for (int r = threadIdx.x; r < g; r += THREADS) {
        pt[2 * r] = m_s[r];
        pt[2 * r + 1] = l_s[r];
    }
    for (int e = threadIdx.x; e < g * dh; e += THREADS)
        pt[2 * g + e] = acc_s[e];
}

template <typename T, int VEC>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* table, const void* lens, int b, int h,
                  int kvh, int dh, int ps, int pmax, int n_split,
                  void* part, void* out, cudaStream_t stream) {
    const int g = h / kvh;
    // More than the card's 227 KB (G x Dh too large) is refused here.
    const size_t smem = smem_floats(g, dh) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();        // leave no error for the next launch
        return (int)err;
    }
    const unsigned blocks = (unsigned)((int64_t)b * kvh * n_split);
    paged_attn_kernel<T, VEC><<<blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int*>(table),
        static_cast<const int*>(lens), h, kvh, dh, ps, pmax, n_split,
        static_cast<float*>(part), static_cast<T*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return (int)err;
    const int64_t total = (int64_t)b * h * dh;
    const int threads = 256;
    paged_attn_merge<T><<<(unsigned)((total + threads - 1) / threads),
                          threads, 0, stream>>>(
        static_cast<const float*>(part), total, h, kvh, dh, n_split,
        static_cast<T*>(out));
    return polytope_launch_status();
}

// q (b, h, dh), pages (np, kvh, ps, dh) of elem_bytes 2 (bf16) or 4
// (float); table (b, pmax) and lens (b,) int32, every live entry a valid
// page; part: b * kvh * n_split * (h / kvh) * (dh + 2) floats when
// n_split > 1 (else unused); out (b, h, dh) in q's dtype.
extern "C" int polytope_paged_decode_attention(
        int device, const void* q, const void* kp, const void* vp,
        const void* table, const void* lens, int b, int h, int kvh, int dh,
        int ps, int pmax, int n_split, int elem_bytes, void* part,
        void* out, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool a16 = aligned(q, 16) && aligned(kp, 16) && aligned(vp, 16);
    switch (elem_bytes) {
        case 2:
            if (dh % 8 == 0 && a16)
                return launch<__nv_bfloat16, 8>(q, kp, vp, table, lens, b, h,
                                                kvh, dh, ps, pmax, n_split,
                                                part, out, st);
            return launch<__nv_bfloat16, 1>(q, kp, vp, table, lens, b, h,
                                            kvh, dh, ps, pmax, n_split, part,
                                            out, st);
        case 4:
            if (dh % 4 == 0 && a16)
                return launch<float, 4>(q, kp, vp, table, lens, b, h, kvh,
                                        dh, ps, pmax, n_split, part, out, st);
            return launch<float, 1>(q, kp, vp, table, lens, b, h, kvh, dh,
                                    ps, pmax, n_split, part, out, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
