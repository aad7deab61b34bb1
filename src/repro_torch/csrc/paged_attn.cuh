// Shared by the two kernels of B8 (paged_decode_attention): the CUDA-core
// kernel of paged_attn.cu and the tensor-core kernel of paged_attn_tc.cu.
// Both write a split's partial (m, l, acc) in the same layout, and this
// pass merges the splits.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Merges the n_split partials of each (sequence, KV head): split s of
// (b, k) holds, for each of its G rows r, m at [2r], l at [2r + 1] and
// acc (Dh floats) at [2G + r * Dh].  M = max m_s, out = sum acc_s
// e^(m_s - M) / sum l_s e^(m_s - M); zeros where every split is empty
// (seq_lens == 0).  One thread per output element.
template <typename T>
__global__ void paged_attn_merge(const float* __restrict__ part,
                                 int64_t total, int h, int kvh, int dh,
                                 int n_split, T* __restrict__ out) {
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int g = h / kvh;
    const int d = (int)(idx % dh);
    const int64_t bh = idx / dh;
    const int hh = (int)(bh % h);
    const int64_t bk = (bh / h) * kvh + hh / g;
    const int r = hh % g;
    const int64_t stride = (int64_t)g * (dh + 2);
    const float* p0 = part + bk * n_split * stride;
    float big = -INFINITY;
    for (int s = 0; s < n_split; ++s) big = fmaxf(big, p0[s * stride + 2 * r]);
    if (big == -INFINITY) {                       // seq_lens == 0
        out[idx] = from_f<T>(0.0f);
        return;
    }
    float l = 0.0f, o = 0.0f;
    for (int s = 0; s < n_split; ++s) {
        const float* ps_ = p0 + s * stride;
        const float w = expf(ps_[2 * r] - big);   // 0 for an empty split
        l = __fmaf_rn(ps_[2 * r + 1], w, l);
        o = __fmaf_rn(ps_[2 * g + r * dh + d], w, o);
    }
    out[idx] = from_f<T>(o / l);
}

