// Paged decode attention on the tensor cores: kernel B8
// (paged_decode_attention) for bf16 with Dh in {16, 32, 64, 128} and
// G = H / KVH <= 16, the shapes of every LM configuration of the repo
// (GLM-4 9B G = 16, Granite G = 4, Yi and Arctic G = 7; Dh = 128).
// Other shapes and float32 take the CUDA-core kernel of paged_attn.cu.
//
// Replaces the Pallas kernel of the JAX package's
// kernels/paged_attn/kernel.py: paged_decode_attention
// (_paged_attn_kernel, the pallas_call at line 123).  Same function as
// paged_attn.cu: one decode token per sequence, q (B, H, Dh) against the
// pool (NP, KVH, PS, Dh) through block_table (B, PMAX) and seq_lens (B,),
// scores q.k / sqrt(Dh) and the softmax in float32, the output in bf16,
// zeros for seq_lens == 0, a NaN in a live slot kept.
//
// Bound on the H100: bytes.  G flops per byte of bf16 K/V, far below the
// ~295 at which the tensor cores would be the limit.  What bounded the
// CUDA-core kernel was its inner loops: two shared-memory loads per
// float32 FMA, and K/V loaded synchronously before any arithmetic.
//
// Design (split-KV flash decoding, as paged_attn.cu, with a new CTA):
// - A CTA of 4 warps takes one (sequence, KV head, split).  The split's
//   live tokens are cut into steps of 16 (one page at PS = 16); warp w
//   takes steps w, w + 4, w + 8, ... and keeps its own (m, l, O).  A
//   split walks at least min_pages pages (the wrapper's
//   TC_MIN_SPLIT_PAGES), so the split count adapts to each sequence's
//   live length on the card, with no read of the lengths on the host.
// - The G query rows, padded with zero rows to 16, are the A operand of
//   mma.sync.m16n8k16 (bf16 in, float32 accumulate), loaded into
//   registers once: Dh / 16 k-steps x 4 registers.  S = Q K^T takes Dh/16
//   x 2 products a step, K coming in as the B operand through ldmatrix
//   (a K row of Dh bf16 is the "col" layout of B).
// - Online softmax in registers: a row's max across the quad with
//   __shfl_xor_sync, expf (the build has no fast math), l summed in
//   float32 from the unrounded p.  P's C fragments are repacked into A
//   fragments (the FlashAttention-2 layout trick) and V comes in through
//   ldmatrix.trans.  P goes to the tensor cores as two bf16 halves,
//   hi = bf16(p) and lo = bf16(p - hi), two products each: P V then
//   carries ~16 bits of p, where one bf16 P would put the output within
//   0.0071 of its largest |value| against a 2^-7 = 0.0078 bound
//   (tests/test_torch_lm.py emulates both).  O (16 x Dh float32) stays
//   in registers: Dh / 8 n-tiles x 4 floats a thread.
// - K/V staged by cp.async.cg (16 bytes a copy) into a ring of NSTAGE
//   steps per warp, one commit group a step, NSTAGE - 1 steps ahead of
//   the MMAs: each warp's loads overlap its own products, with no CTA
//   barrier in the loop.  The 16-byte chunks of a row are XOR-swizzled
//   (chunk ^ row % 8) so that ldmatrix's 8 rows hit 8 bank groups.
// - Exact bytes: a lane computes a token's address from its table entry
//   only for a live token (pos < the split's end <= seq_lens); a dead
//   slot of the last step is a zero-fill copy (src-size 0) that reads
//   nothing, and its score is -inf.  No -1 entry and no page outside the
//   plan is read.
// - At the end the 4 warps' (m, l, O) meet in shared memory (reusing the
//   ring) and merge with the merge pass's formula; with one split the CTA
//   writes the output, with several its partial, which paged_attn_merge
//   (paged_attn.cuh) folds as for the CUDA-core kernel.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "paged_attn.cuh"

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int STEP = 16;      // tokens a step: one k-step of P V
constexpr int NSTAGE = 3;     // ring depth of each warp, in steps
constexpr int MAX_G = 16;     // the M of the mma tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes (nothing read) if !live.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool live) {
    const int n = live ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(addr) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// Two floats as bf16 (lo in the low half), and their rounding errors.
__device__ __forceinline__ void pack_hi_lo(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                   y - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
    return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(FULL, v, 1);
    return v + __shfl_xor_sync(FULL, v, 2);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a STEP x DH
// tile: chunks XOR-swizzled within each group of 8.
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
    constexpr int NCH = DH / 8;
    constexpr int MASK = (NCH < 8 ? NCH : 8) - 1;
    return row * DH + ((chunk ^ (row & MASK)) << 3);
}

template <int DH>
static inline size_t tc_smem_bytes() {
    const size_t ring = (size_t)TC_WARPS * NSTAGE * 2 * STEP * DH
                        * sizeof(__nv_bfloat16);
    const size_t merge = (size_t)TC_WARPS * MAX_G * (DH + 2) * sizeof(float);
    return ring > merge ? ring : merge;
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
paged_attn_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kp,
                     const __nv_bfloat16* __restrict__ vp,
                     const int* __restrict__ table,
                     const int* __restrict__ lens, int h, int kvh, int ps,
                     int pmax, int n_split, int min_pages,
                     float* __restrict__ part,
                     __nv_bfloat16* __restrict__ out) {
    constexpr int KS = DH / 16;               // k-steps of Q K^T
    constexpr int NT = DH / 8;                // n-tiles of O
    constexpr int NCH = DH / 8;               // 16-byte chunks a row
    constexpr int TILE = STEP * DH;           // elements of one K or V step
    constexpr int COPIES = STEP * NCH / 32;   // chunks a lane, K or V
    const int g = h / kvh;
    const int split = blockIdx.x % n_split;
    const int bk = blockIdx.x / n_split;      // b * kvh + k
    const int b = bk / kvh;
    const int k = bk % kvh;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int gid = lane >> 2;                // fragment row (and row + 8)
    const int tig = lane & 3;                 // fragment column pair

    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw)
                          + (size_t)warp * NSTAGE * 2 * TILE;

    const int len = lens[b];
    const int pages = (len + ps - 1) / ps;
    // At least min_pages a split: a short sequence leaves its last splits
    // empty rather than giving each warp a step or none.
    const int per_split = max((pages + n_split - 1) / n_split, min_pages);
    const int p_begin = split * per_split;
    const int p_end = min(p_begin + per_split, pages);
    const int tok_begin = p_begin * ps;
    const int tok_end = min(p_end * ps, len);
    const int n_steps = tok_end > tok_begin
                        ? (tok_end - tok_begin + STEP - 1) / STEP : 0;
    const int my_steps = n_steps > warp
                         ? (n_steps - warp + TC_WARPS - 1) / TC_WARPS : 0;

    // Q's A fragments: rows gid and gid + 8 of the group, zero past G.
    uint32_t qa[KS][4];
    {
        const __nv_bfloat16* qg = q + ((int64_t)b * h + (int64_t)k * g) * DH;
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qg + gid * DH);
        const uint32_t* r1 =
            reinterpret_cast<const uint32_t*>(qg + (gid + 8) * DH);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            const int c = (kk * 16 + 2 * tig) / 2;   // in bf16 pairs
            qa[kk][0] = gid < g ? r0[c] : 0u;
            qa[kk][1] = gid + 8 < g ? r1[c] : 0u;
            qa[kk][2] = gid < g ? r0[c + 4] : 0u;
            qa[kk][3] = gid + 8 < g ? r1[c + 4] : 0u;
        }
    }

    const int* tab = table + (int64_t)b * pmax;
    const int64_t page_stride = (int64_t)kvh * ps * DH;
    const int64_t head_off = (int64_t)k * ps * DH;

    // Copies of the warp's local step `i` into ring stage `stage`.
    auto load_step = [&](int i, int stage) {
        const int t0 = tok_begin + (warp + i * TC_WARPS) * STEP;
        // Lane j < STEP holds the pool offset of token t0 + j, if live.
        int64_t my_off = 0;
        int my_live = 0;
        if (lane < STEP) {
            const int pos = t0 + lane;
            if (pos < tok_end) {
                my_live = 1;
                my_off = (int64_t)tab[pos / ps] * page_stride + head_off
                         + (int64_t)(pos % ps) * DH;
            }
        }
        __nv_bfloat16* ks = ring + stage * 2 * TILE;
        __nv_bfloat16* vs = ks + TILE;
#pragma unroll
        for (int u = 0; u < COPIES; ++u) {
            const int e = lane + 32 * u;
            const int r = e / NCH;
            const int c = e % NCH;
            const int64_t off = __shfl_sync(FULL, my_off, r);
            const bool live = __shfl_sync(FULL, my_live, r) != 0;
            const int64_t src = live ? off + c * 8 : 0;
            cp_async16(smem_addr(ks + swz<DH>(r, c)), kp + src, live);
            cp_async16(smem_addr(vs + swz<DH>(r, c)), vp + src, live);
        }
    };

    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
        o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;     // rows gid, gid + 8
    float l0 = 0.0f, l1 = 0.0f;               // this lane's share of l
    const float scale = 1.0f / sqrtf((float)DH);
    // ldmatrix addresses: lane -> (matrix lane / 8, its row lane % 8).
    const int mat = lane >> 3;
    const int mrow = lane & 7;

#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) {
        if (i < my_steps) load_step(i, i);
        cp_async_commit();
    }
    for (int i = 0; i < my_steps; ++i) {
        const int ahead = i + NSTAGE - 1;
        if (ahead < my_steps) load_step(ahead, ahead % NSTAGE);
        cp_async_commit();
        cp_async_wait<NSTAGE - 1>();          // step i has landed
        __syncwarp();
        const __nv_bfloat16* ks = ring + (i % NSTAGE) * 2 * TILE;
        const __nv_bfloat16* vs = ks + TILE;
        const int t0 = tok_begin + (warp + i * TC_WARPS) * STEP;

        // S = Q K^T: n-tile 0 is tokens 0-7 of the step, n-tile 1 8-15.
        float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(smem_addr(ks + swz<DH>((mat >> 1) * 8 + mrow,
                                           2 * kk + (mat & 1))),
                    b0, b1, b2, b3);
            mma_bf16(s[0], qa[kk], b0, b1);
            mma_bf16(s[1], qa[kk], b2, b3);
        }
        // Scale, mask the dead slots, and the online softmax update.
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const bool live = t0 + nt * 8 + 2 * tig + j < tok_end;
                s[nt][j] = live ? s[nt][j] * scale : -INFINITY;
                s[nt][2 + j] = live ? s[nt][2 + j] * scale : -INFINITY;
                mx0 = fmaxf(mx0, s[nt][j]);
                mx1 = fmaxf(mx1, s[nt][2 + j]);
            }
        }
        // Every step holds a live token, so the new maxima are finite.
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float alpha0 = expf(m0 - mn0);
        const float alpha1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        uint32_t ph[4], pl[4];                // P as A fragments, hi and lo
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const float p00 = expf(s[nt][0] - mn0);
            const float p01 = expf(s[nt][1] - mn0);
            const float p10 = expf(s[nt][2] - mn1);
            const float p11 = expf(s[nt][3] - mn1);
            rs0 += p00 + p01;
            rs1 += p10 + p11;
            pack_hi_lo(p00, p01, ph[2 * nt], pl[2 * nt]);
            pack_hi_lo(p10, p11, ph[2 * nt + 1], pl[2 * nt + 1]);
        }
        l0 = l0 * alpha0 + rs0;
        l1 = l1 * alpha1 + rs1;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            o[nt][0] *= alpha0;
            o[nt][1] *= alpha0;
            o[nt][2] *= alpha1;
            o[nt][3] *= alpha1;
        }
        // O += P V: V's rows are the k dimension, read transposed.
#pragma unroll
        for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_trans(smem_addr(vs + swz<DH>((mat & 1) * 8 + mrow,
                                                 2 * n2 + (mat >> 1))),
                          b0, b1, b2, b3);
            mma_bf16(o[2 * n2], ph, b0, b1);
            mma_bf16(o[2 * n2], pl, b0, b1);
            mma_bf16(o[2 * n2 + 1], ph, b2, b3);
            mma_bf16(o[2 * n2 + 1], pl, b2, b3);
        }
        __syncwarp();                         // the stage may be refilled
    }
    cp_async_wait<0>();
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // The warps' (m, l, O) in shared memory, over the rings.
    __syncthreads();
    float* mw = reinterpret_cast<float*>(smem_raw);   // TC_WARPS x 16
    float* lw = mw + TC_WARPS * MAX_G;                // TC_WARPS x 16
    float* ow = lw + TC_WARPS * MAX_G;                // TC_WARPS x 16 x DH
    if (tig == 0) {
        mw[warp * MAX_G + gid] = m0;
        mw[warp * MAX_G + gid + 8] = m1;
        lw[warp * MAX_G + gid] = l0;
        lw[warp * MAX_G + gid + 8] = l1;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        float* r0 = ow + (warp * MAX_G + gid) * DH + nt * 8 + 2 * tig;
        float* r1 = r0 + 8 * DH;
        r0[0] = o[nt][0];
        r0[1] = o[nt][1];
        r1[0] = o[nt][2];
        r1[1] = o[nt][3];
    }
    __syncthreads();

    float* pt = part + ((int64_t)bk * n_split + split) * g * (DH + 2);
    __nv_bfloat16* og = out + ((int64_t)b * h + (int64_t)k * g) * DH;
    for (int e = threadIdx.x; e < g * DH; e += TC_THREADS) {
        const int r = e / DH;
        const int d = e - r * DH;
        float big = -INFINITY;
#pragma unroll
        for (int w = 0; w < TC_WARPS; ++w)
            big = fmaxf(big, mw[w * MAX_G + r]);
        float l = 0.0f, acc = 0.0f;
        if (big != -INFINITY) {               // else an empty split
#pragma unroll
            for (int w = 0; w < TC_WARPS; ++w) {
                const float wt = expf(mw[w * MAX_G + r] - big);
                l = __fmaf_rn(lw[w * MAX_G + r], wt, l);
                acc = __fmaf_rn(ow[(w * MAX_G + r) * DH + d], wt, acc);
            }
        }
        if (n_split == 1) {
            // Zeros only for an empty sequence: a NaN in a live slot stays.
            og[e] = from_f<__nv_bfloat16>(len > 0 ? acc / l : 0.0f);
        } else {
            pt[2 * g + e] = acc;
            if (d == 0) {
                pt[2 * r] = big;
                pt[2 * r + 1] = l;
            }
        }
    }
}

template <int DH>
static int launch_tc(const void* q, const void* kp, const void* vp,
                     const void* table, const void* lens, int b, int h,
                     int kvh, int ps, int pmax, int n_split, int min_pages,
                     void* part, void* out, cudaStream_t stream) {
    const size_t smem = tc_smem_bytes<DH>();
    cudaError_t err = cudaFuncSetAttribute(
        paged_attn_tc_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        cudaGetLastError();        // leave no error for the next launch
        return (int)err;
    }
    using B16 = __nv_bfloat16;
    const unsigned blocks = (unsigned)((int64_t)b * kvh * n_split);
    paged_attn_tc_kernel<DH><<<blocks, TC_THREADS, smem, stream>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(kp),
        static_cast<const B16*>(vp), static_cast<const int*>(table),
        static_cast<const int*>(lens), h, kvh, ps, pmax, n_split, min_pages,
        static_cast<float*>(part), static_cast<B16*>(out));
    err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return (int)err;
    const int64_t total = (int64_t)b * h * DH;
    const int threads = 256;
    paged_attn_merge<B16><<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, stream>>>(
        static_cast<const float*>(part), total, h, kvh, DH, n_split,
        static_cast<B16*>(out));
    return polytope_launch_status();
}

// bf16 q (b, h, dh), pages (np, kvh, ps, dh), all 16-byte aligned, with
// dh in {16, 32, 64, 128} and h / kvh <= 16; table (b, pmax) and lens
// (b,) int32, every live entry a valid page; split s of a sequence of P
// live pages walks pages [s * per, (s + 1) * per), per = max(ceil(P /
// n_split), min_pages), min_pages >= 1; part: b * kvh * n_split *
// (h / kvh) * (dh + 2) floats when n_split > 1 (else unused); out (b, h,
// dh) bf16.  Any other shape is refused (cudaErrorInvalidValue).
extern "C" int polytope_paged_decode_attention_tc(
        int device, const void* q, const void* kp, const void* vp,
        const void* table, const void* lens, int b, int h, int kvh, int dh,
        int ps, int pmax, int n_split, int min_pages, void* part, void* out,
        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto a16 = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    if (kvh <= 0 || h % kvh || h / kvh > MAX_G || min_pages < 1 || !a16(q)
        || !a16(kp) || !a16(vp))
        return (int)cudaErrorInvalidValue;
    switch (dh) {
        case 16: return launch_tc<16>(q, kp, vp, table, lens, b, h, kvh, ps,
                                      pmax, n_split, min_pages, part, out,
                                      st);
        case 32: return launch_tc<32>(q, kp, vp, table, lens, b, h, kvh, ps,
                                      pmax, n_split, min_pages, part, out,
                                      st);
        case 64: return launch_tc<64>(q, kp, vp, table, lens, b, h, kvh, ps,
                                      pmax, n_split, min_pages, part, out,
                                      st);
        case 128: return launch_tc<128>(q, kp, vp, table, lens, b, h, kvh,
                                        ps, pmax, n_split, min_pages, part,
                                        out, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
