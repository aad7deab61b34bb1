// B5 slice_batch: one BFS layer of Algorithm 1 sliced as a batch.
//
// Replaces the Pallas kernel of the JAX package's kernels/slice/kernel.py
// (slice_batch / _slice_kernel, the pallas_call at line 73).  Each
// polytope p of the layer is cut by its own plane x_k = planes[p]:
//   slot s < V           vertex s when it lies on the plane (coordinate
//                        k snapped onto the plane);
//   slot V + i * V + j   the point where the edge from vertex i (below)
//                        to vertex j (above) crosses the plane,
//                        v_i + t * (v_j - v_i), t = d_i / (d_i - d_j);
// with a mask of the slots that hold a point.  Masked slots hold +0.0.
//
// Bound on the H100: bytes.  The (P, V + V^2, D) output dominates and
// each slot costs a handful of float operations, far below the card's
// float32 rate per byte written; at a BFS layer's size (P ~ 10^3, V = 4)
// the time is one launch's latency.
//
// Design.  A thread per output slot, with no shared memory and no
// barrier.  Each thread issues its loads together, all served from L1
// after the first warp of a polytope: the polytope's V coordinates on
// axis k (for the scale max(1, |x_k|max) and the tolerance), its plane,
// and its one or two vertices' coordinates and mask bytes.  It then
// classifies them (on / below / above) and writes its slot's D
// coordinates as one vector store where D allows (float4 for D % 4 == 0,
// float2 for D % 2 == 0; scalars otherwise) and its mask byte.  Blocks
// of 128 threads: a layer of 959 polytopes at V = 4 (20 slots each) is
// 150 blocks, more than the card's 132 SMs.  Any V and D: nothing is
// staged.  (The TPU kernel pads the batch to 8 polytopes a grid step and
// builds the V x V lattice in VMEM.)
//
// Exactness: the plain PyTorch version (kernels/slice/ref.py) is held
// byte for byte against this kernel, so every value is rounded one
// operation at a time, as there: compiled with --fmad=false, so
// v_i + t * (v_j - v_i) is not fused into an FMA, and without
// --use_fast_math, so d_i / denom is the IEEE-rounded quotient.  A
// vertex with a non-finite distance is never "above" (the reference's
// isfinite test; the TPU kernel's dist < 1e30 is not followed).
#include <math.h>

#include "common.cuh"
#include "rows.cuh"

namespace {

constexpr float PLANE_TOL = 1e-6f;
constexpr int THREADS = 128;

template <int VEC>
__global__ void slice_batch_kernel(const float* __restrict__ verts,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ planes,
                                   int64_t p, int v, int d, int k,
                                   float* __restrict__ out,
                                   uint8_t* __restrict__ mask) {
    const int64_t slots = v + (int64_t)v * v;
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= p * slots) return;
    const int64_t q = e / slots;
    const int s = (int)(e - q * slots);
    const float* pv = verts + q * v * d;
    const uint8_t* pm = valid + q * v;
    const float plane = planes[q];

    float amax = 0.0f;
    for (int i = 0; i < v; ++i) {
        const float a = fabsf(pv[i * d + k]);
        amax = a > amax ? a : amax;
    }
    const float scale = 1.0f > amax ? 1.0f : amax;
    const float tol = PLANE_TOL * scale;

    // Slot s < v: vertex s on the plane.  Else the pair (i below, j above).
    const bool single = s < v;
    const int i = single ? s : (s - v) / v;
    const int j = single ? s : (s - v) - i * v;
    const bool ok_i = pm[i] != 0, ok_j = pm[j] != 0;
    const float di = ok_i ? pv[i * d + k] - plane : INFINITY;
    const float dj = ok_j ? pv[j * d + k] - plane : INFINITY;
    bool live;
    float t = 0.0f;
    if (single) {
        live = ok_i && fabsf(di) <= tol;
    } else {
        live = ok_i && di < -tol && ok_j && dj > tol && isfinite(dj);
        const float denom = di - dj;
        t = fabsf(denom) > 0.0f ? di / (denom == 0.0f ? 1.0f : denom)
                                : 0.0f;
    }

    float* dst = out + e * d;
    for (int c0 = 0; c0 < d; c0 += VEC) {
        Pack<float, VEC> pk;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
            const int c = c0 + u;
            float x = 0.0f;
            if (live) {
                const float vi = pv[i * d + c];
                x = c == k ? plane
                           : (single ? vi : vi + t * (pv[j * d + c] - vi));
            }
            pk.v[u] = x;
        }
        *reinterpret_cast<Pack<float, VEC>*>(dst + c0) = pk;
    }
    mask[e] = live;
}

template <int VEC>
void launch(const void* verts, const void* valid, const void* planes,
            int64_t p, int v, int d, int k, void* out, void* mask,
            cudaStream_t s) {
    const int64_t total = p * (v + (int64_t)v * v);
    const int64_t blocks = (total + THREADS - 1) / THREADS;
    slice_batch_kernel<VEC><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(verts), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(planes), p, v, d, k,
        static_cast<float*>(out), static_cast<uint8_t*>(mask));
}

}  // namespace

// verts (p, v, d) float32, valid (p, v) bool, planes (p,) float32;
// out (p, v + v*v, d) float32, mask (p, v + v*v) bool.
extern "C" int polytope_slice_batch(int device, const void* verts,
                                    const void* valid, const void* planes,
                                    int64_t p, int v, int d, int k,
                                    void* out, void* mask, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d % 4 == 0 && aligned(out, 16))
        launch<4>(verts, valid, planes, p, v, d, k, out, mask, s);
    else if (d % 2 == 0 && aligned(out, 8))
        launch<2>(verts, valid, planes, p, v, d, k, out, mask, s);
    else
        launch<1>(verts, valid, planes, p, v, d, k, out, mask, s);
    return polytope_launch_status();
}
