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
// float32 rate per byte written.
//
// Design.  The TPU kernel pads the batch to BLOCK_P = 8 polytopes per
// grid step and builds the V x V lattice in VMEM.  Here a block takes a
// group of polytopes (as many as fill 256 threads with one thread per
// output slot), stages their V x D vertices in shared memory once, and
// classifies every vertex there (distance to the plane, on / below /
// above, with the per-polytope scale max(1, |x_k|max)).  Then every
// thread writes one slot's D coordinates and its mask byte.  No padding:
// the last block's group is simply shorter.
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

namespace {

constexpr float PLANE_TOL = 1e-6f;
constexpr int THREADS = 256;
enum : uint8_t { ON = 1, BELOW = 2, ABOVE = 4 };

__global__ void slice_batch_kernel(const float* __restrict__ verts,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ planes,
                                   int64_t p, int v, int d, int k, int group,
                                   float* __restrict__ out,
                                   uint8_t* __restrict__ mask) {
    extern __shared__ float smem[];
    float* s_verts = smem;                          // (group, v, d)
    float* s_dist = s_verts + group * v * d;        // (group, v)
    float* s_plane = s_dist + group * v;            // (group,)
    uint8_t* s_cls = reinterpret_cast<uint8_t*>(s_plane + group);

    const int64_t p0 = (int64_t)blockIdx.x * group;
    const int np = (int)(p - p0 < group ? p - p0 : group);
    const float* g_verts = verts + p0 * v * d;
    for (int e = threadIdx.x; e < np * v * d; e += blockDim.x)
        s_verts[e] = g_verts[e];
    for (int e = threadIdx.x; e < np; e += blockDim.x)
        s_plane[e] = planes[p0 + e];
    __syncthreads();

    // Classify every vertex of the group against its polytope's plane.
    for (int e = threadIdx.x; e < np * v; e += blockDim.x) {
        const int q = e / v;
        const float* pv = s_verts + q * v * d;
        float amax = 0.0f;
        for (int i = 0; i < v; ++i) {
            const float a = fabsf(pv[i * d + k]);
            amax = a > amax ? a : amax;
        }
        const float scale = 1.0f > amax ? 1.0f : amax;
        const float tol = PLANE_TOL * scale;
        const int i = e - q * v;
        const bool ok = valid[(p0 + q) * v + i] != 0;
        const float dist = ok ? pv[i * d + k] - s_plane[q] : INFINITY;
        uint8_t cls = 0;
        if (ok && fabsf(dist) <= tol) cls |= ON;
        if (ok && dist < -tol) cls |= BELOW;
        if (ok && dist > tol && isfinite(dist)) cls |= ABOVE;
        s_dist[e] = dist;
        s_cls[e] = cls;
    }
    __syncthreads();

    // One thread per output slot.
    const int slots = v + v * v;
    for (int e = threadIdx.x; e < np * slots; e += blockDim.x) {
        const int q = e / slots;
        const int s = e - q * slots;
        const float* pv = s_verts + q * v * d;
        const float plane = s_plane[q];
        const int64_t o = (p0 + q) * slots + s;
        float* dst = out + o * d;
        if (s < v) {
            const bool on = (s_cls[q * v + s] & ON) != 0;
            for (int c = 0; c < d; ++c)
                dst[c] = on ? (c == k ? plane : pv[s * d + c]) : 0.0f;
            mask[o] = on;
            continue;
        }
        const int i = (s - v) / v;
        const int j = (s - v) - i * v;
        const bool pair = (s_cls[q * v + i] & BELOW) != 0 &&
                          (s_cls[q * v + j] & ABOVE) != 0;
        if (pair) {
            const float di = s_dist[q * v + i];
            const float dj = s_dist[q * v + j];
            const float denom = di - dj;
            const float t = fabsf(denom) > 0.0f
                                ? di / (denom == 0.0f ? 1.0f : denom)
                                : 0.0f;
            for (int c = 0; c < d; ++c) {
                const float vi = pv[i * d + c];
                const float vj = pv[j * d + c];
                dst[c] = c == k ? plane : vi + t * (vj - vi);
            }
        } else {
            for (int c = 0; c < d; ++c) dst[c] = 0.0f;
        }
        mask[o] = pair;
    }
}

}  // namespace

// Shared memory one block of `group` polytopes needs.
static size_t smem_bytes(int group, int v, int d) {
    return (size_t)group * v * d * sizeof(float)
         + (size_t)group * v * sizeof(float) + (size_t)group * sizeof(float)
         + (size_t)group * v;
}

// verts (p, v, d) float32, valid (p, v) bool, planes (p,) float32;
// out (p, v + v*v, d) float32, mask (p, v + v*v) bool.  Returns
// cudaErrorInvalidValue when one block's vertices would not fit the
// 48 KB of shared memory a launch gets without opting in (V x D in the
// thousands; the BFS layers have V <= 32, D <= 8).
extern "C" int polytope_slice_batch(int device, const void* verts,
                                    const void* valid, const void* planes,
                                    int64_t p, int v, int d, int k,
                                    void* out, void* mask, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int slots = v + v * v;
    int group = THREADS / slots;
    group = group < 1 ? 1 : group;
    const size_t smem = smem_bytes(group, v, d);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (p + group - 1) / group;
    slice_batch_kernel<<<(unsigned)blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(verts), static_cast<const uint8_t*>(valid),
        static_cast<const float*>(planes), p, v, d, k, group,
        static_cast<float*>(out), static_cast<uint8_t*>(mask));
    return polytope_launch_status();
}
