// B4 slice_minor_extents as a kernel of its own.
//
// The slicing core of slice_extents.cuh, which the planning kernel
// (plan_runs_2d.cu) inlines, launched on its own for the batched
// planner (core/batched.py, batched_plan_2d): the JAX package calls
// slice_minor_extents of its kernels/slice/ref.py (line 31) there at the
// top level, outside any pallas_call.  Each of B polytopes is cut by R
// planes; one thread per (polytope, plane) walks the vertex pairs in
// registers and writes the kept coordinate's extents and the hit flag.
//
// Bound on the H100: bytes at the batched planner's sizes (a few vertices
// per polytope, so a few dozen float operations per 9-byte output),
// though launch latency dominates any one call.
//
// Exactness: compiled with --fmad=false like every kernel here, so each
// interpolation rounds as the plain PyTorch version's does.  Templated
// on float (the batched planner's regime) and double.
#include "common.cuh"
#include "slice_extents.cuh"

template <typename T>
__global__ void slice_extents_kernel(const T* __restrict__ x,
                                     const T* __restrict__ y,
                                     const uint8_t* __restrict__ valid,
                                     const T* __restrict__ planes,
                                     const T* __restrict__ tol, int64_t b,
                                     int v, int r, T* __restrict__ lo,
                                     T* __restrict__ hi,
                                     uint8_t* __restrict__ hit) {
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= b * r) return;
    const int64_t q = e / r;
    const MinorExtents<T> m = slice_minor_extents<T>(
        x + q * v, y + q * v, 1, valid + q * v, v, planes[e], tol[q]);
    lo[e] = m.lo;
    hi[e] = m.hi;
    hit[e] = m.hit;
}

template <typename T>
static void launch(const void* x, const void* y, const void* valid,
                   const void* planes, const void* tol, int64_t b, int v,
                   int r, void* lo, void* hi, void* hit, cudaStream_t s) {
    const int threads = 256;
    const int64_t blocks = (b * r + threads - 1) / threads;
    slice_extents_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const uint8_t*>(valid), static_cast<const T*>(planes),
        static_cast<const T*>(tol), b, v, r, static_cast<T*>(lo),
        static_cast<T*>(hi), static_cast<uint8_t*>(hit));
}

// x, y, valid (b, v); planes (b, r); tol (b,); lo, hi, hit (b, r).
extern "C" int polytope_slice_minor_extents(
        int device, int is_f64, const void* x, const void* y,
        const void* valid, const void* planes, const void* tol, int64_t b,
        int v, int r, void* lo, void* hi, void* hit, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f64)
        launch<double>(x, y, valid, planes, tol, b, v, r, lo, hi, hit, s);
    else
        launch<float>(x, y, valid, planes, tol, b, v, r, lo, hi, hit, s);
    return polytope_launch_status();
}
