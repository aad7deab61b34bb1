// B4 slice_minor_extents: the slicing core shared by the planning
// kernels, as a device function.
//
// Replaces slice_minor_extents in the JAX package's kernels/slice/ref.py
// (line 31), which is not itself a pallas_call: it is the body that the
// plan_runs_2d pipeline and the batched slice_batch kernel both inline.
//
// Slicing a 2-D polytope with the plane x = plane leaves a segment of
// the kept coordinate y.  Its extents are the min and max over the
// on-plane vertices' y and over every (below, above) vertex pair's
// interpolated y_i + t * (y_j - y_i), t = d_i / (d_i - d_j).  The JAX
// version materialises the V x V pair lattice; here one thread walks
// the pairs in registers and keeps only the running min and max, which
// is exact because min and max do not depend on the order of visits.
//
// Exactness: every value is rounded as the float64 host planner rounds
// it (geometry.slice_vertices), one operation at a time.  That holds
// only when the file is compiled with --fmad=false: otherwise nvcc
// fuses y_i + t * (y_j - y_i) into an FMA and the last bit changes.
//
// Bound: operations, V^2 pair interpolations per (polytope, plane);
// V is a handful of vertices, so the work is tiny next to a launch.
#pragma once

#include <math.h>
#include <stdint.h>

template <typename T>
struct MinorExtents {
    T lo;
    T hi;
    bool hit;
};

// x, y: the vertices' sliced-axis and kept-axis coordinates, stride
// `stride` apart (interleaved (V, 2) storage passes x = v, y = v + 1,
// stride 2); valid: the vertex mask; tol: the absolute on-plane
// tolerance, already scaled by the caller.
template <typename T>
__device__ __forceinline__ MinorExtents<T> slice_minor_extents(
        const T* __restrict__ x, const T* __restrict__ y, int stride,
        const uint8_t* __restrict__ valid, int v, T plane, T tol) {
    const T big = (T)INFINITY;
    MinorExtents<T> out{big, -big, false};
    bool any_on = false, any_below = false, any_above = false;
    for (int i = 0; i < v; ++i) {
        if (!valid[i]) continue;
        const T d = x[i * stride] - plane;
        if (fabs(d) <= tol) {
            const T yi = y[i * stride];
            out.lo = yi < out.lo ? yi : out.lo;
            out.hi = yi > out.hi ? yi : out.hi;
            any_on = true;
        }
        any_below |= d < -tol;
        any_above |= (d > tol) && isfinite(d);
    }
    if (any_below && any_above) {
        for (int i = 0; i < v; ++i) {
            if (!valid[i]) continue;
            const T di = x[i * stride] - plane;
            if (!(di < -tol)) continue;
            const T yi = y[i * stride];
            for (int j = 0; j < v; ++j) {
                if (!valid[j]) continue;
                const T dj = x[j * stride] - plane;
                if (!((dj > tol) && isfinite(dj))) continue;
                const T denom = di - dj;
                const T t = di / (denom == (T)0 ? (T)1 : denom);
                const T yp = yi + t * (y[j * stride] - yi);
                out.lo = yp < out.lo ? yp : out.lo;
                out.hi = yp > out.hi ? yp : out.hi;
            }
        }
    }
    out.hit = any_on || (any_below && any_above);
    return out;
}
