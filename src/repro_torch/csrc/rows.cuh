// Shared by the row-summing kernels, B6 (gather.cu, gather_rows_bag) and
// B7 (segment_sum.cu): a row is read as packs of VEC elements by a
// group of 1-32 lanes of one warp, and ids are passed round the group
// with __shfl_sync.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// A row pack of VEC elements, aligned so that it loads and stores as one
// 8- or 16-byte access.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

static inline bool aligned(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The smallest power of two, up to 32, that covers `packs` packs.
static inline int group_for(int64_t packs) {
    int group = 1;
    while (group < 32 && group < packs) group <<= 1;
    return group;
}

// The lanes of this lane's group, for __shfl_sync.
__device__ __forceinline__ unsigned group_mask(int group) {
    const int lane = threadIdx.x & 31;
    return group == 32 ? 0xffffffffu
                       : ((1u << group) - 1u) << (lane & ~(group - 1));
}
