// Shared by every kernel library: launch-status reporting.
//
// Each C entry point launches on the caller's stream (PyTorch's current
// stream, passed as a void*), never synchronises, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused
// launch (too many threads, bad grid) that a later synchronize would
// never report.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* polytope_error_string(int status) {
    return cudaGetErrorString(static_cast<cudaError_t>(status));
}

static inline int polytope_launch_status() {
    return static_cast<int>(cudaGetLastError());
}
