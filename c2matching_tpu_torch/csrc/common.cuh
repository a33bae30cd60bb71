// Launch-time device queries shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace c2m {

// Streaming multiprocessors of the current device (0 if the query fails).
inline int sm_count() {
  int dev = 0;
  int n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// Blocks of `kernel` that one SM holds at once (at least 1).
template <typename Kernel>
inline int blocks_per_sm(Kernel kernel, int threads, size_t smem_bytes) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem_bytes) != cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

}  // namespace c2m
