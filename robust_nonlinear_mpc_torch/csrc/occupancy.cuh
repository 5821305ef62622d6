// What a kernel costs the SM: registers per thread, static and dynamic
// shared memory per block, local (spill) bytes per thread, and how many of
// its blocks stay resident on one SM at that shared-memory size. Each
// source exports one `rnm_<kernel>_info_<type>(const int* dims, int* out)`
// built on this, with dims = (N, nx, nu, ni, ni_f, nw), so the numbers are
// those of the instantiation and the shared-memory size that a launch at
// these widths would use.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rnm {

constexpr int INFO_WORDS = 5;

// out = (registers per thread, static shared bytes, dynamic shared bytes,
//        local bytes per thread, resident blocks per SM)
template <typename Kern>
int kernel_info(Kern* kernel, int threads, size_t dyn_smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (dyn_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn_smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)dyn_smem;
  out[3] = (int)fa.localSizeBytes;
  out[4] = blocks;
  return 0;
}

}  // namespace rnm
