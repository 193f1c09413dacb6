// Raising a kernel's dynamic shared memory limit past the default 48 KB,
// shared by csrc/cem.cu and csrc/nms_greedy.cu.
#pragma once

#include <cuda_runtime.h>

namespace {

// Raise kernel's limit to bytes once per device (bit d of done), so that a
// call costs the host no attribute call.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

}  // namespace
