// A kernel's cap on dynamic shared memory, raised once a device, for the
// launchers of roi_align_staged.cuh, nms.cu, roi_align_backward.cu and
// int8_gemm.cu. cudaFuncSetAttribute runs only where the cap of (kernel,
// device) must rise: a launch at a size launched before makes no runtime
// call, so a launch captured into a CUDA graph after its warm-up at the
// same shapes makes none either (a capture in global mode may refuse the
// call; utils/graphs.py warms up before every capture).

#pragma once

#include <map>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

inline cudaError_t raise_smem_cap(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> caps;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  int& cap = caps[{kernel, device}];
  if (bytes <= cap) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) cap = bytes;
  return err;
}
