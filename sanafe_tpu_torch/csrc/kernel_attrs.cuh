// Kernel attributes set once per process, device and value.
//
// cudaFuncSetAttribute holds for the process, so the launch functions ask
// for it only when a launch needs more than any earlier launch of the same
// kernel on the same device: a launch of the same or a smaller shared-memory
// size (each step of a scan, each replay of a captured graph, which replays
// the launch without calling the launch function at all) makes no call.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace sanafe {

// Set `attr` of `kernel` on the current device to `value`, unless an earlier
// call already did, or, for the dynamic shared-memory limit, set it higher.
inline cudaError_t set_kernel_attribute(const void* kernel,
                                        cudaFuncAttribute attr, int value) {
  static std::mutex mutex;
  static std::map<std::tuple<const void*, int, int>, int> set;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mutex);
  const auto key = std::make_tuple(kernel, device, static_cast<int>(attr));
  const auto found = set.find(key);
  if (found != set.end() &&
      (found->second == value ||
       (attr == cudaFuncAttributeMaxDynamicSharedMemorySize &&
        found->second > value))) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) set[key] = value;
  return err;
}

// The dynamic shared-memory limit of `kernel` raised to at least `bytes`.
inline cudaError_t reserve_smem(const void* kernel, size_t bytes) {
  return set_kernel_attribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace sanafe
