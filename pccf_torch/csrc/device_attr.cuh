// A kernel's function attribute (its dynamic shared memory limit, its
// non-portable cluster size), set once on each device.
//
// cudaFuncSetAttribute acts on the current device's context only, so a
// process that launches a kernel on several cards (the server's replicas)
// sets it on each: a launch site keeps one FuncAttr and calls it with the
// kernel before every launch, on the device the launch goes to.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

template <cudaFuncAttribute kAttr>
struct FuncAttr {
  static constexpr int kDevices = 64;
  std::atomic<bool> done[kDevices] = {};

  cudaError_t operator()(const void* kernel, int value) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
    if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, kAttr, value);
    if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
    return err;
  }
};

using MaxSmem = FuncAttr<cudaFuncAttributeMaxDynamicSharedMemorySize>;
