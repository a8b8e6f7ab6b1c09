// Dynamic shared memory above the 48 KB that every kernel may use must be
// granted per kernel and device (cudaFuncSetAttribute) before the launch.
// The grant is remembered, one SharedGrant per kernel instance, so that a
// launch after the first costs no call to the runtime beyond cudaGetDevice,
// and a launch that stays within 48 KB costs none at all.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <mutex>

namespace {

constexpr size_t kDefaultSharedBytes = 48 * 1024;   // needs no grant
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB: the most a block can ask for
constexpr int kGrantDevices = 64;            // devices whose grant is remembered

struct SharedGrant {
  std::atomic<size_t> bytes[kGrantDevices] = {};   // granted so far, per device
  std::mutex lock;
};

// Make sure `kernel` may be launched with `bytes` of dynamic shared memory
// on the current device; more than a block can have is refused here, before
// any launch.
inline cudaError_t grant_shared(const void* kernel, size_t bytes, SharedGrant& grant) {
  if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSharedBytes) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool remembered = device >= 0 && device < kGrantDevices;
  if (remembered && grant.bytes[device].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  const std::lock_guard<std::mutex> hold(grant.lock);
  if (remembered && grant.bytes[device].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && remembered)
    grant.bytes[device].store(bytes, std::memory_order_release);
  return err;
}

}  // namespace
