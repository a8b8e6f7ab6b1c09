// Pieces shared by the kernels of this directory: 16-byte packs for
// vector loads and stores, and asynchronous global -> shared copies
// (cp.async), which do not pass through registers and let a block load its
// next stage while it computes on this one.
//
// Under QPDO_CUDA_STUB (a host build against a stand-in cuda_runtime.h, one
// host thread per CUDA thread) the copies are plain and synchronous.

#pragma once

#include <cuda_runtime.h>

namespace {

// 16 bytes of T, moved by one load or store
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

template <typename T, int N>
__device__ __forceinline__ void load_packs(const T* p, T (&out)[N]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < N / V; ++q) {
    const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(p + q * V);
#pragma unroll
    for (int e = 0; e < V; ++e) out[q * V + e] = pk.v[e];
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_packs(T* p, const T (&in)[N]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < N / V; ++q) {
    Pack<T> pk;
#pragma unroll
    for (int e = 0; e < V; ++e) pk.v[e] = in[q * V + e];
    *reinterpret_cast<Pack<T>*>(p + q * V) = pk;
  }
}

// global -> shared copy of kBytes (4, 8 or 16) that does not pass through
// registers and completes asynchronously
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#ifdef QPDO_CUDA_STUB
  __builtin_memcpy(dst, src, kBytes);
#else
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr), "l"(src), "n"(kBytes));
#endif
}

__device__ __forceinline__ void copy_async_commit() {
#ifndef QPDO_CUDA_STUB
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most kPending of the committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void copy_async_wait() {
#ifndef QPDO_CUDA_STUB
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
#endif
}

}  // namespace
