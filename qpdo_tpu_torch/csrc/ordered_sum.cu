// The ordered segment sum of the sparse path, float32 and float64:
//
//     out[b, t] = ((0 + v[b, o[s_t]]) + v[b, o[s_t + 1]]) + ...
//
// for s from s_t = offsets[t] to offsets[t + 1] - 1: every target t adds its
// terms v[b, k] (k with index[k] = t) in map order, the order in which CPU
// index_add_ adds them, one term at a time from 0.  `order` holds the term
// indices sorted by target with a stable sort, `offsets` (out + 1) the first
// term of each target (qpdo_tpu_torch/solver/sparse.py:_segment_map builds
// both at setup).
//
// Replaces no TPU kernel.  The JAX package adds these terms with
// `.at[].add`, which XLA runs on the TPU in a fixed order.  On the card
// index_add_ adds with atomics, whose order changes from run to run, so the
// block-Jacobi blocks, the coarse matrix and its restriction, the banded
// route's blocks, diag(K) and the scatter matvecs lost their last bits and
// CG its iteration counts from one run to the next.  This kernel gives the
// card the bits of the CPU's index_add_ over the same terms, with no
// atomics.
//
// What bounds it on the H100: bytes (each term, its index and each offset
// read once, each target written once; one add a term).  Design: one
// thread per (problem, target), its terms in a serial chain of adds, which
// is what fixes the order; the loads of a chain are independent of the
// adds, so the loop is unrolled to keep several in flight.  A target with
// many terms is a long chain (a dense column of A): it runs once per Newton
// step.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ordered_sum_kernel(const T* __restrict__ v, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ offsets, T* __restrict__ out,
                   int B, int64_t terms, int targets) {
  const int64_t total = static_cast<int64_t>(B) * targets;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t b = e / targets;
    const int64_t t = e - b * targets;
    const T* vb = v + b * terms;
    const int64_t end = offsets[t + 1];
    T acc = T(0);
#pragma unroll 8
    for (int64_t s = offsets[t]; s < end; ++s) acc += vb[order[s]];
    out[e] = acc;
  }
}

template <typename T>
int launch_ordered_sum(const void* v, const void* order, const void* offsets,
                       void* out, int B, int terms, int targets,
                       cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * targets;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < (1 << 30) ? want : (1 << 30));
  ordered_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(offsets), static_cast<T*>(out), B, terms,
      targets);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v: (B, terms); order: (terms,) int64; offsets: (targets + 1,) int64;
// out: (B, targets).
extern "C" int qpdo_ordered_sum_f32(const void* v, const void* order,
                                    const void* offsets, void* out, int B,
                                    int terms, int targets, void* stream) {
  return launch_ordered_sum<float>(v, order, offsets, out, B, terms, targets,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int qpdo_ordered_sum_f64(const void* v, const void* order,
                                    const void* offsets, void* out, int B,
                                    int terms, int targets, void* stream) {
  return launch_ordered_sum<double>(v, order, offsets, out, B, terms, targets,
                                    static_cast<cudaStream_t>(stream));
}
