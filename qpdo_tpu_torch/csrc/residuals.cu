// Fused residual block of one solver step, for a batch of dense QPs:
//
//     res_prim    = Ax - clip(Ax + (E*E*cinv) y, l, u)
//     w           = Ax + mu (ybar - y/2)
//     res_prim_in = Ax + mu (ybar - y) - clip(w, l, u)
//     active      = (w <= l) | (w >= u)             (stored as 0/1 in T)
//     res_dual_in = Qx + q + sigma (x - xbar) + Aty
//     rp  = ||Einv * res_prim||_inf          rpi = ||Einv * res_prim_in||_inf
//     rd  = ||Dinv * (Qx + q + Aty)||_inf * cinv
//     rdi = ||Dinv * res_dual_in||_inf * cinv
//
// Dual-side inputs are (B, m), primal-side (B, n), sigma and cinv (B,), all
// contiguous, float or double.  The outputs go to one buffer, one after the
// other: res_prim, res_prim_in, w, active (B, m each), res_dual_in (B, n),
// rp, rd, rpi, rdi (B each).
//
// Replaces the TPU kernel qpdo_tpu/ops/pallas_residuals.py:_kernel (l.47),
// which runs the block for the whole batch in VMEM in one launch.
//
// What bounds it on the H100: it is memory-bound and small.  One call
// moves 12 m + 7 n + 6 words a problem: at m=150, n=100 that is 2.57 MB
// in float32 at B=256 (0.77 us at 3.35 TB/s) and 41 MB (12.3 us) at
// B=4096, twice that in float64.  At the bench batch the launch decides:
// the parent kernel (one block of 256 threads per problem, the dual loop,
// then the primal loop) took 2.3 us replayed in a CUDA graph, where a
// one-element ATen kernel takes about 1.2 us.  At B=4096, with its inputs
// read from HBM, it already reached 56% (float32) and 72% (float64) of
// its bound, so there the redesign's gain is bytes in flight, not the
// half of the bound (scripts/time_residuals.py on an H100).  The one-pass
// body alone is no faster than the parent's at B=256; programmatic launch
// is what takes its time down there, and only where a kernel ahead of it
// in the stream is still running when it is launched (a captured graph,
// or a host that runs ahead of the card).
//
// Design:
//  * One pass, one round trip to memory.  A problem's m + n entries are cut
//    into units of V consecutive entries (V = 16 or 8 bytes of T where the
//    row lengths and every pointer allow it, chosen at launch, else one
//    entry) and a group of `tp` threads (the power of two from 32 to 256
//    that covers the units) takes one unit a thread: dual units first, then
//    primal ones, so no thread sits out a phase and every load of a thread
//    (8 vectors on the dual side, 6 on the primal) is issued before any
//    arithmetic.
//  * Problems per block follow B: ceil(B / SMs), capped at 256 / tp, so a
//    small batch spreads over the SMs, and a large one gets full blocks.  The
//    grid is at most the blocks that are resident at once (launch bounds
//    promise kMinBlocks blocks of 256 threads an SM) and strides over the
//    groups of problems, so there is no ragged last wave.
//  * Programmatic dependent launch: the grid may be launched once the
//    blocks of the kernel ahead of it in the stream have exited, and waits
//    in `griddepcontrol.wait`, before its first access to memory, until
//    that kernel has completed and its writes are visible.
//  * The four maxima: warp shuffles (butterfly), then one pass through
//    shared memory (two buffers alternate between the groups a block
//    strides over, so one barrier a group suffices), and four threads of
//    each problem write its four norms.  The maximum propagates NaN, as
//    jnp.max and torch.amax do (fmax would drop it): a NaN in any input of
//    a problem reaches that problem's norms and no other problem's.
//  * Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
//    __fadd_rn, ...), never contracted into an FMA, in the operation order
//    of the TPU kernel: the outputs are bit-identical to the plain PyTorch
//    version, in float and in double.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 256;    // threads of a block
constexpr int kMinBlocks = 4;       // blocks of kMaxThreads an SM holds at once

template <typename T> struct Exact;

template <> struct Exact<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};

template <> struct Exact<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
};

// max that propagates NaN from either side
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// jnp.clip / torch.clamp: min(max(x, lo), hi), NaN in x propagates
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  const T t = x < lo ? lo : x;
  return t > hi ? hi : t;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Programmatic dependent launch (sm_90): the grid is launched before the
// kernel ahead of it in the stream has finished, and waits here, before its
// first access to global memory, until that kernel has completed and its
// writes are visible.
__device__ __forceinline__ void wait_for_prior_grids() {
#ifndef QPDO_CUDA_STUB
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
}

// V consecutive entries, moved by one load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int V, typename T>
__device__ __forceinline__ Vec<T, V> load(const T* __restrict__ p, size_t o) {
  return *reinterpret_cast<const Vec<T, V>*>(p + o);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
residuals_kernel(const T* __restrict__ Ax, const T* __restrict__ y,
                 const T* __restrict__ mu, const T* __restrict__ ybar,
                 const T* __restrict__ l, const T* __restrict__ u,
                 const T* __restrict__ E, const T* __restrict__ Einv,
                 const T* __restrict__ Qx, const T* __restrict__ q,
                 const T* __restrict__ Aty, const T* __restrict__ x,
                 const T* __restrict__ xbar, const T* __restrict__ Dinv,
                 const T* __restrict__ sigma, const T* __restrict__ cinv,
                 T* __restrict__ out, int B, int m, int n, int tp_shift,
                 int groups) {
  using X = Exact<T>;
  extern __shared__ __align__(16) unsigned char residuals_smem[];
  // partial[buffer][warp][norm]
  T* const partial = reinterpret_cast<T*>(residuals_smem);
  const int nwarps = blockDim.x >> 5;

  const int tp = 1 << tp_shift;                  // threads a problem
  const int per_block = blockDim.x >> tp_shift;  // problems a block takes
  const int slot = threadIdx.x >> tp_shift;      // this thread's problem
  const int t = threadIdx.x & (tp - 1);          // and its rank there
  const int warp = threadIdx.x >> 5;
  const int dual_units = m / V;
  const int units = dual_units + n / V;
  const size_t Bm = static_cast<size_t>(B) * m;
  T* const res_dual_in = out + 4 * Bm;
  T* const norms = res_dual_in + static_cast<size_t>(B) * n;

  wait_for_prior_grids();
  int buf = 0;
  for (int g = blockIdx.x; g < groups; g += gridDim.x, buf ^= 1) {
    const int b = g * per_block + slot;
    T rp_n = T(0), rd_n = T(0), rpi_n = T(0), rdi_n = T(0);
    T civ = T(0);
    if (b < B) {
      civ = cinv[b];
      const T sig = sigma[b];
      for (int k = t; k < units; k += tp) {
        if (k < dual_units) {
          const size_t o = static_cast<size_t>(b) * m + static_cast<size_t>(k) * V;
          const Vec<T, V> ax = load<V>(Ax, o), yv = load<V>(y, o),
                          muv = load<V>(mu, o), yb = load<V>(ybar, o),
                          lv = load<V>(l, o), uv = load<V>(u, o),
                          ev = load<V>(E, o), eiv = load<V>(Einv, o);
          Vec<T, V> rp, rpi, wv, act;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T a = ax.v[e], yy = yv.v[e], lo = lv.v[e], hi = uv.v[e];
            rp.v[e] = X::sub(a, clip(X::add(a, X::mul(X::mul(X::mul(ev.v[e], ev.v[e]),
                                                              civ), yy)), lo, hi));
            wv.v[e] = X::add(a, X::mul(muv.v[e], X::sub(yb.v[e], X::mul(T(0.5), yy))));
            rpi.v[e] = X::sub(X::add(a, X::mul(muv.v[e], X::sub(yb.v[e], yy))),
                              clip(wv.v[e], lo, hi));
            act.v[e] = (wv.v[e] <= lo || wv.v[e] >= hi) ? T(1) : T(0);
            rp_n = nan_max(rp_n, X::abs(X::mul(eiv.v[e], rp.v[e])));
            rpi_n = nan_max(rpi_n, X::abs(X::mul(eiv.v[e], rpi.v[e])));
          }
          *reinterpret_cast<Vec<T, V>*>(out + o) = rp;
          *reinterpret_cast<Vec<T, V>*>(out + Bm + o) = rpi;
          *reinterpret_cast<Vec<T, V>*>(out + 2 * Bm + o) = wv;
          *reinterpret_cast<Vec<T, V>*>(out + 3 * Bm + o) = act;
        } else {
          const size_t o = static_cast<size_t>(b) * n +
                           static_cast<size_t>(k - dual_units) * V;
          const Vec<T, V> qx = load<V>(Qx, o), qv = load<V>(q, o),
                          aty = load<V>(Aty, o), xv = load<V>(x, o),
                          xb = load<V>(xbar, o), div = load<V>(Dinv, o);
          Vec<T, V> rdi;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const T qxq = X::add(qx.v[e], qv.v[e]);
            rdi.v[e] = X::add(X::add(qxq, X::mul(sig, X::sub(xv.v[e], xb.v[e]))),
                              aty.v[e]);
            rd_n = nan_max(rd_n, X::abs(X::mul(div.v[e], X::add(qxq, aty.v[e]))));
            rdi_n = nan_max(rdi_n, X::abs(X::mul(div.v[e], rdi.v[e])));
          }
          *reinterpret_cast<Vec<T, V>*>(res_dual_in + o) = rdi;
        }
      }
    }

    // the problem's maxima: its warps by shuffles, then across them
    T* const part = partial + static_cast<size_t>(buf) * nwarps * 4;
    rp_n = warp_max(rp_n);
    rd_n = warp_max(rd_n);
    rpi_n = warp_max(rpi_n);
    rdi_n = warp_max(rdi_n);
    if ((threadIdx.x & 31) == 0) {
      part[warp * 4 + 0] = rp_n;
      part[warp * 4 + 1] = rd_n;
      part[warp * 4 + 2] = rpi_n;
      part[warp * 4 + 3] = rdi_n;
    }
    __syncthreads();
    if (t < 4 && b < B) {
      const int w0 = slot * (tp >> 5);
      T v = part[w0 * 4 + t];
      for (int k = 1; k < (tp >> 5); ++k) v = nan_max(v, part[(w0 + k) * 4 + t]);
      if (t & 1) v = X::mul(v, civ);            // rd and rdi
      norms[static_cast<size_t>(t) * B + b] = v;
    }
  }
}

template <typename T, int V>
int launch_width(const void* const* p, T* out, int B, int m, int n, int sms,
                 cudaStream_t stream) {
  const int units = m / V + n / V;
  int tp_shift = 5;
  while ((1 << tp_shift) < units && (1 << tp_shift) < kMaxThreads) ++tp_shift;
  const int tp = 1 << tp_shift;
  int per_block = (B + sms - 1) / sms;
  if (per_block > kMaxThreads / tp) per_block = kMaxThreads / tp;
  const int threads = per_block * tp;
  const int groups = (B + per_block - 1) / per_block;
  const int resident = sms * (kMinBlocks * kMaxThreads / threads);
  const int grid = groups < resident ? groups : resident;
  const size_t bytes = 2 * static_cast<size_t>(threads / 32) * 4 * sizeof(T);
  auto in = [&](int k) { return static_cast<const T*>(p[k]); };
  cudaLaunchAttribute attrs[1] = {};
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, residuals_kernel<T, V>, in(0), in(1), in(2), in(3), in(4),
      in(5), in(6), in(7), in(8), in(9), in(10), in(11), in(12), in(13),
      in(14), in(15), out, B, m, n, tp_shift, groups);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_residuals(const void* const* p, void* out_ptr, int B, int m, int n,
                     cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  T* const out = static_cast<T*>(out_ptr);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one load moves `bytes` where every row starts on that many bytes: the
  // 14 row inputs and the output (res_dual_in follows 4 B m entries)
  auto fits = [&](size_t bytes) {
    if ((m * sizeof(T)) % bytes != 0 || (n * sizeof(T)) % bytes != 0) return false;
    for (int k = 0; k < 14; ++k)
      if (reinterpret_cast<size_t>(p[k]) % bytes != 0) return false;
    return reinterpret_cast<size_t>(out) % bytes == 0;
  };
  if (fits(16)) return launch_width<T, 16 / sizeof(T)>(p, out, B, m, n, sms, stream);
  if (fits(8)) return launch_width<T, 8 / sizeof(T)>(p, out, B, m, n, sms, stream);
  return launch_width<T, 1>(p, out, B, m, n, sms, stream);
}

}  // namespace

// Argument order: Ax, y, mu, ybar, l, u, E, Einv, Qx, q, Aty, x, xbar,
// Dinv, sigma, cinv (inputs); out (4 B m + B n + 4 B, the outputs in the
// order above); B, m, n; stream.
#define QPDO_RESIDUALS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                        \
      const void* p0, const void* p1, const void* p2, const void* p3,         \
      const void* p4, const void* p5, const void* p6, const void* p7,         \
      const void* p8, const void* p9, const void* p10, const void* p11,       \
      const void* p12, const void* p13, const void* p14, const void* p15,     \
      void* out, int B, int m, int n, void* stream) {                         \
    const void* const p[16] = {p0, p1, p2,  p3,  p4,  p5,  p6,  p7,           \
                               p8, p9, p10, p11, p12, p13, p14, p15};         \
    return launch_residuals<T>(p, out, B, m, n,                               \
                               static_cast<cudaStream_t>(stream));            \
  }

QPDO_RESIDUALS_ENTRY(qpdo_residuals_f32, float)
QPDO_RESIDUALS_ENTRY(qpdo_residuals_f64, double)
