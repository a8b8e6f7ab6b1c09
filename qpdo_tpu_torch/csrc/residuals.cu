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
// Dual-side arrays are (B, m), primal-side (B, n), sigma and cinv (B,);
// norms is (4, B) holding rp, rd, rpi, rdi.  All contiguous, float or
// double.
//
// Replaces the TPU kernel qpdo_tpu/ops/pallas_residuals.py:_kernel (l.47),
// which runs the block for the whole batch in VMEM in one launch.
//
// What bounds it on the H100: it is memory-bound and tiny.  At B=256,
// m=150, n=100 in double one call moves about 5 MB (14 input and 5 output
// vectors per problem), about 2 us at 3.35 TB/s, so the launch latency
// dominates.  The gain over plain tensor code is the ~20 elementwise and
// reduction launches this one replaces.
//
// Design: one block per problem.  The threads stride over the m dual
// entries and then the n primal entries, write the five vector outputs,
// and keep running maxima of the four norms; a warp-shuffle reduction and
// one pass through shared memory finish them.  The maximum propagates
// NaN, as jnp.max and torch.amax do (fmax would drop it).  Every product
// and sum is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, ...),
// never contracted into an FMA, in the operation order of the TPU kernel:
// the outputs are then bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Exact;

template <> struct Exact<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <> struct Exact<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
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
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
residuals_kernel(const T* __restrict__ Ax, const T* __restrict__ y,
                 const T* __restrict__ mu, const T* __restrict__ ybar,
                 const T* __restrict__ l, const T* __restrict__ u,
                 const T* __restrict__ E, const T* __restrict__ Einv,
                 const T* __restrict__ Qx, const T* __restrict__ q,
                 const T* __restrict__ Aty, const T* __restrict__ x,
                 const T* __restrict__ xbar, const T* __restrict__ Dinv,
                 const T* __restrict__ sigma, const T* __restrict__ cinv,
                 T* __restrict__ res_prim, T* __restrict__ res_prim_in,
                 T* __restrict__ w_out, T* __restrict__ active,
                 T* __restrict__ res_dual_in, T* __restrict__ norms,
                 int B, int m, int n) {
  using X = Exact<T>;
  const int b = blockIdx.x;
  const T civ = cinv[b];
  const T sig = sigma[b];
  T rp_n = T(0), rd_n = T(0), rpi_n = T(0), rdi_n = T(0);

  const size_t dual0 = static_cast<size_t>(b) * m;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const size_t o = dual0 + i;
    const T ax = Ax[o], yv = y[o], muv = mu[o], yb = ybar[o];
    const T lv = l[o], uv = u[o], ev = E[o], eiv = Einv[o];
    const T rp = X::sub(ax, clip(X::add(ax, X::mul(X::mul(X::mul(ev, ev), civ), yv)),
                                 lv, uv));
    const T wv = X::add(ax, X::mul(muv, X::sub(yb, X::mul(T(0.5), yv))));
    const T rpi = X::sub(X::add(ax, X::mul(muv, X::sub(yb, yv))), clip(wv, lv, uv));
    res_prim[o] = rp;
    res_prim_in[o] = rpi;
    w_out[o] = wv;
    active[o] = (wv <= lv || wv >= uv) ? T(1) : T(0);
    rp_n = nan_max(rp_n, fabs(X::mul(eiv, rp)));
    rpi_n = nan_max(rpi_n, fabs(X::mul(eiv, rpi)));
  }

  const size_t prim0 = static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const size_t o = prim0 + j;
    const T qx = Qx[o], qv = q[o], aty = Aty[o];
    const T xv = x[o], xb = xbar[o], div = Dinv[o];
    const T qxq = X::add(qx, qv);
    const T rdi = X::add(X::add(qxq, X::mul(sig, X::sub(xv, xb))), aty);
    res_dual_in[o] = rdi;
    rd_n = nan_max(rd_n, fabs(X::mul(div, X::add(qxq, aty))));
    rdi_n = nan_max(rdi_n, fabs(X::mul(div, rdi)));
  }

  __shared__ T partial[4][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  rp_n = warp_max(rp_n);
  rd_n = warp_max(rd_n);
  rpi_n = warp_max(rpi_n);
  rdi_n = warp_max(rdi_n);
  if (lane == 0) {
    partial[0][warp] = rp_n;
    partial[1][warp] = rd_n;
    partial[2][warp] = rpi_n;
    partial[3][warp] = rdi_n;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kThreads / 32;
    rp_n = warp_max(has ? partial[0][lane] : T(0));
    rd_n = warp_max(has ? partial[1][lane] : T(0));
    rpi_n = warp_max(has ? partial[2][lane] : T(0));
    rdi_n = warp_max(has ? partial[3][lane] : T(0));
    if (lane == 0) {
      norms[b] = rp_n;
      norms[B + b] = X::mul(rd_n, civ);
      norms[2 * static_cast<size_t>(B) + b] = rpi_n;
      norms[3 * static_cast<size_t>(B) + b] = X::mul(rdi_n, civ);
    }
  }
}

template <typename T>
int launch_residuals(void* const* p, int B, int m, int n, cudaStream_t stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  auto in = [&](int k) { return static_cast<const T*>(p[k]); };
  auto out = [&](int k) { return static_cast<T*>(p[k]); };
  residuals_kernel<T><<<B, kThreads, 0, stream>>>(
      in(0), in(1), in(2), in(3), in(4), in(5), in(6), in(7),
      in(8), in(9), in(10), in(11), in(12), in(13), in(14), in(15),
      out(16), out(17), out(18), out(19), out(20), out(21), B, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Argument order: Ax, y, mu, ybar, l, u, E, Einv, Qx, q, Aty, x, xbar,
// Dinv, sigma, cinv (inputs); res_prim, res_prim_in, w, active,
// res_dual_in, norms (outputs); B, m, n; stream.
#define QPDO_RESIDUALS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                        \
      const void* p0, const void* p1, const void* p2, const void* p3,         \
      const void* p4, const void* p5, const void* p6, const void* p7,         \
      const void* p8, const void* p9, const void* p10, const void* p11,       \
      const void* p12, const void* p13, const void* p14, const void* p15,     \
      void* o0, void* o1, void* o2, void* o3, void* o4, void* o5,             \
      int B, int m, int n, void* stream) {                                    \
    void* const p[22] = {                                                     \
        const_cast<void*>(p0), const_cast<void*>(p1), const_cast<void*>(p2),  \
        const_cast<void*>(p3), const_cast<void*>(p4), const_cast<void*>(p5),  \
        const_cast<void*>(p6), const_cast<void*>(p7), const_cast<void*>(p8),  \
        const_cast<void*>(p9), const_cast<void*>(p10), const_cast<void*>(p11),\
        const_cast<void*>(p12), const_cast<void*>(p13),                       \
        const_cast<void*>(p14), const_cast<void*>(p15),                       \
        o0, o1, o2, o3, o4, o5};                                              \
    return launch_residuals<T>(p, B, m, n, static_cast<cudaStream_t>(stream));\
  }

QPDO_RESIDUALS_ENTRY(qpdo_residuals_f32, float)
QPDO_RESIDUALS_ENTRY(qpdo_residuals_f64, double)
