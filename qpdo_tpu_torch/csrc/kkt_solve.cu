// Fused Newton KKT solve for a batch of dense QPs, float32, and the
// Cholesky solve of an already formed matrix.
//
// kkt_solve (one launch per batch; per problem b):
//
//     K    = Q + sigma*I + A' diag(w) A
//     dinv = 1/sqrt(diag K) where diag K > 0, else 1
//     Khat = dinv K dinv + 100*eps32*I
//     R    = chol(Khat)  (upper factor, pivot max(d, 1e-30), NaN kept)
//     R'z  = dinv * rhs;   R x = z;   dx = dinv * x
//
// with Q (B, n, n), A (B, m, n), w (B, m), sigma (B,), rhs (B, n) ->
// dx (B, n), row-major and contiguous.
//
// chol_solve: K (B, n, n) symmetric (only its upper triangle is read),
// rhs (B, n) -> dx (B, n) with K dx = rhs, by the same factorization and
// substitutions; here the divisors of both substitutions are clamped at
// 1e-30 as well as the pivots.
//
// Replaces the TPU kernels qpdo_tpu/ops/pallas_kkt.py:_kkt_kernel (l.40)
// and :_stacked_chol_kernel (l.209).  Those keep one problem's K (or eight
// of them, stacked on the sublane axis) in VMEM and run the recurrence as
// masked whole-matrix updates; neither the padding to 128 lanes nor the
// stacking is carried over.
//
// What bounds them on the H100: at the bench shape (B=256, m=150, n=100)
// kkt_solve does 0.86 GFLOP over 25.7 MB, so its floor is the float32
// SIMT rate (about 13 us); chol_solve moves 10.4 MB for 0.09 GFLOP, so
// its floor is memory (about 3 us).  Neither gets near its floor: the
// factor is n dependent steps with a block-wide barrier each, and the
// back-substitution is n dependent dot products.  What the design buys is
// one launch instead of the dozen of the torch.linalg route, and no K,
// no w∘A and no factor in device memory.
//
// Design: one block of 256 threads per problem, Khat in dynamic shared
// memory with an odd row stride (columns and rows both conflict-free).
//  * Formation: Ks starts as Q + sigma*I; A is streamed through a 32-row
//    stage; each thread owns strided 4x4 micro-tiles of K (rows ti + r*T,
//    columns tj + c*T with T = ceil(n/4)), so a warp reads consecutive
//    columns, and adds a stage's products to Ks.  The product order is
//    A[k,i] * (w[k] * A[k,j]), as in formation.cu.
//  * Factor: right-looking, row by row, on the upper triangle only.  Step
//    j reads row j unscaled and applies (K[j,i]*r) * (K[j,k]*r) with
//    r = 1/sqrt(pivot) to rows i > j, each warp four rows at a time.  Row
//    j itself is never rewritten (r is kept in rinv[j] and applied where
//    R is read), so one barrier per step suffices.  The forward
//    substitution rides the same step: z_j = b_j / R[j,j] and
//    b_k -= z_j R[j,k], the order of the TPU kernel.
//  * Back-substitution: warp 0 alone; each lane carries the partial sums
//    of its own rows in registers, so a step is one broadcast, one
//    division and one column of updates.
// Every __syncthreads() is reached by all threads unconditionally.
// max(d, 1e-30) keeps a NaN pivot NaN (fmaxf would drop it), so a failed
// problem comes back non-finite and its neighbours are untouched.

#include <cuda_runtime.h>

namespace {

// block size and rows per warp pass: scripts/tune_kkt_solve.py times others
#ifndef QPDO_KKT_THREADS
#define QPDO_KKT_THREADS 256
#endif
#ifndef QPDO_KKT_ROWS
#define QPDO_KKT_ROWS 4
#endif
constexpr int kThreads = QPDO_KKT_THREADS;
constexpr int kRows = QPDO_KKT_ROWS;       // rows of K a warp updates at once
constexpr int kMaxChunks = 8;              // 32-row chunks of K: n <= 256
constexpr int kStage = 32;                 // rows of A per shared-memory stage
constexpr int kMicro = 4;                  // edge of a thread's micro-tile
constexpr float kTiny = 1e-30f;
constexpr float kReg = 100.0f * 1.1920928955078125e-07f;   // 100 * eps32
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB: the most a block can ask for

// max(a, t) that keeps a NaN in a (jnp.maximum, torch.clamp)
__device__ __forceinline__ float nan_max(float a, float t) {
  return (a < t) ? t : a;
}

// Factor Ks (n x n, row stride ld, upper triangle, already scaled) and
// solve Ks x = b.  b, z, x and rinv are n floats each in shared memory; b
// is consumed.  Ends with a block-wide barrier: x is complete for every
// thread.  kClampDiv also clamps the substitutions' divisors at kTiny.
template <bool kClampDiv>
__device__ void chol_solve_shared(float* Ks, int ld, int n, float* b, float* z,
                                  float* x, float* rinv) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  for (int j = 0; j < n; ++j) {
    const float* rowj = Ks + static_cast<size_t>(j) * ld;
    const float dj = rowj[j];
    const float r = 1.0f / sqrtf(nan_max(dj, kTiny));
    float diag = dj * r;                              // R[j, j] as stored
    if (kClampDiv) diag = nan_max(diag, kTiny);
    const float zj = b[j] / diag;
    // kRows rows per pass share the loads of row j and keep kRows
    // independent updates in flight; a row's entries left of its diagonal
    // may be touched (k starts at the pass's first row) and are never read
    for (int i0 = j + 1 + warp * kRows; i0 < n; i0 += nwarps * kRows) {
      float ri[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        ri[q] = (i0 + q < n) ? rowj[i0 + q] * r : 0.0f;
      for (int k = i0 + lane; k < n; k += 32) {
        const float rk = rowj[k] * r;
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (i0 + q < n) Ks[static_cast<size_t>(i0 + q) * ld + k] -= ri[q] * rk;
      }
    }
    for (int k = j + 1 + tid; k < n; k += nt) b[k] -= zj * (rowj[k] * r);
    if (tid == 0) {
      z[j] = zj;
      rinv[j] = r;
    }
    __syncthreads();
  }

  // R x = z by warp 0.  Lane l keeps, for its rows i = l + 32c, the sum
  // of R[i,k] x[k] over the k already solved: x_j needs one broadcast of
  // row j's sum instead of a reduction, and the updates of the other rows
  // overlap the next step's division.
  if (warp == 0) {
    float acc[kMaxChunks], ri[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      acc[c] = 0.0f;
      ri[c] = (lane + 32 * c < n) ? rinv[lane + 32 * c] : 0.0f;
    }
    for (int j = n - 1; j >= 0; --j) {
      float mine = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        if (c == (j >> 5)) mine = acc[c];
      const float sum = __shfl_sync(0xffffffffu, mine, j & 31);
      float diag = Ks[static_cast<size_t>(j) * ld + j] * rinv[j];
      if (kClampDiv) diag = nan_max(diag, kTiny);
      const float xj = (z[j] - sum) / diag;
      if (lane == 0) x[j] = xj;
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int i = lane + 32 * c;
        if (i < j) acc[c] += (Ks[static_cast<size_t>(i) * ld + j] * ri[c]) * xj;
      }
    }
  }
  __syncthreads();
}

// shared-memory floats of one block
inline size_t kkt_shared_floats(int n) {
  const size_t n4 = static_cast<size_t>((n + kMicro - 1) / kMicro) * kMicro;
  return n4 * (n4 + 1) + kStage * n4 + kStage + 5 * n4;
}

inline size_t chol_shared_floats(int n) {
  const size_t ld = static_cast<size_t>(n) | 1;
  return static_cast<size_t>(n) * ld + 4 * static_cast<size_t>(n);
}

__global__ void __launch_bounds__(kThreads)
kkt_solve_kernel(const float* __restrict__ Q, const float* __restrict__ A,
                 const float* __restrict__ w, const float* __restrict__ sigma,
                 const float* __restrict__ rhs, float* __restrict__ dx, int m,
                 int n) {
  extern __shared__ float smem[];
  const int T = (n + kMicro - 1) / kMicro;   // micro-tiles per edge
  const int n4 = T * kMicro;
  const int ld = n4 + 1;
  float* Ks = smem;                          // n4 x ld
  float* stage = Ks + static_cast<size_t>(n4) * ld;   // kStage x n4
  float* wst = stage + kStage * n4;          // kStage
  float* dinv = wst + kStage;                // n4 each from here on
  float* bvec = dinv + n4;
  float* zvec = bvec + n4;
  float* xvec = zvec + n4;
  float* rinv = xvec + n4;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* Qb = Q + static_cast<size_t>(b) * n * n;
  const float* Ab = A + static_cast<size_t>(b) * m * n;
  const float* wb = w + static_cast<size_t>(b) * m;
  const float* rb = rhs + static_cast<size_t>(b) * n;
  const float sig = sigma[b];

  // ---- Ks = Q + sigma*I, zero in the padding ----
  for (int e = tid; e < n4 * n4; e += kThreads) {
    const int i = e / n4;
    const int j = e - i * n4;
    float v = 0.0f;
    if (i < n && j < n) {
      v = Qb[static_cast<size_t>(i) * n + j];
      if (i == j) v += sig;
    }
    Ks[static_cast<size_t>(i) * ld + j] = v;
  }

  // ---- Ks += A' (w o A), 32 rows of A at a time ----
  const int ntiles = T * T;
  for (int k0 = 0; k0 < m; k0 += kStage) {
    for (int e = tid; e < kStage * n4; e += kThreads) {
      const int kk = e / n4;
      const int j = e - kk * n4;
      const int k = k0 + kk;
      stage[e] = (k < m && j < n) ? Ab[static_cast<size_t>(k) * n + j] : 0.0f;
    }
    if (tid < kStage) wst[tid] = (k0 + tid < m) ? wb[k0 + tid] : 0.0f;
    __syncthreads();   // also orders the Ks initialization before its update
    for (int t = tid; t < ntiles; t += kThreads) {
      const int ti = t / T;
      const int tj = t - ti * T;
      float acc[kMicro][kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < kStage; ++kk) {
        const float* row = stage + kk * n4;
        const float wk = wst[kk];
        float ai[kMicro], aj[kMicro];
#pragma unroll
        for (int r = 0; r < kMicro; ++r) ai[r] = row[ti + r * T];
#pragma unroll
        for (int c = 0; c < kMicro; ++c) aj[c] = wk * row[tj + c * T];
#pragma unroll
        for (int r = 0; r < kMicro; ++r)
#pragma unroll
          for (int c = 0; c < kMicro; ++c) acc[r][c] += ai[r] * aj[c];
      }
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c)
          Ks[static_cast<size_t>(ti + r * T) * ld + tj + c * T] += acc[r][c];
    }
    __syncthreads();
  }
  if (m <= 0) __syncthreads();   // uniform: the loop above did not run

  // ---- Jacobi scale, static shift, scaled right-hand side ----
  for (int i = tid; i < n; i += kThreads) {
    const float d = Ks[static_cast<size_t>(i) * ld + i];
    dinv[i] = (d > 0.0f) ? 1.0f / sqrtf(d) : 1.0f;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n;
    const int j = e - i * n;
    float v = Ks[static_cast<size_t>(i) * ld + j] * dinv[i] * dinv[j];
    if (i == j) v += kReg;
    Ks[static_cast<size_t>(i) * ld + j] = v;
  }
  for (int i = tid; i < n; i += kThreads) {
    bvec[i] = rb[i] * dinv[i];
    xvec[i] = 0.0f;
  }
  __syncthreads();

  chol_solve_shared<false>(Ks, ld, n, bvec, zvec, xvec, rinv);

  for (int i = tid; i < n; i += kThreads)
    dx[static_cast<size_t>(b) * n + i] = xvec[i] * dinv[i];
}

__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const float* __restrict__ K, const float* __restrict__ rhs,
                  float* __restrict__ dx, int n) {
  extern __shared__ float smem[];
  const int ld = n | 1;
  float* Ks = smem;                          // n x ld
  float* bvec = Ks + static_cast<size_t>(n) * ld;
  float* zvec = bvec + n;
  float* xvec = zvec + n;
  float* rinv = xvec + n;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* Kb = K + static_cast<size_t>(b) * n * n;
  for (int e = tid; e < n * n; e += kThreads) {
    const int i = e / n;
    const int j = e - i * n;
    Ks[static_cast<size_t>(i) * ld + j] = Kb[e];
  }
  for (int i = tid; i < n; i += kThreads) {
    bvec[i] = rhs[static_cast<size_t>(b) * n + i];
    xvec[i] = 0.0f;
  }
  __syncthreads();

  chol_solve_shared<true>(Ks, ld, n, bvec, zvec, xvec, rinv);

  for (int i = tid; i < n; i += kThreads)
    dx[static_cast<size_t>(b) * n + i] = xvec[i];
}

// Ask for the dynamic shared memory (above 48 KB it must be granted per
// function and device first); a problem too large for one block is
// refused here, before any launch.
cudaError_t grant_shared(const void* kernel, size_t bytes) {
  if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int qpdo_kkt_solve_f32(const void* Q, const void* A, const void* w,
                                  const void* sigma, const void* rhs, void* dx,
                                  int B, int m, int n, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = kkt_shared_floats(n) * sizeof(float);
  const cudaError_t err = grant_shared(reinterpret_cast<const void*>(kkt_solve_kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kkt_solve_kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const float*>(A),
      static_cast<const float*>(w), static_cast<const float*>(sigma),
      static_cast<const float*>(rhs), static_cast<float*>(dx), m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qpdo_chol_solve_f32(const void* K, const void* rhs, void* dx,
                                   int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const size_t bytes = chol_shared_floats(n) * sizeof(float);
  const cudaError_t err = grant_shared(reinterpret_cast<const void*>(chol_solve_kernel), bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(K), static_cast<const float*>(rhs),
      static_cast<float*>(dx), n);
  return static_cast<int>(cudaGetLastError());
}

// The largest n each kernel takes (its shared memory must fit one block).
extern "C" int qpdo_kkt_solve_max_n() {
  int n = 1;
  while (kkt_shared_floats(n + 1) * sizeof(float) <= kMaxSharedBytes) ++n;
  return n;
}

extern "C" int qpdo_chol_solve_max_n() {
  int n = 1;
  while (chol_shared_floats(n + 1) * sizeof(float) <= kMaxSharedBytes) ++n;
  return n;
}
