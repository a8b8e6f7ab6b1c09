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
// kkt_solve needs 0.48 GFLOP (K is symmetric: m*n*(n+1) for its product,
// n^3/3 for the factor) over 26.0 MB, so its floor is memory (about 8 us)
// with the float32 SIMT time just under it; chol_solve moves 10.4 MB for
// 0.09 GFLOP, so its floor is memory (about 3 us).  Neither gets near its
// floor: the factor is n dependent steps (a shuffle, a square root and a
// division in a row, then a block-wide barrier), and the
// back-substitution is n dependent steps too.  At B=256 only two blocks share an SM, so the
// latency of a step has to be short in itself: what decides the time is
// where K lives while it is factored and what is left on the chain from
// one pivot to the next.
//
// Design for n <= 128 (the register route): one block of 256 threads per
// problem, the threads a 16x16 grid; thread (ty, tx) owns the entries
// (ty + 16r, tx + 16c) of K, r <= c < ceil(n/16), in registers (at most 36
// of them: the upper triangle is all the factor reads).  The layout is
// block-cyclic, so the shrinking trailing matrix stays spread over all
// threads.  The kernels are instantiated for every ceil(n/16) = 1..8, so
// every register index is static and padding beyond n costs at most 15
// rows.
//  * Formation: the registers start as Q + sigma*I; A is staged through
//    registers (16-byte global loads, one stage ahead) into two shared
//    stages, each row permuted so that a thread's 8 row-side and 8
//    column-side values are two 16-byte packs and a half-warp's packs are
//    contiguous (no bank conflicts): 4 16-byte shared loads feed up to 36
//    FMAs, nothing is written back between stages, and the next stage
//    loads while this one is multiplied.  (4-byte cp.async copies, which
//    can scatter straight into the permuted rows, were measured at about
//    the time of the whole multiplication.)  The product order is
//    A[k,i] * (w[k] * A[k,j]), as in formation.cu.
//  * Jacobi scale and shift act on the registers; diag K passes through a
//    shared vector.
//  * Factor: right-looking, two rows a barrier.  Rows j and j+1 (j even
//    within its block of 16) live in the two half-warps of one warp: that
//    warp takes the pivot by a shuffle, scales row j by 1/sqrt(pivot),
//    hands it to the other half-warp by shuffles for row j+1's update,
//    finishes row j+1 the same way and writes both rows to shared memory
//    (permuted as above, two 16-byte stores a thread).  After the one
//    barrier every thread reads its row-side and column-side entries of
//    both rows with 8 16-byte loads and updates its registers: no
//    shared-memory store or dependent load-FMA-store chain is left in the
//    update, and the barrier, the loop and the loads' latency are paid
//    once for two rows.  Row blocks above the pivots' are skipped
//    statically.  The forward substitution rides one pair behind: the
//    threads tx < ceil(n/16) carry one entry of the right-hand side each
//    in a register, in the half-warp that owns that row, so z_j and
//    z_{j+1} cost two divisions in the warp that is NOT about to factor
//    the next pair.
//  * Back-substitution: first all threads divide every row of R by its
//    diagonal and store it by columns (packed, so a column is contiguous:
//    no bank conflicts), which takes the division out of the chain of n
//    dependent steps; then warp 0 alone, each lane carrying the partial
//    sums of its rows in registers, column j loaded one step ahead: a step
//    is one subtraction, one shuffle and one FMA.
// For 128 < n <= 220 (239 for chol_solve) K does not fit the registers of
// one block: the shared-memory route keeps Khat in dynamic shared memory
// with an odd row stride and updates it there (each warp QPDO_KKT_ROWS
// rows a pass).  The entry points here choose between these two routes
// from n alone.  Above 220 (239) one problem's K does not fit the 227 KB
// of shared memory of a block either: the wrappers (ops/fused_kkt.py,
// kernel_route) then take the global-memory route of kkt_solve_large.cu,
// where kernel 1 forms K into a workspace and one block per problem
// factors it there panel by panel, so every n is solved.
// Every __syncthreads() is reached by all threads unconditionally.
// max(d, 1e-30) keeps a NaN pivot NaN (fmaxf would drop it), so a failed
// problem comes back non-finite and its neighbours are untouched.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "phase_clocks.cuh"
#include "shared_grant.cuh"

namespace {

// the shared-memory route's block size and rows per warp pass
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
kkt_solve_shared_kernel(const float* __restrict__ Q, const float* __restrict__ A,
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
chol_solve_shared_kernel(const float* __restrict__ K, const float* __restrict__ rhs,
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

// ---------------------------------------------------------------------
// The register route, n <= kRegMaxN
// ---------------------------------------------------------------------

#ifndef QPDO_KKT_STAGE_ROWS
#define QPDO_KKT_STAGE_ROWS 16
#endif
#ifndef QPDO_KKT_UNROLL
#define QPDO_KKT_UNROLL 4
#endif
constexpr int kRegUnroll = QPDO_KKT_UNROLL;        // rows of A per loop body
constexpr int kRegStages = 2;                      // shared stages of A
constexpr int kRegStageRows = QPDO_KKT_STAGE_ROWS;  // rows of A per stage
constexpr int kRegMinBlocks = 2;                   // blocks that share an SM
constexpr int kRegThreads = 256;                   // a 16x16 grid of threads
constexpr int kRegMaxN = 128;                      // 8 row blocks of 16
constexpr int kRegRow = 128;                       // floats of a permuted row

// where entry k = t + 16e of a row (thread coordinate t, e < 8) sits in a
// permuted shared row: e < 4 at 4t + e, e >= 4 at 64 + 4t + (e - 4).  A
// thread's 8 entries are two 16-byte packs, and the 16 threads of a
// half-warp read 256 contiguous bytes at a time: no bank conflicts.
__device__ __forceinline__ int permuted(int k) {
  const int t = k & 15, e = k >> 4;
  return ((e & 4) << 4) + 4 * t + (e & 3);
}

// the entry that sits at position q of a permuted row
__device__ __forceinline__ int unpermuted(int q) {
  const int t = (q & 63) >> 2, e = (q & 3) + ((q >> 6) << 2);
  return t + 16 * e;
}

// the W = 8 (for n <= 64: 4) entries of a permuted row at thread
// coordinate t
template <int W>
__device__ __forceinline__ void load_mine(const float* row, int t, float (&out)[W]) {
  float pack[4];
#pragma unroll
  for (int h = 0; h < W / 4; ++h) {
    load_packs(row + 64 * h + 4 * t, pack);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * h + e] = pack[e];
  }
}

template <int W>
__device__ __forceinline__ void store_mine(float* row, int t, const float (&in)[W]) {
  float pack[4];
#pragma unroll
  for (int h = 0; h < W / 4; ++h) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pack[e] = in[4 * h + e];
    store_packs(row + 64 * h + 4 * t, pack);
  }
}

// floats of the columns of R below (packed: column k holds rows 0 .. k-1)
__host__ __device__ inline size_t packed_columns(int n) {
  return static_cast<size_t>(n) * (n - 1) / 2 + 4;
}

// floats the register route shares between the stages of A (formation,
// with_stages) and the packed columns of R (substitution): the stages are
// dead before the first column is written
__host__ __device__ inline size_t reg_union_floats(int n, bool with_stages) {
  const size_t stages =
      with_stages ? kRegStages * (kRegStageRows * kRegRow + kRegStageRows) : 0;
  const size_t cols = (packed_columns(n) + 3) / 4 * 4;
  return stages > cols ? stages : cols;
}

// shared-memory floats of one block of the register route: the rows of R,
// the union above, the b_j slots, z, x and the diagonal
inline size_t reg_shared_floats(int n, bool with_stages) {
  return static_cast<size_t>(n) * kRegRow + reg_union_floats(n, with_stages) +
         4 + 3 * kRegRow;
}

// Factor the matrix held in the block's registers (Kr[r][c] is entry
// (ty + 16r, tx + 16c), upper triangle, already scaled) and solve with the
// right-hand side of which thread (ty, tx) with tx < NR holds entry
// ty + 16 tx in bz (in the half-warp that owns that row of K).  rows is
// n x kRegRow (row j of R, permuted), cols holds packed_columns(n) floats, slots 4, zvec and xvec n
// floats, all in shared memory.  Ends with a block-wide barrier: xvec is
// complete for every thread.  kClampDiv also clamps the substitutions'
// divisors at kTiny.
template <int NR, bool kClampDiv>
__device__ __forceinline__ void factor_solve_regs(float (&Kr)[NR][NR], float bz,
                                                  int n, float* rows, float* cols,
                                                  float* slots, float* zvec,
                                                  float* xvec) {
  constexpr int W = NR <= 4 ? 4 : 8;   // floats a thread reads of a row
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kb = ty + 16 * tx;                  // this thread's entry of rhs
  const bool carrier = tx < NR && kb < n;
  QPDO_MARK(3);

  const bool upper = (lane >> 4) != 0;           // the warp's odd row ty
  int jprev = -1;                                // first row of the last pair
  int pair = 0;

  // Two rows a barrier: rows j = 16 rj + t and j + 1 (t even) live in the
  // two half-warps of warp t/2, so that warp finishes both with shuffles
  // alone (row j, its update of row j + 1, row j + 1) and the block then
  // applies both at once.
#pragma unroll
  for (int rj = 0; rj < NR; ++rj) {
    const int tend = (n - 16 * rj < 16) ? n - 16 * rj : 16;
    for (int t = 0; t < tend; t += 2) {
      const int j = 16 * rj + t;
      float* row0 = rows + j * kRegRow;
      float* row1 = row0 + kRegRow;
      const bool owner = (warp == (t >> 1));
      float diag0 = 1.0f, diag1 = 1.0f, a01 = 0.0f;
      if (owner) {
        // row j: its pivot sits in lane tx == t of the lower half-warp
        const float d0 = __shfl_sync(0xffffffffu, Kr[rj][rj], t);
        const float rinv0 = 1.0f / sqrtf(nan_max(d0, kTiny));
        float v[W];                                    // R[j, tx + 16c]
#pragma unroll
        for (int c = 0; c < W; ++c)
          v[c] = (c >= rj && c < NR) ? Kr[rj][c < NR ? c : 0] * rinv0 : 0.0f;
        if (!upper) store_mine(row0, tx, v);
        // row j + 1 (the upper half-warp) takes row j's update now:
        // K[j+1, k] -= R[j, j+1] * R[j, k]
        a01 = __shfl_sync(0xffffffffu, v[rj < W ? rj : 0], t + 1);
#pragma unroll
        for (int c = rj; c < NR; ++c) {
          const float r0 = __shfl_sync(0xffffffffu, v[c], tx);
          if (upper) Kr[rj][c] -= a01 * r0;
        }
        const float d1 = __shfl_sync(0xffffffffu, Kr[rj][rj], 16 + t + 1);
        const float rinv1 = 1.0f / sqrtf(nan_max(d1, kTiny));
        if (upper && j + 1 < n) {
#pragma unroll
          for (int c = 0; c < W; ++c)
            v[c] = (c >= rj && c < NR) ? Kr[rj][c < NR ? c : 0] * rinv1 : 0.0f;
          store_mine(row1, tx, v);
        }
        diag0 = d0 * rinv0;                            // R[j, j] as stored
        diag1 = d1 * rinv1;
        if (kClampDiv) {
          diag0 = nan_max(diag0, kTiny);
          diag1 = nan_max(diag1, kTiny);
        }
      }
      __syncthreads();

      // R'z = b rides one pair behind: first the last pair's z reach every
      // entry still open ...
      if (jprev >= 0 && carrier && kb > jprev + 1) {
        const float* zp = slots + 2 * ((pair - 1) & 1);
        const float* rp = rows + jprev * kRegRow + permuted(kb);
        bz -= zp[0] * rp[0];
        bz -= zp[1] * rp[kRegRow];
      }
      // ... then this pair's two entries, held in the owner warp's lanes
      // tx == rj, are final: z_j, and z_{j+1} after z_j's update
      if (owner) {
        if (!upper && tx == rj) bz = bz / diag0;
        const float z0 = __shfl_sync(0xffffffffu, bz, rj);
        if (upper && tx == rj) bz = (bz - z0 * a01) / diag1;
        const float z1 = __shfl_sync(0xffffffffu, bz, 16 + rj);
        if (lane == 0) {
          slots[2 * (pair & 1)] = z0;
          slots[2 * (pair & 1) + 1] = z1;
        }
      }

      float ar0[W], bc0[W], ar1[W] = {}, bc1[W] = {};
      load_mine(row0, ty, ar0);                    // R[j, ty + 16r]
      load_mine(row0, tx, bc0);                    // R[j, tx + 16c]
      if (j + 1 < n) {                             // an odd n ends on a
        load_mine(row1, ty, ar1);                  //   pair of one row:
        load_mine(row1, tx, bc1);                  //   no row n is read
      }
#pragma unroll
      for (int r = rj; r < NR; ++r) {
        if (r > rj || ty > t + 1) {                    // rows below the pair
#pragma unroll
          for (int c = r; c < NR; ++c) {
            Kr[r][c] -= ar0[r] * bc0[c];
            Kr[r][c] -= ar1[r] * bc1[c];
          }
        }
      }
      jprev = j;
      ++pair;
    }
  }
  if (carrier) zvec[kb] = bz;
  __syncthreads();
  QPDO_MARK(4);                                  // factor done

  // R x = z.  First every row is divided by its diagonal, all threads at
  // once, and stored by columns: x_j = z_j/d_j - sum_k (R[j,k]/d_j) x_k
  // leaves no division in the chain of n dependent steps below.
  for (int j = warp; j < n; j += kRegThreads / 32) {
    const float* rowj = rows + j * kRegRow;
    float dj = rowj[permuted(j)];
    if (kClampDiv) dj = nan_max(dj, kTiny);
    for (int q = lane; q < kRegRow; q += 32) {
      const int k = unpermuted(q);
      if (k > j && k < n) cols[k * (k - 1) / 2 + j] = rowj[q] / dj;
    }
    if (lane == 0) zvec[j] = zvec[j] / dj;
  }
  __syncthreads();
  QPDO_MARK(5);                                  // scaling pass done

  // Warp 0 alone: lane l keeps, for its rows i = l + 32c, the sum of
  // (R[i,k]/d_i) x[k] over the k already solved, so x_j is one subtraction
  // in the lane that owns row j and one broadcast.  Column j is loaded one
  // step ahead of its use.
  if (warp == 0) {
    constexpr int NC = (NR + 1) / 2;                   // 32-row chunks
    float acc[NC], zt[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c] = 0.0f;
      zt[c] = (lane + 32 * c < n) ? zvec[lane + 32 * c] : 0.0f;
    }
    // the chunk of row j is a compile-time index: no register array is
    // indexed by a run-time value
#pragma unroll
    for (int cj = NC - 1; cj >= 0; --cj) {
      const int top = (n - 32 * cj < 32) ? n - 32 * cj : 32;
      float col[NC];
#pragma unroll
      for (int c = 0; c <= cj; ++c) col[c] = 0.0f;
      if (top > 0) {
        const int j = 32 * cj + top - 1;
        const float* cn = cols + j * (j - 1) / 2;
#pragma unroll
        for (int c = 0; c <= cj; ++c)
          if (lane + 32 * c < j) col[c] = cn[lane + 32 * c];
      }
      for (int jj = top - 1; jj >= 0; --jj) {
        const int j = 32 * cj + jj;
        float nxt[NC];
#pragma unroll
        for (int c = 0; c <= cj; ++c) nxt[c] = 0.0f;
        if (j > 0) {
          const float* cn = cols + (j - 1) * (j - 2) / 2;
#pragma unroll
          for (int c = 0; c <= cj; ++c)
            if (lane + 32 * c < j - 1) nxt[c] = cn[lane + 32 * c];
        }
        const float xj = __shfl_sync(0xffffffffu, zt[cj] - acc[cj], jj);
        if (lane == 0) xvec[j] = xj;
#pragma unroll
        for (int c = 0; c <= cj; ++c) {
          if (lane + 32 * c < j) acc[c] += col[c] * xj;
          col[c] = nxt[c];
        }
      }
    }
  }
  QPDO_MARK(6);                                  // back-substitution done
  __syncthreads();
  QPDO_MARK(7);
}

// 1/sqrt(d) where d > 0, else 1: the Jacobi scale of one diagonal entry
__device__ __forceinline__ float jacobi_scale(float d) {
  return (d > 0.0f) ? 1.0f / sqrtf(d) : 1.0f;
}

template <int NR>
__global__ void __launch_bounds__(kRegThreads, kRegMinBlocks)
kkt_solve_reg_kernel(const float* __restrict__ Q, const float* __restrict__ A,
                     const float* __restrict__ w, const float* __restrict__ sigma,
                     const float* __restrict__ rhs, float* __restrict__ dx, int m,
                     int n) {
  extern __shared__ __align__(16) unsigned char kkt_smem[];
  constexpr int kStageFloats = kRegStageRows * kRegRow + kRegStageRows;
  float* rows = reinterpret_cast<float*>(kkt_smem);   // n x kRegRow
  float* stage = rows + static_cast<size_t>(n) * kRegRow;   // kRegStages stages,
  float* cols = stage;                                 //   then the columns of R
  float* slots = stage + reg_union_floats(n, true);    // 4
  float* zvec = slots + 4;                             // kRegRow each
  float* xvec = zvec + kRegRow;
  float* dvec = xvec + kRegRow;                        // diag K

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x;
  const float* Qb = Q + static_cast<size_t>(b) * n * n;
  const float* Ab = A + static_cast<size_t>(b) * m * n;
  const float* wb = w + static_cast<size_t>(b) * m;
  QPDO_MARK(0);

  // Stage s is rows k0 .. k0+kc-1 of A, one contiguous run of kc*n floats,
  // and of w.  A thread moves the 4-float chunks tid, tid + 256, ... of the
  // run: fetch() loads them into registers (16 bytes a load where n and the
  // pointer allow it), stash() scatters them into the permuted rows of a
  // shared stage.  Where a float lands in the stage does not depend on s:
  // the offsets are worked out once (-1 past the stage's last row).
  constexpr int kChunks = (kRegStageRows * kRegMaxN / 4 + kRegThreads - 1) / kRegThreads;
  const bool vec = n % 4 == 0 && reinterpret_cast<size_t>(Ab) % 16 == 0;
  int land[kChunks][4];
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int e = 4 * (tid + kRegThreads * it);
    int kk = e / n;
    int j = e - kk * n;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      land[it][q] = (kk < kRegStageRows) ? kk * kRegRow + permuted(j) : -1;
      if (++j == n) {
        j = 0;
        ++kk;
      }
    }
  }
  float held[kChunks][4] = {};
  float held_w = 0.0f;
  auto fetch = [&](int s) {
    const int k0 = s * kRegStageRows;
    const int kc = (m - k0 < kRegStageRows) ? m - k0 : kRegStageRows;
    const float* src = Ab + static_cast<size_t>(k0) * n;
#pragma unroll
    for (int it = 0; it < kChunks; ++it) {
      const int e = 4 * (tid + kRegThreads * it);
      if (vec) {
        if (e < kc * n) load_packs(src + e, held[it]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (e + q < kc * n) held[it][q] = src[e + q];
      }
    }
    if (tid < kc) held_w = wb[k0 + tid];
  };
  auto stash = [&](int s) {
    // rows past the end of A receive whatever the registers hold: the
    // multiplication below stops at the stage's last row of A
    float* dst = stage + (s % kRegStages) * kStageFloats;
#pragma unroll
    for (int it = 0; it < kChunks; ++it)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (land[it][q] >= 0) dst[land[it][q]] = held[it][q];
    if (tid < kRegStageRows) dst[kRegStageRows * kRegRow + tid] = held_w;
  };
  const int nstage = (m + kRegStageRows - 1) / kRegStageRows;
  if (nstage > 0) fetch(0);

  // columns n .. 16*NR-1 of every staged row stay zero (no copy lands there)
  const int pad = 16 * NR - n;
  for (int e = tid; e < kRegStages * kRegStageRows * pad; e += kRegThreads) {
    const int row = e / pad;
    const int j = n + (e - row * pad);
    stage[(row / kRegStageRows) * kStageFloats + (row % kRegStageRows) * kRegRow +
          permuted(j)] = 0.0f;
  }

  // ---- K = Q + sigma*I in registers, zero in the padding ----
  const float sig = sigma[b];
  float Kr[NR][NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const int i = ty + 16 * r;
      const int j = tx + 16 * c;
      float v = 0.0f;
      if (c >= r && i < n && j < n) {
        v = Qb[static_cast<size_t>(i) * n + j];
        if (i == j) v += sig;
      }
      Kr[r][c] = v;
    }
  }

  // ---- K += A' (w o A), accumulated in registers over all stages: stage
  // s is multiplied from shared memory while stage s+1 waits in the other
  // buffer and stage s+2 is on its way into registers ----
  QPDO_MARK(1);                // prologue done: Q in registers, stage 0 held
  if (nstage > 0) stash(0);
  if (nstage > 1) fetch(1);
  for (int s = 0; s < nstage; ++s) {
    __syncthreads();     // stage s is whole; the other buffer is consumed
    if (s + 1 < nstage) stash(s + 1);
    if (s + 2 < nstage) fetch(s + 2);
    const int k0 = s * kRegStageRows;
    const int kc = (m - k0 < kRegStageRows) ? m - k0 : kRegStageRows;
    const float* st = stage + (s % kRegStages) * kStageFloats;
    const float* sw = st + kRegStageRows * kRegRow;
#pragma unroll kRegUnroll
    for (int kk = 0; kk < kc; ++kk) {
      float ai[NR <= 4 ? 4 : 8], aj[NR <= 4 ? 4 : 8];
      load_mine(st + kk * kRegRow, ty, ai);       // A[k, ty + 16r]
      load_mine(st + kk * kRegRow, tx, aj);       // A[k, tx + 16c]
      const float wk = sw[kk];
#pragma unroll
      for (int c = 0; c < NR; ++c) aj[c] = wk * aj[c];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = r; c < NR; ++c) Kr[r][c] += ai[r] * aj[c];
    }
  }

  QPDO_MARK(2);                // formation loop done
  // ---- Jacobi scale, static shift, scaled right-hand side ----
  if (tx == ty) {
#pragma unroll
    for (int r = 0; r < NR; ++r) dvec[ty + 16 * r] = Kr[r][r];
  }
  __syncthreads();
  {
    float di[NR], dj[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      di[r] = jacobi_scale(dvec[ty + 16 * r]);
      dj[r] = jacobi_scale(dvec[tx + 16 * r]);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int c = r; c < NR; ++c) {
        float v = Kr[r][c] * di[r] * dj[c];
        if (r == c && tx == ty) v += kReg;
        Kr[r][c] = v;
      }
    }
  }
  const int kb = ty + 16 * tx;             // the entry of rhs this thread carries
  float bz = 0.0f;
  if (tx < NR && kb < n)
    bz = rhs[static_cast<size_t>(b) * n + kb] * jacobi_scale(dvec[kb]);

  factor_solve_regs<NR, false>(Kr, bz, n, rows, cols, slots, zvec, xvec);

  for (int i = tid; i < n; i += kRegThreads)
    dx[static_cast<size_t>(b) * n + i] = xvec[i] * jacobi_scale(dvec[i]);
}

template <int NR>
__global__ void __launch_bounds__(kRegThreads, kRegMinBlocks)
chol_solve_reg_kernel(const float* __restrict__ K, const float* __restrict__ rhs,
                      float* __restrict__ dx, int n) {
  extern __shared__ __align__(16) unsigned char kkt_smem[];
  float* rows = reinterpret_cast<float*>(kkt_smem);   // n x kRegRow
  float* cols = rows + static_cast<size_t>(n) * kRegRow;    // the columns of R
  float* slots = cols + reg_union_floats(n, false);    // 4
  float* zvec = slots + 4;                             // kRegRow each
  float* xvec = zvec + kRegRow;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x;
  const float* Kb = K + static_cast<size_t>(b) * n * n;
  float Kr[NR][NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int c = 0; c < NR; ++c) {
      const int i = ty + 16 * r;
      const int j = tx + 16 * c;
      Kr[r][c] = (c >= r && i < n && j < n) ? Kb[static_cast<size_t>(i) * n + j]
                                             : 0.0f;
    }
  }
  const int kb = ty + 16 * tx;             // the entry of rhs this thread carries
  float bz = 0.0f;
  if (tx < NR && kb < n) bz = rhs[static_cast<size_t>(b) * n + kb];

  factor_solve_regs<NR, true>(Kr, bz, n, rows, cols, slots, zvec, xvec);

  for (int i = tid; i < n; i += kRegThreads)
    dx[static_cast<size_t>(b) * n + i] = xvec[i];
}

// One instance per number of 16-row blocks: every register index static.
template <int NR>
int launch_kkt_reg(const float* Q, const float* A, const float* w,
                   const float* sigma, const float* rhs, float* dx, int B, int m,
                   int n, cudaStream_t stream) {
  const size_t bytes = reg_shared_floats(n, true) * sizeof(float);
  auto kernel = kkt_solve_reg_kernel<NR>;
  static SharedGrant grant;              // one per kernel instance
  const cudaError_t err =
      grant_shared(reinterpret_cast<const void*>(kernel), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kRegThreads, bytes, stream>>>(Q, A, w, sigma, rhs, dx, m, n);
  return static_cast<int>(cudaGetLastError());
}

template <int NR>
int launch_chol_reg(const float* K, const float* rhs, float* dx, int B, int n,
                    cudaStream_t stream) {
  const size_t bytes = reg_shared_floats(n, false) * sizeof(float);
  auto kernel = chol_solve_reg_kernel<NR>;
  static SharedGrant grant;
  const cudaError_t err =
      grant_shared(reinterpret_cast<const void*>(kernel), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kRegThreads, bytes, stream>>>(K, rhs, dx, n);
  return static_cast<int>(cudaGetLastError());
}

int kkt_reg(const float* Q, const float* A, const float* w, const float* sigma,
            const float* rhs, float* dx, int B, int m, int n, cudaStream_t stream) {
#define QPDO_CALL(NR) launch_kkt_reg<NR>(Q, A, w, sigma, rhs, dx, B, m, n, stream)
  switch ((n + 15) / 16) {
    case 1: return QPDO_CALL(1);
    case 2: return QPDO_CALL(2);
    case 3: return QPDO_CALL(3);
    case 4: return QPDO_CALL(4);
    case 5: return QPDO_CALL(5);
    case 6: return QPDO_CALL(6);
    case 7: return QPDO_CALL(7);
    default: return QPDO_CALL(8);
  }
#undef QPDO_CALL
}

int chol_reg(const float* K, const float* rhs, float* dx, int B, int n,
             cudaStream_t stream) {
#define QPDO_CALL(NR) launch_chol_reg<NR>(K, rhs, dx, B, n, stream)
  switch ((n + 15) / 16) {
    case 1: return QPDO_CALL(1);
    case 2: return QPDO_CALL(2);
    case 3: return QPDO_CALL(3);
    case 4: return QPDO_CALL(4);
    case 5: return QPDO_CALL(5);
    case 6: return QPDO_CALL(6);
    case 7: return QPDO_CALL(7);
    default: return QPDO_CALL(8);
  }
#undef QPDO_CALL
}

}  // namespace

// The route follows from n alone: registers up to kRegMaxN, shared memory
// above (up to the limits below).
extern "C" int qpdo_kkt_solve_f32(const void* Q, const void* A, const void* w,
                                  const void* sigma, const void* rhs, void* dx,
                                  int B, int m, int n, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const float* Qf = static_cast<const float*>(Q);
  const float* Af = static_cast<const float*>(A);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(sigma);
  const float* rf = static_cast<const float*>(rhs);
  float* xf = static_cast<float*>(dx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kRegMaxN) return kkt_reg(Qf, Af, wf, sf, rf, xf, B, m, n, st);
  const size_t bytes = kkt_shared_floats(n) * sizeof(float);
  static SharedGrant grant;
  const cudaError_t err = grant_shared(
      reinterpret_cast<const void*>(kkt_solve_shared_kernel), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  kkt_solve_shared_kernel<<<B, kThreads, bytes, st>>>(Qf, Af, wf, sf, rf, xf, m, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qpdo_chol_solve_f32(const void* K, const void* rhs, void* dx,
                                   int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const float* Kf = static_cast<const float*>(K);
  const float* rf = static_cast<const float*>(rhs);
  float* xf = static_cast<float*>(dx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kRegMaxN) return chol_reg(Kf, rf, xf, B, n, st);
  const size_t bytes = chol_shared_floats(n) * sizeof(float);
  static SharedGrant grant;
  const cudaError_t err = grant_shared(
      reinterpret_cast<const void*>(chol_solve_shared_kernel), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_solve_shared_kernel<<<B, kThreads, bytes, st>>>(Kf, rf, xf, n);
  return static_cast<int>(cudaGetLastError());
}

#ifdef QPDO_PHASE_CLOCKS
extern "C" int qpdo_kkt_phase_clocks(long long* out) {
  return read_phase_clocks(out);
}
#endif

// The largest n of each kernel's shared-memory route (its shared memory must
// fit one block); above it the wrappers take kkt_solve_large.cu.
extern "C" int qpdo_kkt_solve_shared_max_n() {
  int n = 1;
  while (kkt_shared_floats(n + 1) * sizeof(float) <= kMaxSharedBytes) ++n;
  return n;
}

extern "C" int qpdo_chol_solve_shared_max_n() {
  int n = 1;
  while (chol_shared_floats(n + 1) * sizeof(float) <= kMaxSharedBytes) ++n;
  return n;
}
