// The global-memory route of the two KKT kernels of kkt_solve.cu, float32,
// for n above their shared-memory route (220 for kkt_solve, 239 for
// chol_solve): one problem's K no longer fits the 227 KB of shared memory
// of one block, so it stays in global memory.
//
// kkt_solve_global computes what kkt_solve does (the contract at the top
// of kkt_solve.cu):
//
//     K    = Q + sigma*I + A' diag(w) A
//     dinv = 1/sqrt(diag K) where diag K > 0, else 1
//     Khat = dinv K dinv + 100*eps32*I
//     R    = chol(Khat)  (upper factor, pivot max(d, 1e-30), NaN kept)
//     R'z  = dinv * rhs;   R x = z;   dx = dinv * x
//
// and chol_solve_global what chol_solve does (K given, only its upper
// triangle read; the substitutions' divisors also clamped at 1e-30).
//
// Replaces, for those n, the TPU kernels qpdo_tpu/ops/pallas_kkt.py:
// _kkt_kernel (l.40), whose entry fused_kkt_solve pads any n to a multiple
// of 128, and _stacked_chol_kernel (l.209), which takes any multiple of
// 128: both keep K in VMEM, which holds many megabytes.
//
// What bounds it on the H100: a problem needs m*n*(n+1) operations for
// K's symmetric product and n^3/3 multiply-adds for the factor, so at the
// sizes this route serves (n > 220, m ~ 1.5 n) it is bound by operations,
// not bytes.  In practice the factor is n dependent pivot steps: their
// latency, and how many SMs take part, decide its time.  One block per
// problem (the first design) ran a few problems on a few of the 132 SMs,
// with one warp factoring each diagonal block while seven waited.
//
// Design: the C entry points issue, per panel of kPanel = 32 rows of R, two
// launches on the given stream, then one for the back substitution, each
// with programmatic dependent launch (it may start while the launch before
// it finishes, and waits for it before touching memory).  No block waits
// for another block, so the blocks of a launch may run in any order, and
// each entry of K is written by exactly one block of a launch: two calls
// give the same bits.
//  * K is formed by kernel 1 (formation.cu, float32, its rows split over
//    blocks where few problems have many rows) into the first B*n*n floats
//    of a workspace that the wrapper allocates; the next 4*B*n floats hold
//    dinv, the right-hand side (b as the panels update it, then x), the
//    diagonal of R and z of each problem.  chol_solve_global reads the
//    given K in its first panel and first trailing update, and writes the
//    workspace from there on.
//  * The panel kernel, grid (column ranges of kStrip = 56, B): in every
//    block warp 0 loads the panel's diagonal block into registers (lane q
//    column q) and factors it by the right-looking recurrence, a pivot a
//    step, with the panel's part of R'z = b; after each pivot it publishes
//    that row of R, 1/sqrt(pivot) and z in shared memory and raises a
//    counter.  The block's other seven warps hold its columns of the
//    panel's rows (4 lanes a column, 8 rows a lane) and solve them a pivot
//    at a time as soon as the counter allows, so the strip trails the
//    factor by a step instead of waiting for all of it.  The diagonal block
//    is factored in every block with the same instructions, so its bits are
//    the same in every block.  Both loops take 4 pivots an iteration and
//    then move their registers up, which keeps register indices static and
//    the code small: with all 32 pivots unrolled the code ran from beyond
//    the instruction cache, once per launch, at ~1,250 cycles a pivot.
//    Block 0 writes the diagonal block of R (its strict upper part
//    transposed into K's lower triangle, which nothing else reads, its
//    diagonal into the workspace) and z, so that no block overwrites what
//    another still reads; each block writes its columns of the panel's rows
//    of R and of the right-hand side.  In the first panel kkt_solve_global
//    also computes dinv and Jacobi-scales and shifts what it loads: there
//    is no pass of its own for the scale.
//  * The trailing-update kernel, grid (upper-triangle tile pairs, B): each
//    block takes one 64x64 tile of the trailing matrix in registers (a
//    thread a 4x4 micro-tile) and the panel's strips over its rows and
//    columns in shared memory, and applies the panel's rank-32 update (in
//    the first panel to K read from its source, scaled as above).
//  * R x = z, one block per problem, a panel at a time from the last: each
//    row's dot product with the solved tail (a warp a row, a shuffle
//    reduction), then warp 0 solves the 32x32 block with shuffles while
//    the other warps sum the next panel's dot products over all but the
//    columns being solved.
// Every entry of K takes its updates one pivot row at a time, in the order
// of the plain version's unblocked recurrence.  A failed problem (NaN or
// non-positive pivots) stays in its own blocks.

#include <cuda_runtime.h>

#include <cstddef>

#include "phase_clocks.cuh"

// kernel 1, formation.cu
extern "C" {
int qpdo_formation_f32(const void* A, const void* w, const void* Q,
                       const void* sigma, void* K, void* partial, int B, int m,
                       int n, int splits, void* stream);
}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;            // rows of R a panel
constexpr int kLd = kPanel + 1;       // row stride of the diagonal block
// the strip: warps 1.. (warp 0 factors the diagonal block meanwhile), 4
// lanes a column, each kStripRows rows of it
constexpr int kStrip = (kWarps - 1) * 32 / 4;   // columns of the panel's rows a block
constexpr int kStripRows = kPanel / 4;
constexpr unsigned kSpinNs = 32;      // a strip warp's pause while it waits for a row
constexpr int kStep = 4;              // pivots an iteration of the panel's loops
constexpr int kTile = 64;             // edge of a trailing-update tile
constexpr int kMicro = 4;             // a thread's micro-tile is kMicro x kMicro
constexpr int kGrid = kTile / kMicro; // threads along a tile edge (16 x 16)
static_assert(kGrid * kGrid == kThreads, "one micro-tile a thread");
constexpr float kTiny = 1e-30f;
constexpr float kReg = 100.0f * 1.1920928955078125e-07f;   // 100 * eps32
// shared floats of each kernel: the panel kernel's diagonal block of R
// and its vectors; the trailing update's two strips; the back
// substitution's two panel vectors
constexpr size_t kPanelFloats = kPanel * kLd + 3 * kPanel + kStrip + 1;
constexpr size_t kTrailFloats = 2 * kPanel * kTile;
constexpr size_t kBackFloats = 2 * kPanel;

// four floats moved by one shared-memory access
struct alignas(16) Float4 {
  float v[4];
};
constexpr int kMaxGridY = 65535;

// Programmatic dependent launch (sm_90): each launch of the sequence may
// start before the one ahead of it has finished; its blocks wait here,
// before their first access to global memory, until that launch has
// completed and its writes are visible.  kDependentLaunch = 0 launches
// them plainly, one after another.
constexpr int kDependentLaunch = 1;

__device__ __forceinline__ void wait_for_prior_grids() {
#ifndef QPDO_CUDA_STUB
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             size_t bytes, cudaStream_t stream,
                             Args... args) {
  cudaLaunchAttribute attrs[1] = {};
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = kDependentLaunch;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// max(a, t) that keeps a NaN in a (jnp.maximum, torch.clamp)
__device__ __forceinline__ float nan_max(float a, float t) {
  return (a < t) ? t : a;
}

__device__ __forceinline__ float jacobi_scale(float d) {
  return (d > 0.0f) ? 1.0f / sqrtf(d) : 1.0f;
}

// One pivot's reciprocal square root, 1/sqrt(max(d, 1e-30)), NaN kept: the
// same instructions wherever a pivot is taken.
__device__ __forceinline__ float pivot_scale(float d) {
  return 1.0f / sqrtf(nan_max(d, kTiny));
}

// The panel of rows k0 .. k0+pc-1, block (column range, problem).  src: the
// matrices the panel reads (the workspace K, or in the first panel of
// chol_solve_global the given K); K: the workspace's matrices (B, n, n);
// vec: (B, 4, n): dinv, the right-hand side, the diagonal of R and z.
// kFirst: the first panel (kJacobi: compute dinv, scale and shift K and
// scale rhs on load; else take rhs as it is).
template <bool kJacobi, bool kClampDiv, bool kFirst>
__global__ void __launch_bounds__(kThreads)
panel_kernel(const float* src, const float* __restrict__ rhs, float* K,
             float* vec, int n, int k0) {
  extern __shared__ __align__(16) float large_smem[];
  float* Rs = large_smem;              // kPanel x kLd: the diagonal block of R
  float* rs = Rs + kPanel * kLd;       // 1/sqrt(pivot) of the panel's rows
  float* zs = rs + kPanel;             // z of the panel's rows
  float* dps = zs + kPanel;            // dinv of the panel's rows (first panel)
  float* dcs = dps + kPanel;           // dinv of the block's columns (first panel)
  // the rows of R's diagonal block that warp 0 has published
  volatile int* ready = reinterpret_cast<volatile int*>(dcs + kStrip);

  QPDO_SPAN_BEGIN();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const int pc = (n - k0 < kPanel) ? n - k0 : kPanel;
  const int c0 = k0 + pc + blockIdx.x * kStrip;    // the block's first column
  const int ncols = (n - c0 < kStrip) ? ((n > c0) ? n - c0 : 0) : kStrip;
  const float* Sb = src + b * nn;
  float* Kb = K + b * nn;
  float* dinv = vec + static_cast<size_t>(b) * 4 * n;
  float* v = dinv + n;
  float* rdiag = v + n;
  float* z = rdiag + n;
  const float* rb = rhs + static_cast<size_t>(b) * n;

  // the thread's strip column (warps 1.., 4 lanes a column, 8 columns a
  // warp) and its rows there: sub, sub + 4, ..., sub + 28
  const int sub = lane & 3;
  const int sc = (warp - 1) * (32 / 4) + (lane >> 2);
  const int col = c0 + sc;
  const bool scol = warp > 0 && sc < ncols;

  wait_for_prior_grids();
  if (tid == 0) *ready = 0;
  if (kJacobi && kFirst) {
    if (tid < pc) dps[tid] = jacobi_scale(Sb[static_cast<size_t>(k0 + tid) * (n + 1)]);
    if (tid < ncols)
      dcs[tid] = jacobi_scale(Sb[static_cast<size_t>(c0 + tid) * (n + 1)]);
  }
  __syncthreads();
  // Khat = dinv K dinv + 100 eps32 I in the first panel of kkt_solve_global
  auto load = [&](int i, int j, float dj, bool diagonal) {
    float x = Sb[static_cast<size_t>(k0 + i) * n + j];
    if (kJacobi && kFirst) {
      x = x * dps[i] * dj;
      if (diagonal) x += kReg;
    }
    return x;
  };

  // ---- the diagonal block, warp 0: lane q holds column q in registers;
  // each pivot's row of R, 1/sqrt(pivot) and z published as it is done ----
  if (warp == 0) {
    float dcol[kPanel];
#pragma unroll
    for (int i = 0; i < kPanel; ++i)
      dcol[i] = (i <= lane && lane < pc)
                    ? load(i, k0 + lane, (kJacobi && kFirst) ? dps[lane] : 1.0f,
                           i == lane)
                    : 0.0f;
    float vq = 0.0f;                   // v of row lane
    if (lane < pc)
      vq = kFirst ? (kJacobi ? rb[k0 + lane] * dps[lane] : rb[k0 + lane]) : v[k0 + lane];
    QPDO_SPAN(0);                      // loads
    // kStep pivots an iteration, then the column moves up by kStep: the
    // register indices stay static and the loop's code stays small (the
    // code of all 32 pivots unrolled ran from beyond the instruction cache)
#pragma unroll 1
    for (int p0 = 0; p0 < pc; p0 += kStep) {
#pragma unroll
      for (int r = 0; r < kStep; ++r) {
        const int p = p0 + r;          // dcol[j] holds row p0 + j
        if (p < pc) {
          const float d = __shfl_sync(0xffffffffu, dcol[r], p);
          const float rp = pivot_scale(d);
          const float rq = dcol[r] * rp;    // R[p][lane] for lane >= p
          Rs[p * kLd + lane] = rq;
          float diag = d * rp;
          if (kClampDiv) diag = nan_max(diag, kTiny);
          const float zp = __shfl_sync(0xffffffffu, vq / diag, p);
          if (lane > p && lane < pc) vq -= zp * rq;
          if (lane == 0) {
            rs[p] = rp;
            zs[p] = zp;
          }
          __threadfence_block();
          __syncwarp();
          if (lane == 0) *ready = p + 1;
          // rows p+1.. of the column, in chunks of 8 rows that hold a row of
          // the panel; a row below the lane's diagonal is never read, so it
          // takes the update too rather than a test
#pragma unroll
          for (int c = 0; c < kPanel / 8; ++c) {
            if (p0 + 8 * c < pc) {
#pragma unroll
              for (int j = 8 * c; j < 8 * c + 8; ++j)
                if (j > r) dcol[j] -= Rs[p * kLd + p0 + j] * rq;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j) dcol[j] = (j + kStep < kPanel) ? dcol[j + kStep] : 0.0f;
    }
    QPDO_SPAN(1);                      // the diagonal block
  } else {
  // ---- the strip, warps 1..: R[p][col] = (K[p][col] - sum_q<p R[q][p]
  // R[q][col]) r_p, a pivot a step as soon as warp 0 has published it, the
  // row's value passed among the column's 4 lanes and stored by the lane
  // that holds the row; kStep pivots an iteration, then the rows move up by
  // one cell ----
  float cell[kStripRows];              // the thread's rows of its strip column
#pragma unroll
  for (int k = 0; k < kStripRows; ++k) {
    const int i = sub + 4 * k;
    cell[k] = (i < pc && scol)
                  ? load(i, col, (kJacobi && kFirst) ? dcs[sc] : 1.0f, false)
                  : 0.0f;
  }
  float vcol = 0.0f;                   // v of the column (lanes with sub 0)
  if (sub == 0 && scol) vcol = kFirst ? (kJacobi ? rb[col] * dcs[sc] : rb[col]) : v[col];
  const int group = lane & ~3;
  static_assert(kStep == 4, "a cell a lane per kStep pivots");
#pragma unroll 1
  for (int p0 = 0; p0 < pc; p0 += kStep) {
#pragma unroll
    for (int r = 0; r < kStep; ++r) {
      const int p = p0 + r;            // cell[k] holds row sub + p0 + 4k
      if (p < pc) {
        while (*ready <= p) __nanosleep(kSpinNs);
        __threadfence_block();
        float x = cell[0] * rs[p];     // in the lane with sub == r
        x = __shfl_sync(0xffffffffu, x, group | r);
        if (sub == r && scol) Kb[static_cast<size_t>(k0 + p) * n + col] = x;
        // rows p+1..; a row at or above p is stored already, one past
        // the panel never is, so they take the update too rather than a test
#pragma unroll
        for (int k = 0; k < kStripRows; ++k)
          cell[k] -= Rs[p * kLd + sub + p0 + 4 * k] * x;
        if (sub == 0) vcol -= zs[p] * x;
      }
    }
#pragma unroll
    for (int k = 0; k < kStripRows; ++k) cell[k] = (k + 1 < kStripRows) ? cell[k + 1] : 0.0f;
  }
  if (scol && sub == 0) v[col] = vcol;
  }
  __syncthreads();                     // R's diagonal block, rs and zs are complete
  QPDO_SPAN(2);                        // the strip

  // the rest of R and z: block 0 the diagonal block (strict upper part into
  // K's lower triangle) and z
  if (kJacobi && kFirst && tid < ncols) dinv[c0 + tid] = dcs[tid];
  if (blockIdx.x == 0) {
    for (int e = tid; e < kPanel * kPanel; e += kThreads) {
      const int q = e / kPanel;        // R[p][q] goes to K[k0 + q][k0 + p]
      const int p = e - q * kPanel;
      if (p < q && q < pc) Kb[static_cast<size_t>(k0 + q) * n + k0 + p] = Rs[p * kLd + q];
      else if (p == q && q < pc) rdiag[k0 + p] = Rs[p * kLd + p];
    }
    if (tid < pc) {
      z[k0 + tid] = zs[tid];
      if (kJacobi && kFirst) dinv[k0 + tid] = dps[tid];
    }
  }
  QPDO_SPAN(3);                        // the stores
}

// The panel's rank-pc update of one upper-triangle tile pair of the
// trailing matrix, block (pair, problem).  src: what the tile is read from
// (in the first panel the formed K, scaled and shifted, or the given K).
template <bool kJacobi, bool kFirst>
__global__ void __launch_bounds__(kThreads)
trailing_kernel(const float* src, float* K, const float* __restrict__ vec,
                int n, int k0) {
  extern __shared__ __align__(16) float large_smem[];
  float* Xi = large_smem;              // kPanel x kTile: strip over the tile's rows
  float* Xj = Xi + kPanel * kTile;     //   ... and over its columns

  QPDO_SPAN_BEGIN();
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const int pc = (n - k0 < kPanel) ? n - k0 : kPanel;
  const int t0 = k0 + pc;
  const int nt = (n - t0 + kTile - 1) / kTile;
  int bi = 0, rest = blockIdx.x;
  while (rest >= nt - bi) {
    rest -= nt - bi;
    ++bi;
  }
  const int i0 = t0 + bi * kTile;
  const int j0 = t0 + (bi + rest) * kTile;
  const float* Sb = src + b * nn;
  float* Kb = K + b * nn;
  const float* dinv = vec + static_cast<size_t>(b) * 4 * n;
  const float* Pk = Kb + static_cast<size_t>(k0) * n;   // the panel's rows of R

  wait_for_prior_grids();
  for (int e = tid; e < pc * kTile; e += kThreads) {
    const int p = e / kTile;
    const int c = e - p * kTile;
    const float* row = Pk + static_cast<size_t>(p) * n;
    Xi[e] = (i0 + c < n) ? row[i0 + c] : 0.0f;
    Xj[e] = (j0 + c < n) ? row[j0 + c] : 0.0f;
  }
  // the thread's micro-tile: rows i0 + 4 ty + a, columns j0 + 4 tx + c
  const int ty = tid / kGrid;
  const int tx = tid % kGrid;
  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int i = i0 + kMicro * ty + a;
      const int j = j0 + kMicro * tx + c;
      float x = 0.0f;
      if (i < n && j < n && j >= i) {
        x = Sb[static_cast<size_t>(i) * n + j];
        if (kJacobi && kFirst) {
          x = x * dinv[i] * dinv[j];
          if (i == j) x += kReg;
        }
      }
      acc[a][c] = x;
    }
  }
  __syncthreads();
  QPDO_SPAN(4);                        // loads
#pragma unroll 4
  for (int p = 0; p < pc; ++p) {
    const Float4 xi = *reinterpret_cast<const Float4*>(Xi + p * kTile + kMicro * ty);
    const Float4 xj = *reinterpret_cast<const Float4*>(Xj + p * kTile + kMicro * tx);
#pragma unroll
    for (int a = 0; a < kMicro; ++a)
#pragma unroll
      for (int c = 0; c < kMicro; ++c) acc[a][c] -= xi.v[a] * xj.v[c];
  }
#pragma unroll
  for (int a = 0; a < kMicro; ++a) {
#pragma unroll
    for (int c = 0; c < kMicro; ++c) {
      const int i = i0 + kMicro * ty + a;
      const int j = j0 + kMicro * tx + c;
      if (i < n && j < n && j >= i) Kb[static_cast<size_t>(i) * n + j] = acc[a][c];
    }
  }
  QPDO_SPAN(5);                        // the update and the stores
}

// R x = z, one block per problem, a panel at a time from the last: R's
// panel rows right of the diagonal block in K's upper triangle, the strict
// upper part of each diagonal block transposed in K's lower triangle, its
// diagonal in vec.  For the panel of rows k0.., each row's dot product
// with the solved x splits into the next panel's 32 columns (near) and
// the rest (far); warps 1.. sum the far part of the panel below while
// warp 0 solves this panel's 32x32 block with shuffles, so the dot
// products wait on no solve but the one before.  Writes dx (unscaled by
// dinv for kJacobi).
template <bool kJacobi, bool kClampDiv>
__global__ void __launch_bounds__(kThreads)
back_kernel(const float* __restrict__ K, float* vec, float* __restrict__ dx,
            int n) {
  extern __shared__ __align__(16) float large_smem[];
  float* far = large_smem;             // the far part of the panel's dot products
  float* ss = far + kPanel;            // the whole dot products

  QPDO_SPAN_BEGIN();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const float* Kb = K + b * static_cast<size_t>(n) * n;
  float* dinv = vec + static_cast<size_t>(b) * 4 * n;
  float* v = dinv + n;                 // x, as it is solved
  const float* rdiag = v + n;
  const float* z = rdiag + n;

  wait_for_prior_grids();
  if (tid < kPanel) far[tid] = 0.0f;
  __syncthreads();
  for (int k0 = (n - 1) / kPanel * kPanel; k0 >= 0; k0 -= kPanel) {
    const int pc = (n - k0 < kPanel) ? n - k0 : kPanel;
    const int t0 = k0 + pc;
    const int tn = (n - t0 < kPanel) ? n : t0 + kPanel;   // the near columns end
    // the near part: a warp a row, a lane a column
    for (int p = warp; p < pc; p += kWarps) {
      const int j = t0 + lane;
      float s = (j < tn) ? Kb[static_cast<size_t>(k0 + p) * n + j] * v[j] : 0.0f;
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ss[p] = far[p] + s;
    }
    __syncthreads();
    if (warp == 0) {
      // lane q: row q of the block, R[q][p] for p > q, its divisor
      float row[kPanel];
#pragma unroll
      for (int p = 0; p < kPanel; ++p)
        row[p] = (lane < p && p < pc) ? Kb[static_cast<size_t>(k0 + p) * n + k0 + lane] : 0.0f;
      float diag = (lane < pc) ? rdiag[k0 + lane] : 1.0f;
      if (kClampDiv) diag = nan_max(diag, kTiny);
      float acc = (lane < pc) ? z[k0 + lane] - ss[lane] : 0.0f;
      float xq = 0.0f;
#pragma unroll
      for (int p = kPanel - 1; p >= 0; --p) {
        if (p < pc) {
          const float xp = __shfl_sync(0xffffffffu, acc / diag, p);
          if (lane < p) acc -= row[p] * xp;
          if (lane == p) xq = xp;
        }
      }
      if (lane < pc) v[k0 + lane] = xq;
    } else if (k0 > 0) {
      // the far part of the panel below (rows k0 - kPanel ..): columns t0..
      const float* P = Kb + static_cast<size_t>(k0 - kPanel) * n;
      for (int p = warp - 1; p < kPanel; p += kWarps - 1) {
        const float* r = P + static_cast<size_t>(p) * n;
        float s = 0.0f;
        for (int j = t0 + lane; j < n; j += 32) s += r[j] * v[j];
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) far[p] = s;
      }
    }
    __syncthreads();
  }
  QPDO_SPAN(6);                        // the back substitution

  for (int i = tid; i < n; i += kThreads)
    dx[static_cast<size_t>(b) * n + i] = kJacobi ? v[i] * dinv[i] : v[i];
}

// The launch sequence: per panel the panel kernel and, while rows remain
// below it, the trailing update; then the back substitution.  src: the
// first panel's source (the workspace for kJacobi, else the given K).
template <bool kJacobi, bool kClampDiv>
int launch_factor(const float* src, const float* rhs, float* dx, float* work,
                  int B, int n, cudaStream_t stream) {
  if (B > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  float* K = work;
  float* vec = work + static_cast<size_t>(B) * n * n;
  // every kernel's shared memory stays under 48 KB: no grant
  const size_t panel_bytes = kPanelFloats * sizeof(float);
  const size_t trail_bytes = kTrailFloats * sizeof(float);
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int t0 = (n - k0 < kPanel) ? n : k0 + kPanel;
    const int strips = (n - t0 + kStrip - 1) / kStrip;
    const dim3 panel_grid(strips > 0 ? strips : 1, B);
    cudaError_t err =
        (k0 == 0) ? launch_dependent(panel_kernel<kJacobi, kClampDiv, true>,
                                     panel_grid, panel_bytes, stream, src, rhs,
                                     K, vec, n, k0)
                  : launch_dependent(panel_kernel<kJacobi, kClampDiv, false>,
                                     panel_grid, panel_bytes, stream,
                                     static_cast<const float*>(K), rhs, K, vec,
                                     n, k0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (t0 >= n) break;
    const int nt = (n - t0 + kTile - 1) / kTile;
    const dim3 trail_grid(nt * (nt + 1) / 2, B);
    err = (k0 == 0) ? launch_dependent(trailing_kernel<kJacobi, true>,
                                       trail_grid, trail_bytes, stream, src, K,
                                       static_cast<const float*>(vec), n, k0)
                    : launch_dependent(trailing_kernel<kJacobi, false>,
                                       trail_grid, trail_bytes, stream,
                                       static_cast<const float*>(K), K,
                                       static_cast<const float*>(vec), n, k0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_dependent(
      back_kernel<kJacobi, kClampDiv>, dim3(B), kBackFloats * sizeof(float),
      stream, static_cast<const float*>(K), vec, dx, n));
}

}  // namespace

// work: B*n*n + 4*B*n floats; partial: kernel 1's partial sums, (B, S, n, n)
// floats for splits S > 1, else null.
extern "C" int qpdo_kkt_solve_global_f32(const void* Q, const void* A,
                                         const void* w, const void* sigma,
                                         const void* rhs, void* dx, void* work,
                                         void* partial, int B, int m, int n,
                                         int splits, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int err = qpdo_formation_f32(A, w, Q, sigma, work, partial, B, m, n,
                                     splits, stream);
  if (err != 0) return err;
  return launch_factor<true, false>(static_cast<const float*>(work),
                                    static_cast<const float*>(rhs),
                                    static_cast<float*>(dx),
                                    static_cast<float*>(work), B, n,
                                    static_cast<cudaStream_t>(stream));
}

#ifdef QPDO_PHASE_CLOCKS
extern "C" int qpdo_kkt_large_phase_clocks(long long* out) {
  return read_phase_clocks(out);
}

extern "C" int qpdo_kkt_large_phase_clocks_reset() {
  return reset_phase_clocks();
}
#endif

// work: B*n*n + 4*B*n floats.
extern "C" int qpdo_chol_solve_global_f32(const void* K, const void* rhs,
                                          void* dx, void* work, int B, int n,
                                          void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_factor<false, true>(static_cast<const float*>(K),
                                    static_cast<const float*>(rhs),
                                    static_cast<float*>(dx),
                                    static_cast<float*>(work), B, n,
                                    static_cast<cudaStream_t>(stream));
}
