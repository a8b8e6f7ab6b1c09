// Fused KKT formation for a batch of dense QPs:
//
//     K[b] = A[b]' diag(w[b]) A[b] + Q[b] + sigma[b] * I
//
// with A (B, m, n), w (B, m), Q (B, n, n), sigma (B,) -> K (B, n, n), all
// row-major and contiguous, in float or double.
//
// Replaces the TPU kernel qpdo_tpu/ops/pallas_formation.py:_kernel (l.24),
// which keeps one problem's padded A in VMEM, scales it by w there and
// contracts it on the MXU, so that w∘A never reaches memory.
//
// What bounds it on the H100: K is symmetric, so at the bench shape (B=256,
// m=150, n=100) one call needs m*n*(n+1)*B = 0.39 GFLOP over 36 MB in
// float32: the floor is the memory time (about 11 us), with the SIMT FMA
// time (no tensor cores: the product must keep full float32 or float64
// accuracy) at about half of it.  The matrices are small (n=100) and only
// two blocks share an SM, so what decides the time in practice is how few
// shared-memory loads and how little padding each FMA costs.
//
// Design:
//  * A block owns one (row tile, column tile) pair of K with row tile <=
//    column tile, edge kTile (32, 64 or 128: the smallest that covers n,
//    so n <= 128 is one block per problem), and walks over all m rows of
//    A.  A' diag(w) A is symmetric, so the tiles below the diagonal are
//    never computed.
//  * Inside the block each thread owns one 8x4 micro-tile of K in
//    registers (in double that is 64 accumulators of two registers: at
//    the cap of 128 registers ptxas spills 40 bytes; a 4x4 micro-tile with
//    64-wide tiles had no spill and took 1.6 times as long).  Only the
//    micro-tiles that reach the diagonal or lie above it are handed out,
//    and only those inside n: the block's thread count
//    is the number of such micro-tiles (169 for n=100, where a padded
//    128x128 tile would hold 512), so the padding costs a few percent of
//    the FMAs and the symmetry saves nearly half of them.
//  * Per row k a thread loads its 8 row-side and 4 column-side values of A
//    with 16-byte shared-memory loads (3 loads for 32 FMAs in float32),
//    scales the column side by w[k] in registers (the TPU kernel's product
//    order A[k,i] * (w[k] * A[k,j]); w∘A never reaches any memory), and
//    accumulates in the input type (float64 inputs in float64).
//  * A and w are staged with cp.async (16 bytes a thread where n and the
//    pointers allow it, one element otherwise) into a ring of kStages
//    stages of kStageRows rows (2 of 32, the fastest of those timed by
//    scripts/tune_kkt_solve.py); the next stage's loads are in flight
//    while this one is multiplied, one barrier per stage.
//  * The epilogue writes K[i,j] for j >= i and its mirror K[j,i] for j > i,
//    each plus Q read at its own position (Q need not be symmetric), sigma
//    on the diagonal; every entry of K is written exactly once, no atomics.

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "phase_clocks.cuh"
#include "shared_grant.cuh"

namespace {

#ifndef QPDO_FORMATION_STAGES
#define QPDO_FORMATION_STAGES 2
#endif
#ifndef QPDO_FORMATION_STAGE_ROWS
#define QPDO_FORMATION_STAGE_ROWS 32
#endif
constexpr int kStages = QPDO_FORMATION_STAGES;       // ring of shared stages
static_assert(kStages >= 2, "the next stage loads while this one is multiplied");
constexpr int kStageRows = QPDO_FORMATION_STAGE_ROWS;  // rows of A per stage
constexpr int kMicroRows = 8;       // a thread's micro-tile: 8 rows of K
constexpr int kMicroCols = 4;       //   by 4 columns
constexpr int kMaxThreads = 512;    // micro-tiles of a full 128x128 tile

constexpr int kMaxGridY = 65535;

// micro-tiles per row of micro-tiles: columns lo(ti) .. pj-1, where a
// diagonal block starts at the micro-tile that reaches the diagonal
__host__ __device__ inline int first_col_tile(bool diag, int ti) {
  return diag ? ti * (kMicroRows / kMicroCols) : 0;
}

__host__ __device__ inline int count_micro_tiles(bool diag, int nr, int nc) {
  const int pi = (nr + kMicroRows - 1) / kMicroRows;
  const int pj = (nc + kMicroCols - 1) / kMicroCols;
  int count = 0;
  for (int ti = 0; ti < pi; ++ti) {
    const int c = pj - first_col_tile(diag, ti);
    if (c > 0) count += c;
  }
  return count;
}

// K[o .. o+3] = v + Q[o .. o+3], in 16-byte pieces
template <typename T>
__device__ __forceinline__ void add_store4(const T* __restrict__ Q,
                                           T* __restrict__ K, size_t o,
                                           const T (&v)[4]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < 4 / V; ++q) {
    const Pack<T> qk = *reinterpret_cast<const Pack<T>*>(Q + o + q * V);
    Pack<T> out;
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = v[q * V + e] + qk.v[e];
    *reinterpret_cast<Pack<T>*>(K + o + q * V) = out;
  }
}

template <typename T, int kTile, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
formation_kernel(const T* __restrict__ A, const T* __restrict__ w,
                 const T* __restrict__ Q, const T* __restrict__ sigma,
                 T* __restrict__ K, int m, int n, int strips) {
  extern __shared__ __align__(16) unsigned char formation_smem[];
  constexpr int V = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;   // elements per copy
  constexpr int kCopyBytes = V * static_cast<int>(sizeof(T));
  constexpr int kStrip = kStageRows * kTile;       // elements of one strip
  const int stage_elems = strips * kStrip + kStageRows;
  T* const smem = reinterpret_cast<T*>(formation_smem);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.y;
  QPDO_LAPS_BEGIN();

  // the block's tile pair: blockIdx.x counts the pairs (bi <= bj) by rows
  const int ntile = (n + kTile - 1) / kTile;
  int bi = 0, rest = blockIdx.x;
  while (rest >= ntile - bi) {
    rest -= ntile - bi;
    ++bi;
  }
  const int bj = bi + rest;
  const bool diag = (bi == bj);
  const int i0 = bi * kTile, j0 = bj * kTile;
  const int nr = (n - i0 < kTile) ? n - i0 : kTile;
  const int nc = (n - j0 < kTile) ? n - j0 : kTile;

  // the thread's micro-tile (ti, tj), if it has one
  const int pi = (nr + kMicroRows - 1) / kMicroRows;
  const int pj = (nc + kMicroCols - 1) / kMicroCols;
  int ti = 0, tj = tid;
  bool active = false;
  for (; ti < pi; ++ti) {
    const int lo = first_col_tile(diag, ti);
    const int c = pj - lo;
    if (c <= 0) continue;
    if (tj < c) {
      tj += lo;
      active = true;
      break;
    }
    tj -= c;
  }
  if (!active) ti = tj = 0;     // a valid address; nothing is accumulated

  const T* Ab = A + static_cast<size_t>(b) * m * n;
  const T* wb = w + static_cast<size_t>(b) * m;

  // the staging copies of one strip, dealt out to the threads in turn:
  // (row, chunk) of a thread's first copy and its step to the next
  const int chunks_i = (nr + V - 1) / V, chunks_j = (nc + V - 1) / V;
  const int2 first_i = make_int2(tid / chunks_i, tid % chunks_i);
  const int2 first_j = make_int2(tid / chunks_j, tid % chunks_j);
  const int2 step_i = make_int2(nthreads / chunks_i, nthreads % chunks_i);
  const int2 step_j = make_int2(nthreads / chunks_j, nthreads % chunks_j);

  // stage s of the ring: rows k0 .. k0+kc-1 of the row strip, of the
  // column strip where it is another one, and of w
  auto issue = [&](int s) {
    const int k0 = s * kStageRows;
    if (k0 < m) {
      const int kc = (m - k0 < kStageRows) ? m - k0 : kStageRows;
      T* dst = smem + static_cast<size_t>(s % kStages) * stage_elems;
      const T* src = Ab + static_cast<size_t>(k0) * n;
      // copy e = tid, tid + nthreads, ... is chunk ch of row kk, stepped
      // without a division
      for (int strip = 0; strip < strips; ++strip) {
        const int c0 = strip ? j0 : i0;
        const int chunks = strip ? chunks_j : chunks_i;
        int kk = strip ? first_j.x : first_i.x;
        int ch = strip ? first_j.y : first_i.y;
        const int2 step = strip ? step_j : step_i;
        while (kk < kc) {
          copy_async<kCopyBytes>(dst + strip * kStrip + kk * kTile + ch * V,
                                 src + static_cast<size_t>(kk) * n + c0 + ch * V);
          kk += step.x;
          ch += step.y;
          if (ch >= chunks) {
            ch -= chunks;
            ++kk;
          }
        }
      }
      if (tid < kc)
        copy_async<static_cast<int>(sizeof(T))>(dst + strips * kStrip + tid,
                                                wb + k0 + tid);
    }
    copy_async_commit();       // one group per stage, empty past the end
  };

  T acc[kMicroRows][kMicroCols];
#pragma unroll
  for (int r = 0; r < kMicroRows; ++r)
#pragma unroll
    for (int c = 0; c < kMicroCols; ++c) acc[r][c] = T(0);

  const int nstage = (m + kStageRows - 1) / kStageRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  QPDO_LAP(0);                           // prologue
  for (int s = 0; s < nstage; ++s) {
    copy_async_wait<kStages - 2>();      // stage s has landed (this thread's part)
    QPDO_LAP(1);
    __syncthreads();                     // ... and everyone's; stage s-1 is consumed
    QPDO_LAP(2);
    issue(s + kStages - 1);              // into the buffer of stage s-1
    QPDO_LAP(3);
    const int k0 = s * kStageRows;
    const int kc = (m - k0 < kStageRows) ? m - k0 : kStageRows;
    const T* st = smem + static_cast<size_t>(s % kStages) * stage_elems;
    const T* si = st + kMicroRows * ti;
    const T* sj = st + (strips - 1) * kStrip + kMicroCols * tj;
    const T* sw = st + strips * kStrip;
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        T ai[kMicroRows], aj[kMicroCols];
        load_packs(si + kk * kTile, ai);
        load_packs(sj + kk * kTile, aj);
        const T wk = sw[kk];
#pragma unroll
        for (int c = 0; c < kMicroCols; ++c) aj[c] = wk * aj[c];
#pragma unroll
        for (int r = 0; r < kMicroRows; ++r)
#pragma unroll
          for (int c = 0; c < kMicroCols; ++c) acc[r][c] += ai[r] * aj[c];
      }
    }
    QPDO_LAP(4);                         // multiplication
  }
  if (!active) return;

  // ---- epilogue: K[i,j] (j >= i) and its mirror K[j,i] (j > i) ----
  const size_t base = static_cast<size_t>(b) * n * n;
  const T* Qb = Q + base;
  T* Kb = K + base;
  const T sig = sigma[b];
  const int gi = i0 + kMicroRows * ti;     // first row of the micro-tile
  const int gj = j0 + kMicroCols * tj;     // first column
  // the whole micro-tile lies strictly above the diagonal and inside n
  const bool whole = kVec && gj > gi + kMicroRows - 1 &&
                     gi + kMicroRows <= n && gj + kMicroCols <= n;
  if (whole) {
#pragma unroll
    for (int r = 0; r < kMicroRows; ++r)
      add_store4<T>(Qb, Kb, static_cast<size_t>(gi + r) * n + gj, acc[r]);
#pragma unroll
    for (int c = 0; c < kMicroCols; ++c) {
#pragma unroll
      for (int h = 0; h < kMicroRows / 4; ++h) {
        T col[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) col[e] = acc[4 * h + e][c];
        add_store4<T>(Qb, Kb, static_cast<size_t>(gj + c) * n + gi + 4 * h, col);
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kMicroRows; ++r) {
    const int i = gi + r;
#pragma unroll
    for (int c = 0; c < kMicroCols; ++c) {
      const int j = gj + c;
      if (i < n && j < n && j >= i) {
        const size_t o = static_cast<size_t>(i) * n + j;
        T v = acc[r][c] + Qb[o];
        if (i == j) v += sig;
        Kb[o] = v;
        if (j > i) {
          const size_t t = static_cast<size_t>(j) * n + i;
          Kb[t] = acc[r][c] + Qb[t];
        }
      }
    }
  }
  QPDO_LAP(5);      // epilogue (the recording thread's micro-tile is on the diagonal)
  QPDO_LAPS_END();
}

template <typename T, int kTile, bool kVec>
int launch_tiles(const T* A, const T* w, const T* Q, const T* sigma, T* K,
                 int B, int m, int n, cudaStream_t stream) {
  const int ntile = (n + kTile - 1) / kTile;
  const int pairs = ntile * (ntile + 1) / 2;
  const int strips = (ntile > 1) ? 2 : 1;
  // the most micro-tiles any block of the grid hands out
  int count = count_micro_tiles(true, n < kTile ? n : kTile, n < kTile ? n : kTile);
  if (ntile > 1) {
    const int full = count_micro_tiles(false, kTile, kTile);
    if (full > count) count = full;
  }
  const int threads = (count + 31) / 32 * 32;
  const size_t bytes = static_cast<size_t>(kStages) *
                       (strips * kStageRows * kTile + kStageRows) * sizeof(T);
  auto kernel = formation_kernel<T, kTile, kVec>;
  static SharedGrant grant;              // one per kernel instance
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      grant_shared(reinterpret_cast<const void*>(kernel), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid(pairs, nb);
    const dim3 block(threads);
    const T* Ab = A + static_cast<size_t>(b0) * m * n;
    const T* wb = w + static_cast<size_t>(b0) * m;
    const T* Qb = Q + static_cast<size_t>(b0) * n * n;
    T* Kb = K + static_cast<size_t>(b0) * n * n;
    kernel<<<grid, block, bytes, stream>>>(Ab, wb, Qb, sigma + b0, Kb, m, n, strips);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_aligned(const T* A, const T* w, const T* Q, const T* sigma, T* K,
                   int B, int m, int n, cudaStream_t stream) {
  // the tile edge follows n: the shared stages are kTile wide
  if (n <= 32) return launch_tiles<T, 32, kVec>(A, w, Q, sigma, K, B, m, n, stream);
  if (n <= 64) return launch_tiles<T, 64, kVec>(A, w, Q, sigma, K, B, m, n, stream);
  return launch_tiles<T, 128, kVec>(A, w, Q, sigma, K, B, m, n, stream);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <typename T>
int launch_formation(const T* A, const T* w, const T* Q, const T* sigma,
                     T* K, int B, int m, int n, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  // 16-byte copies need rows of A, Q and K that start on 16 bytes
  const bool vec = (n * sizeof(T)) % 16 == 0 && aligned16(A) && aligned16(Q) &&
                   aligned16(K);
  return vec ? launch_aligned<T, true>(A, w, Q, sigma, K, B, m, n, stream)
             : launch_aligned<T, false>(A, w, Q, sigma, K, B, m, n, stream);
}

}  // namespace

extern "C" int qpdo_formation_f32(const void* A, const void* w, const void* Q,
                                  const void* sigma, void* K, int B, int m,
                                  int n, void* stream) {
  return launch_formation(static_cast<const float*>(A),
                          static_cast<const float*>(w),
                          static_cast<const float*>(Q),
                          static_cast<const float*>(sigma),
                          static_cast<float*>(K), B, m, n,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int qpdo_formation_f64(const void* A, const void* w, const void* Q,
                                  const void* sigma, void* K, int B, int m,
                                  int n, void* stream) {
  return launch_formation(static_cast<const double*>(A),
                          static_cast<const double*>(w),
                          static_cast<const double*>(Q),
                          static_cast<const double*>(sigma),
                          static_cast<double*>(K), B, m, n,
                          static_cast<cudaStream_t>(stream));
}

#ifdef QPDO_PHASE_CLOCKS
extern "C" int qpdo_formation_phase_clocks(long long* out) {
  return read_phase_clocks(out);
}
#endif

extern "C" const char* qpdo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
