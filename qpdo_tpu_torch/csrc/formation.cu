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
// shared-memory loads and how little padding each FMA costs.  With few
// problems of many rows (the row-sharded solve: B=1, m=50,000, n=200,
// 2.0 GFLOP in float64 by the count above) the work is the FMAs, and one
// block per problem and tile pair would leave all but 3 of the 132 SMs
// idle: there the grid, not the block, bounds the time.
//
// Design:
//  * A block owns one (row tile, column tile) pair of K with row tile <=
//    column tile, edge kTile (32, 64 or 128: the smallest that covers n,
//    so n <= 128 is one block per problem), and walks over the m rows of
//    A.  A' diag(w) A is symmetric, so the tiles below the diagonal are
//    never computed.
//  * Split rows (few problems, many rows): the caller passes S, the
//    number of chunks (ops/fused_formation.formation_splits picks it from
//    (B, m, n) and the SM count: 1 at the bench shape; where B x tile
//    pairs is below the SM count, as many chunks of at least 256 rows as
//    fill the SMs once).  The grid's z index is the chunk: each block walks its
//    chunk's rows, a whole number of stages, exactly as the unsplit block
//    walks all of them, and writes its partial upper-triangle tile to a
//    workspace (B, S, n, n) instead of K.  A second kernel then adds the
//    S partial sums of each entry in the order of the chunks (no atomics:
//    two calls give the same bits), adds Q and sigma and writes the
//    mirror, as the epilogue below does.  S = 1 is the unsplit kernel,
//    launch for launch.  In float64 with 128-wide tiles the split blocks
//    run formation_mma_kernel instead: the same product on the FP64
//    tensor cores (mma.m16n8k4, IEEE fused multiply-adds, twice the FP64
//    rate of the SIMT units), a warp a 32x32 region of the tile.  Float32
//    stays on the SIMT units in full float32 (no TF32).
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

#include <cmath>

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

constexpr int kMaxGridY = 65535;   // also the most chunks (grid z)
constexpr int kSumThreads = 256;    // threads of a block of the second pass

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

// kSplit: the block walks chunk blockIdx.z of the rows and writes its
// partial sum; else all rows, into K (the unsplit kernel)
template <typename T, int kTile, bool kVec, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads)
formation_kernel(const T* __restrict__ A, const T* __restrict__ w,
                 const T* __restrict__ Q, const T* __restrict__ sigma,
                 T* __restrict__ K, T* __restrict__ partial, int m, int n,
                 int strips, int chunk) {
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

  // the block's rows of A: chunk s of the rows (all of them unless split)
  const int s_split = kSplit ? static_cast<int>(blockIdx.z) : 0;
  const int r0 = s_split * chunk;
  const int rows = !kSplit ? m : (m - r0 < chunk) ? m - r0 : chunk;
  const T* Ab = A + (static_cast<size_t>(b) * m + r0) * n;
  const T* wb = w + static_cast<size_t>(b) * m + r0;

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
    if (k0 < rows) {
      const int kc = (rows - k0 < kStageRows) ? rows - k0 : kStageRows;
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

  const int nstage = (rows + kStageRows - 1) / kStageRows;
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
    const int kc = (rows - k0 < kStageRows) ? rows - k0 : kStageRows;
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

  const int gi = i0 + kMicroRows * ti;     // first row of the micro-tile
  const int gj = j0 + kMicroCols * tj;     // first column

  // ---- split rows: the partial sum of this chunk, upper triangle only ----
  if (kSplit) {
    T* Pb = partial + (static_cast<size_t>(b) * gridDim.z + s_split) * n * n;
#pragma unroll
    for (int r = 0; r < kMicroRows; ++r) {
#pragma unroll
      for (int c = 0; c < kMicroCols; ++c) {
        const int i = gi + r, j = gj + c;
        if (i < n && j < n && j >= i) Pb[static_cast<size_t>(i) * n + j] = acc[r][c];
      }
    }
    return;
  }

  // ---- epilogue: K[i,j] (j >= i) and its mirror K[j,i] (j > i) ----
  const size_t base = static_cast<size_t>(b) * n * n;
  const T* Qb = Q + base;
  T* Kb = K + base;
  const T sig = sigma[b];
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

// ---------------------------------------------------------------------
// The split route in float64 on the FP64 tensor cores
// ---------------------------------------------------------------------

constexpr int kMmaTile = 128;                // a block's tile of K (n > 64)
constexpr int kMmaRegion = 32;               // a warp's region: 32 x 32
constexpr int kMmaSide = kMmaTile / kMmaRegion;
constexpr int kMmaThreads = 32 * kMmaSide * kMmaSide;   // a warp a region
constexpr int kMmaLd = kMmaTile + 4;         // doubles of a staged row: a
                                             // fragment load is conflict-free
constexpr int kMmaStageDoubles = 2 * kStageRows * kMmaLd + kStageRows;

// D += A B for one 16x8x4 tile, the fragments of mma.m16n8k4 .f64 (gid =
// lane / 4, tig = lane % 4): this lane holds A[gid + 8 h][tig] in a[h],
// B[tig][gid] in b and D[gid + 8 (c / 2)][2 tig + c % 2] in d[c]; products
// and sums are IEEE fused multiply-adds.  (m8n8k4 runs at half the FP64
// tensor rate on the H100: 33.1 against 65.8 TFLOP/s for m16n8k4 on an
// NVIDIA H100 80GB HBM3 at 700 W, scripts/mma_f64_probe.cu.)
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[2],
                                        double b) {
#ifdef QPDO_CUDA_STUB
  // the other lanes' fragments through the warp's exchange slots: A[gid +
  // 8 h][k] sits in lane 4 gid + k, B[k][c] in lane 4 c + k
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  uint64_t* slots = cuda_stub::warp_slots();
  double a0[4], a1[4], b0[4], b1[4];
  auto gather = [&](double mine, int first, double (&out)[4]) {
    std::memcpy(&slots[lane], &mine, sizeof(double));
    __syncwarp();
    for (int k = 0; k < 4; ++k) std::memcpy(&out[k], &slots[first + k], sizeof(double));
    __syncwarp();
  };
  gather(a[0], 4 * gid, a0);
  gather(a[1], 4 * gid, a1);
  std::memcpy(&slots[lane], &b, sizeof(double));
  __syncwarp();
  for (int k = 0; k < 4; ++k) {
    std::memcpy(&b0[k], &slots[8 * tig + k], sizeof(double));
    std::memcpy(&b1[k], &slots[8 * tig + 4 + k], sizeof(double));
  }
  __syncwarp();
  for (int k = 0; k < 4; ++k) {
    d[0] = std::fma(a0[k], b0[k], d[0]);
    d[1] = std::fma(a0[k], b1[k], d[1]);
    d[2] = std::fma(a1[k], b0[k], d[2]);
    d[3] = std::fma(a1[k], b1[k], d[3]);
  }
#else
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
#endif
}

// One block per (tile pair of K, problem, chunk of rows), as the split
// route of formation_kernel, writing the chunk's partial sum of
// A' diag(w) A (upper triangle, within n) to `partial`.  The 32x32 regions
// of the 128x128 tile that reach the diagonal or lie above it, and inside
// n, are dealt to the warps so that each of the SM's four schedulers
// (warp % 4) gets as many as the others, give or take one.  Per 4 rows of
// A a warp loads 2 fragments of the row strip and 4 of the column strip
// (scaled by w[k] in registers: A[k,i] * (w[k] * A[k,j]), the product
// order of formation_kernel) and issues 8 mma.m16n8k4.  The stages are staged with
// cp.async as in formation_kernel, into rows padded to kMmaLd doubles;
// rows past the chunk's end are zero up to a multiple of 4.
template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads, 1)
formation_mma_kernel(const double* __restrict__ A, const double* __restrict__ w,
                     double* __restrict__ partial, int m, int n, int chunk) {
  extern __shared__ __align__(16) unsigned char formation_smem[];
  constexpr int V = kVec ? 2 : 1;              // doubles per copy
  double* const smem = reinterpret_cast<double*>(formation_smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.y;
  const int s_split = blockIdx.z;

  const int ntile = (n + kMmaTile - 1) / kMmaTile;
  int bi = 0, rest = blockIdx.x;
  while (rest >= ntile - bi) {
    rest -= ntile - bi;
    ++bi;
  }
  const int bj = bi + rest;
  const bool diag = (bi == bj);
  const int i0 = bi * kMmaTile, j0 = bj * kMmaTile;
  // this warp's region: the warp-th of the tile's live regions in
  // row-major order, so that live region k runs on scheduler k % 4
  int ri = 0, ci = 0, live = 0;
  bool active = false;
  for (int r = 0; r < kMmaSide && !active; ++r) {
    for (int c = 0; c < kMmaSide; ++c) {
      if ((diag && c < r) || i0 + kMmaRegion * r >= n || j0 + kMmaRegion * c >= n)
        continue;
      if (live++ == warp) {
        ri = r;
        ci = c;
        active = true;
        break;
      }
    }
  }

  const int r0 = s_split * chunk;
  const int rows = (m - r0 < chunk) ? m - r0 : chunk;
  const double* Ab = A + (static_cast<size_t>(b) * m + r0) * n;
  const double* wb = w + static_cast<size_t>(b) * m + r0;

  // stage s: rows k0 .. k0+kc-1 of the row strip (columns i0 ..), of the
  // column strip (j0 .., the same strip on a diagonal tile) and of w
  auto issue = [&](int s) {
    const int k0 = s * kStageRows;
    if (k0 < rows) {
      const int kc = (rows - k0 < kStageRows) ? rows - k0 : kStageRows;
      double* dst = smem + static_cast<size_t>(s % kStages) * kMmaStageDoubles;
      const double* src = Ab + static_cast<size_t>(k0) * n;
      for (int strip = 0; strip < (diag ? 1 : 2); ++strip) {
        const int c0 = strip ? j0 : i0;
        const int cols = (n - c0 < kMmaTile) ? n - c0 : kMmaTile;
        const int per_row = (cols + V - 1) / V;
        double* sd = dst + strip * kStageRows * kMmaLd;
        for (int e = tid; e < kc * per_row; e += kMmaThreads) {
          const int kk = e / per_row;
          const int ch = e - kk * per_row;
          copy_async<V * 8>(sd + kk * kMmaLd + ch * V,
                            src + static_cast<size_t>(kk) * n + c0 + ch * V);
        }
        // rows up to the next multiple of 4 are zero
        for (int e = tid; e < ((kc + 3) / 4 * 4 - kc) * kMmaTile; e += kMmaThreads)
          sd[(kc + e / kMmaTile) * kMmaLd + e % kMmaTile] = 0.0;
      }
      double* sw = dst + 2 * kStageRows * kMmaLd;
      if (tid < kc)
        copy_async<8>(sw + tid, wb + k0 + tid);
      else if (tid < (kc + 3) / 4 * 4)
        sw[tid] = 0.0;
    }
    copy_async_commit();
  };

  double acc[2][4][4];                   // 2 x 4 tiles of 16 x 8
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][u][c] = 0.0;

  const int nstage = (rows + kStageRows - 1) / kStageRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < nstage; ++s) {
    copy_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    const int k0 = s * kStageRows;
    const int kc = (rows - k0 < kStageRows) ? rows - k0 : kStageRows;
    const double* st = smem + static_cast<size_t>(s % kStages) * kMmaStageDoubles;
    const double* si = st + kMmaRegion * ri + gid;
    const double* sj = st + (diag ? 0 : kStageRows * kMmaLd) + kMmaRegion * ci + gid;
    const double* sw = st + 2 * kStageRows * kMmaLd;
    if (active) {
      for (int kk = 0; kk < kc; kk += 4) {
        const int row = (kk + tig) * kMmaLd;
        const double wk = sw[kk + tig];
        double a[2][2], bv[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          a[t][0] = si[row + 16 * t];
          a[t][1] = si[row + 16 * t + 8];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = wk * sj[row + 8 * u];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_f64(acc[t][u], a[t], bv[u]);
      }
    }
  }
  if (!active) return;

  double* Pb = partial + (static_cast<size_t>(b) * gridDim.z + s_split) * n * n;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + kMmaRegion * ri + 16 * t + 8 * (c >> 1) + gid;
        const int j = j0 + kMmaRegion * ci + 8 * u + 2 * tig + (c & 1);
        if (i < n && j < n && j >= i) Pb[static_cast<size_t>(i) * n + j] = acc[t][u][c];
      }
    }
  }
}

template <bool kVec>
int launch_split_mma(const double* A, const double* w, double* partial, int b0,
                     int nb, int m, int n, int used, int chunk,
                     cudaStream_t stream) {
  const int ntile = (n + kMmaTile - 1) / kMmaTile;
  const size_t bytes = static_cast<size_t>(kStages) * kMmaStageDoubles * sizeof(double);
  auto kernel = formation_mma_kernel<kVec>;
  static SharedGrant grant;
  const cudaError_t err =
      grant_shared(reinterpret_cast<const void*>(kernel), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ntile * (ntile + 1) / 2, nb, used);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      A + static_cast<size_t>(b0) * m * n, w + static_cast<size_t>(b0) * m,
      partial, m, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The second pass of the split route: K[i,j] = (P_0 + P_1 + ... + P_{S-1})
// [i,j] + Q[i,j] (+ sigma on the diagonal) for j >= i, and its mirror with
// Q[j,i]: the chunks' partial sums added in the order of the chunks, so
// the result does not depend on the order in which the blocks ran.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
formation_sum_kernel(const T* __restrict__ partial, const T* __restrict__ Q,
                     const T* __restrict__ sigma, T* __restrict__ K, int n,
                     int splits) {
  const int b = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t e = static_cast<size_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (e >= nn) return;
  const int i = static_cast<int>(e / n);
  const int j = static_cast<int>(e - static_cast<size_t>(i) * n);
  if (j < i) return;
  const T* p = partial + static_cast<size_t>(b) * splits * nn + e;
  T acc = p[0];
  for (int s = 1; s < splits; ++s) acc += p[s * nn];
  const T* Qb = Q + b * nn;
  T* Kb = K + b * nn;
  T v = acc + Qb[e];
  if (i == j) v += sigma[b];
  Kb[e] = v;
  if (j > i) {
    const size_t t = static_cast<size_t>(j) * n + i;
    Kb[t] = acc + Qb[t];
  }
}

// Rows of A a chunk of the split route walks: ceil(m / splits) rounded up
// to whole stages, so that every chunk but the last is a whole number of
// stages; the number of chunks that then hold rows is returned in *used.
inline int chunk_rows(int m, int splits, int* used) {
  if (splits <= 1 || m <= 0) {
    *used = 1;
    return m;
  }
  int chunk = (m + splits - 1) / splits;
  chunk = (chunk + kStageRows - 1) / kStageRows * kStageRows;
  *used = (m + chunk - 1) / chunk;
  return chunk;
}

template <typename T, int kTile, bool kVec>
int launch_tiles(const T* A, const T* w, const T* Q, const T* sigma, T* K,
                 T* partial, int B, int m, int n, int splits,
                 cudaStream_t stream) {
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
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  int used = 1;
  const int chunk = chunk_rows(m, splits, &used);
  if (used > kMaxGridY || (used > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // float64 splits of 128-wide tiles run on the tensor cores
  constexpr bool kMma = sizeof(T) == 8 && kTile == kMmaTile;
  auto unsplit = formation_kernel<T, kTile, kVec, false>;
  static SharedGrant grant;              // one per kernel instance
  const cudaError_t err =
      grant_shared(reinterpret_cast<const void*>(unsplit), bytes, grant);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t nn = static_cast<size_t>(n) * n;
  const dim3 block(threads);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const T* Ab = A + static_cast<size_t>(b0) * m * n;
    const T* wb = w + static_cast<size_t>(b0) * m;
    const T* Qb = Q + static_cast<size_t>(b0) * nn;
    T* Kb = K + static_cast<size_t>(b0) * nn;
    if (used == 1) {
      const dim3 grid(pairs, nb);
      unsplit<<<grid, block, bytes, stream>>>(Ab, wb, Qb, sigma + b0, Kb,
                                              nullptr, m, n, strips, m);
      continue;
    }
    T* Pb = partial + static_cast<size_t>(b0) * used * nn;
    if constexpr (kMma) {
      const int e = launch_split_mma<kVec>(A, w, Pb, b0, nb, m, n, used, chunk,
                                           stream);
      if (e != 0) return e;
    } else {
      auto split = formation_kernel<T, kTile, kVec, true>;
      static SharedGrant split_grant;
      const cudaError_t e =
          grant_shared(reinterpret_cast<const void*>(split), bytes, split_grant);
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid(pairs, nb, used);
      split<<<grid, block, bytes, stream>>>(Ab, wb, Qb, sigma + b0, Kb, Pb, m,
                                            n, strips, chunk);
    }
    const dim3 sum_grid(static_cast<unsigned>((nn + kSumThreads - 1) / kSumThreads), nb);
    formation_sum_kernel<T><<<sum_grid, kSumThreads, 0, stream>>>(
        Pb, Qb, sigma + b0, Kb, n, used);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_aligned(const T* A, const T* w, const T* Q, const T* sigma, T* K,
                   T* partial, int B, int m, int n, int splits,
                   cudaStream_t stream) {
  // the tile edge follows n: the shared stages are kTile wide
#define QPDO_CALL(TILE) \
  launch_tiles<T, TILE, kVec>(A, w, Q, sigma, K, partial, B, m, n, splits, stream)
  if (n <= 32) return QPDO_CALL(32);
  if (n <= 64) return QPDO_CALL(64);
  return QPDO_CALL(128);
#undef QPDO_CALL
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <typename T>
int launch_formation(const T* A, const T* w, const T* Q, const T* sigma,
                     T* K, T* partial, int B, int m, int n, int splits,
                     cudaStream_t stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  // 16-byte copies need rows of A, Q and K that start on 16 bytes
  const bool vec = (n * sizeof(T)) % 16 == 0 && aligned16(A) && aligned16(Q) &&
                   aligned16(K);
  return vec ? launch_aligned<T, true>(A, w, Q, sigma, K, partial, B, m, n,
                                       splits, stream)
             : launch_aligned<T, false>(A, w, Q, sigma, K, partial, B, m, n,
                                        splits, stream);
}

}  // namespace

// partial: (B, S, n, n) of the input type, S = splits, read only where
// the rows are split (splits > 1 and m above one stage); may be null
// otherwise.  splits = 1 is the unsplit kernel.
extern "C" int qpdo_formation_f32(const void* A, const void* w, const void* Q,
                                  const void* sigma, void* K, void* partial,
                                  int B, int m, int n, int splits,
                                  void* stream) {
  return launch_formation(static_cast<const float*>(A),
                          static_cast<const float*>(w),
                          static_cast<const float*>(Q),
                          static_cast<const float*>(sigma),
                          static_cast<float*>(K), static_cast<float*>(partial),
                          B, m, n, splits, static_cast<cudaStream_t>(stream));
}

extern "C" int qpdo_formation_f64(const void* A, const void* w, const void* Q,
                                  const void* sigma, void* K, void* partial,
                                  int B, int m, int n, int splits,
                                  void* stream) {
  return launch_formation(static_cast<const double*>(A),
                          static_cast<const double*>(w),
                          static_cast<const double*>(Q),
                          static_cast<const double*>(sigma),
                          static_cast<double*>(K), static_cast<double*>(partial),
                          B, m, n, splits, static_cast<cudaStream_t>(stream));
}

#ifdef QPDO_PHASE_CLOCKS
extern "C" int qpdo_formation_phase_clocks(long long* out) {
  return read_phase_clocks(out);
}
#endif

extern "C" const char* qpdo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
