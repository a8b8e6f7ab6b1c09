// The cluster route of the two KKT kernels of kkt_solve.cu, float32, for a
// few problems of large n: one thread-block cluster a problem, K's upper
// triangle held in the cluster's distributed shared memory, the whole
// factor and both substitutions in one launch.
//
// kkt_solve_cluster computes what kkt_solve does (the contract at the top
// of kkt_solve.cu):
//
//     K    = Q + sigma*I + A' diag(w) A
//     dinv = 1/sqrt(diag K) where diag K > 0, else 1
//     Khat = dinv K dinv + 100*eps32*I
//     R    = chol(Khat)  (upper factor, pivot max(d, 1e-30), NaN kept)
//     R'z  = dinv * rhs;   R x = z;   dx = dinv * x
//
// and chol_solve_cluster what chol_solve does (K given, only its upper
// triangle read; the substitutions' divisors also clamped at 1e-30).
//
// Replaces, for a few problems of large n, the TPU kernels
// qpdo_tpu/ops/pallas_kkt.py: _kkt_kernel (l.40) and _stacked_chol_kernel
// (l.209), which keep K in VMEM (many megabytes); kkt_solve_large.cu is
// the route for many problems.
//
// What bounds it on the H100: at n = 1024 the factor is n^3/6 = 1.8e8
// multiply-adds (0.003 ms on the whole card), but n pivots depend on each
// other: the global route ran one problem a panel of 32 pivots at a time
// on one SM, with a launch between panels.  Here the trailing update, the
// bulk of the work, is spread over the blocks of a cluster, whose shared
// memory holds K (2.1 MB at n = 1024: 16 blocks of 227 KB), and the pivot
// steps stay inside one launch; what is left on the critical path is the
// busiest block's share of each trailing update, two cluster barriers and
// the strip a panel, and the back substitution's chain.  The update runs
// on the TF32 tensor cores in three passes (csrc/tf32x3.cuh): one SM's
// mma.sync m16n8k8 .tf32 gives 658 multiply-adds a cycle at 8 warps, 219
// in three passes against SIMT FP32's 128 (scripts/mma_tf32_probe.cu on an
// NVIDIA H100 80GB HBM3 at 700 W).  One pass (TF32 alone) would break the
// 2e-5 contract at n = 1024; three passes err like another float32 order
// of summation (PERF.md §6 gives the errors measured on the card at the
// shapes of chip_smoke.py's phase 6b).
//
// Design (kThreads = 256 a block, C = 8 or 16 blocks a cluster: the
// smaller that holds K; 2 and 4 are instantiated for the CPU emulation
// alone):
//  * n is padded to np = 32 P rows with identity rows (no row of a panel is
//    ragged); the right-hand side is column np of an augmented [K | b].
//    Panel p (rows 32p .. 32p+31, columns 32p .. np and the b column) lives
//    in the shared memory of block owner(p) as 32 rows of stride
//    np - 32p + 4; the panels go to the blocks back and forth (0, 1, ..,
//    C-1, C-1, .., 0, 0, ..), so every block holds about as much of the
//    triangle and does about as much of each trailing update.
//  * Load: every block computes dinv for all columns from K's diagonal
//    (kkt_solve_cluster: K formed by kernel 1, formation.cu, into the
//    workspace) and loads its panels, scaled and shifted, the strict lower
//    part of a diagonal block as 0 (the given K's lower triangle is never
//    read).
//  * A factored panel is published in a global buffer (L2), the one place
//    every block of the cluster reads it from: read from the owner's
//    shared memory by all the others, a panel asked ~1.5 MB a step of one
//    SM, and the route ran 1.41x slower (NVIDIA H100 80GB HBM3, 700 W,
//    the variant timing of scripts/time_kkt_global.py; PERF.md).
//  * Step k (panel k published, after a cluster barrier): each block
//    stages panel k's columns over its own panels' rows, negated, in the
//    order of mma.sync's A fragments (32 x 32 floats a panel: the row
//    operand of the update).  The update of a panel: a warp a column tile
//    of 8 at a time, the panel's 32 rows as two m16 tiles, the row operand
//    split into TF32 hi and lo once a warp and panel, the column operand
//    (panel k's columns, from L2) split as it is read, the next tile's
//    loads issued before this tile's products; the tile's update summed
//    from 0 in three passes over four k-steps of 8 and added to the panel
//    once in float32 (round to nearest: the tensor cores' own sums would
//    otherwise round the panel twelve times a step).  In the owner of
//    panel k+1, warp 0 applies panel k's update to that panel's diagonal
//    block (both operands the staged rows) and factors it in registers
//    (lane q column q; lane p's diagonal entry takes its own squares, so
//    the next pivot reaches the lanes in one shuffle a pivot, and row p of
//    R reaches them through shared memory off that chain; the pivot
//    scales and the reciprocal divisors of R'z = b kept aside) while
//    warps 1..7 apply the update to
//    the rest of that panel (also into the global buffer) and to the
//    block's other panels: the look-ahead.  Every other block applies the
//    update to its panels on all eight warps.  After a cluster barrier
//    the strip right of the new diagonal block, the b column (z) with it,
//    is solved by every block of the cluster, a range of columns a block
//    and a column a thread, in the global buffer; a second barrier
//    publishes it.
//  * R x = z, a panel at a time from the last: the owner's warp 0 solves
//    the 32x32 block with shuffles (each row's z less its sums over the
//    solved x kept in shared memory), writes its rows of dx and pushes its
//    32 x into every block's shared memory (distributed shared memory);
//    after a cluster barrier every block takes them out of the rests of
//    its earlier panels' rows (their columns loaded before the barrier).
// Each entry of K is written by one block alone, and its update of a step
// is summed in a fixed order (the tensor cores' within a fragment, the
// k-steps and passes in program order) and added once: two calls give the
// same bits.  The order is not the plain version's recurrence, so the
// result differs from it like another float32 order does (within 2e-5 of
// max|dx|).  A problem is one cluster, so a failed problem (NaN or
// non-positive pivots) stays in its own blocks.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "cluster.cuh"
#include "phase_clocks.cuh"
#include "shared_grant.cuh"
#include "tf32x3.cuh"

// kernel 1, formation.cu
extern "C" {
int qpdo_formation_f32(const void* A, const void* w, const void* Q,
                       const void* sigma, void* K, void* partial, int B, int m,
                       int n, int splits, void* stream);
}

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 32;            // rows of a panel
constexpr int kPad = 4;               // the b column and 3 of padding a row
constexpr int kMaxOwned = 4;          // panels a block may hold
constexpr int kRowsAWarp = 32 / kWarps;   // a panel's rows a warp sums
static_assert(kThreads == 8 * kPanel,
              "a thread a fragment slot of a staged row operand");
constexpr float kTiny = 1e-30f;
constexpr float kReg = 100.0f * 1.1920928955078125e-07f;   // 100 * eps32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRs = kPanel + 4;       // row stride of a diagonal block's copy
// programmatic dependent launch after kernel 1 (kkt_solve_cluster)
constexpr int kDependentLaunch = 1;

struct alignas(16) Float4 {
  float v[4];
};

__device__ __forceinline__ void wait_for_prior_grids() {
#ifndef QPDO_CUDA_STUB
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
}

// max(a, t) that keeps a NaN in a (jnp.maximum, torch.clamp)
__device__ __forceinline__ float nan_max(float a, float t) {
  return (a < t) ? t : a;
}

__device__ __forceinline__ float jacobi_scale(float d) {
  return (d > 0.0f) ? 1.0f / sqrtf(d) : 1.0f;
}

// a pivot's reciprocal square root, 1/sqrt(max(d, 1e-30)), NaN kept: the
// argument is a normal number (or NaN), so the card's MUFU.RSQ alone, which
// rsqrtf also gives it, without rsqrtf's scaling of subnormal arguments
// (two instructions on the pivot chain)
__device__ __forceinline__ float pivot_scale(float d) {
  const float x = nan_max(d, kTiny);
#ifdef QPDO_CUDA_STUB
  return rsqrtf(x);
#else
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
#endif
}

// Where the panels of a problem of n rows live in a cluster of C blocks.
template <int C>
struct Layout {
  int n, P, np;
  __host__ __device__ explicit Layout(int n_) : n(n_), P((n_ + kPanel - 1) / kPanel), np(kPanel * P) {}
  // a panel's row stride; its b column is at np - 32 p
  __host__ __device__ int stride(int p) const { return np - kPanel * p + kPad; }
  __host__ __device__ static int owner(int p) {
    const int m = p % (2 * C);
    return m < C ? m : 2 * C - 1 - m;
  }
  // the t-th panel of block r (increasing in t), its place among its
  // owner's panels
  __host__ __device__ static int panel_of(int r, int t) {
    return (t / 2) * 2 * C + ((t & 1) ? 2 * C - 1 - r : r);
  }
  __host__ __device__ static int slot(int p) {
    return 2 * (p / (2 * C)) + ((p % (2 * C)) >= C ? 1 : 0);
  }
  __host__ __device__ int owned(int r) const {
    int t = 0;
    while (panel_of(r, t) < P) ++t;
    return t;
  }
  // panel p's offset in its owner's shared memory (floats)
  __host__ __device__ int local_offset(int p) const {
    const int r = owner(p);
    int off = 0;
    for (int t = 0; t < slot(p); ++t) off += kPanel * stride(panel_of(r, t));
    return off;
  }
  // panel p's offset in a problem's global panel buffer (floats)
  __host__ __device__ size_t global_offset(int p) const {
    return static_cast<size_t>(kPanel) *
           (static_cast<size_t>(p) * (np + kPad) -
            static_cast<size_t>(kPanel) * p * (p - 1) / 2);
  }
  // panel p's pivot scales and reciprocal divisors (64 floats) in it
  __host__ __device__ size_t scales_offset(int p) const {
    return global_offset(P) + static_cast<size_t>(2 * kPanel) * p;
  }
  __host__ __device__ size_t global_floats() const { return scales_offset(P); }
  // the shared floats of every block: its panels (the most any block
  // holds), dinv, x, the staged row operands and back-substitution sums of
  // its panels, a diagonal block with its scales
  __host__ __device__ int panel_floats() const {
    int most = 0;
    for (int r = 0; r < C; ++r) {
      int f = 0;
      for (int t = 0; t < owned(r); ++t) f += kPanel * stride(panel_of(r, t));
      most = f > most ? f : most;
    }
    return most;
  }
  __host__ __device__ int most_owned() const {
    int most = 0;
    for (int r = 0; r < C; ++r) most = owned(r) > most ? owned(r) : most;
    return most;
  }
  __host__ __device__ size_t shared_floats() const {
    const int k = most_owned();
    return static_cast<size_t>(panel_floats()) + 2 * np +
           k * kPanel * kPanel + k * kPanel + kPanel * kRs + 2 * kPanel;
  }
};

// The row operand of panel k's update of one of the block's panels (rows
// 32p .. 32p + 31): A[i][q] = -R_k[q][32p + i], staged in the order of the
// A fragments of m16n8k8 (csrc/tf32x3.cuh), 1024 floats: fragment (mt,
// ks) of lane l at ((mt * 4 + ks) * 32 + l) * 4, its a[0..3] (rows 16 mt
// .., columns 8 ks ..); a warp loads a fragment as one Float4 and splits it
// into TF32 hi and lo itself.
constexpr int kStage = kPanel * kPanel;

// The A fragments of a staged row operand, split (hi, lo): [ks][mt].
struct RowOperand {
  float hi[4][2][4], lo[4][2][4];
};

__device__ __forceinline__ void load_row_operand(const float* stage,
                                                 RowOperand& A) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const Float4 v = *reinterpret_cast<const Float4*>(
          stage + ((mt * 4 + ks) * 32 + lane) * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(v.v[q], A.hi[ks][mt][q], A.lo[ks][mt][q]);
    }
}

// Panel k's rank-32 update of one of the block's panels (rows 32p.., stride
// S), column tiles of 8 tbegin .. tend - 1 (the last one ragged: the b
// column and 3 of padding), on wcount warps of the block, the caller the
// w-th of them: a warp a tile at a time, the panel's 32 rows as two m16
// tiles, P -= R_k[:, 32p + i]' R_k[:, 32p + c] in three TF32 passes with
// float32 sums over the four k-steps of 8, summed from 0 and added to the
// panel once; the panel read from and written back in float2 pairs and, where
// out is given, also written to the panel's place in the global buffer.
// A: the staged row operand, split; src: panel k's column 32p in the
// global buffer (row q at src + q Sk), the column operand, split as it is
// read, the next tile's loads issued before this tile's products.
__device__ __forceinline__ void update_panel(float* Pp, int S, int tbegin,
                                             int tend, const RowOperand& A,
                                             const float* src, int Sk,
                                             float* out, int w, int wcount) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float x[4][2];                     // the column operand of the next tile
  auto load = [&](int nt) {
    const int c = 8 * nt + gid;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        x[ks][h] = (c < S) ? __ldcg(src + (8 * ks + tig + 4 * h) * Sk + c) : 0.0f;
  };
  int nt = tbegin + w;
  if (nt < tend) load(nt);
  for (; nt < tend; nt += wcount) {
    float bhi[4][2], blo[4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) split_tf32(x[ks][h], bhi[ks][h], blo[ks][h]);
    if (nt + wcount < tend) load(nt + wcount);
    float upd[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_tf32x3(upd[mt], A.hi[ks][mt], A.lo[ks][mt], bhi[ks], blo[ks]);
    const int c = 8 * nt + 2 * tig;   // S - c is even: c + 1 < S too
    if (c < S) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 16 * mt + gid + 8 * h;
          float2 v = *reinterpret_cast<const float2*>(Pp + i * S + c);
          v.x += upd[mt][2 * h];
          v.y += upd[mt][2 * h + 1];
          *reinterpret_cast<float2*>(Pp + i * S + c) = v;
          if (out != nullptr) *reinterpret_cast<float2*>(out + i * S + c) = v;
        }
    }
  }
}

// Panel k's update of the 32x32 diagonal block of the block's panel at Pp
// (stride S) from its staged row operand alone, by one warp: its column
// operand is the same rows (B[q][c] = -A[c][q]), so tile (mt, nt) takes
// B's fragments from the A fragments of m-tile nt / 2, negated; the six
// tiles on and above the diagonal (the two below it are never read as
// values).
__device__ __forceinline__ void update_diagonal(float* Pp, int S,
                                                const float* stage) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 2 * mt; nt < 4; ++nt) {
      const int mb = nt >> 1, odd = nt & 1;
      float acc[4], upd[4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            Pp + (16 * mt + gid + 8 * h) * S + 8 * nt + 2 * tig);
        acc[2 * h] = v.x;
        acc[2 * h + 1] = v.y;
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const Float4 a = *reinterpret_cast<const Float4*>(
            stage + ((mt * 4 + ks) * 32 + lane) * 4);
        const float* o = stage + ((mb * 4 + ks) * 32 + lane) * 4 + odd;
        float ahi[4], alo[4], bhi[2], blo[2];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a.v[q], ahi[q], alo[q]);
        split_tf32(-o[0], bhi[0], blo[0]);
        split_tf32(-o[2], bhi[1], blo[1]);
        mma_tf32x3(upd, ahi, alo, bhi, blo);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Pp + (16 * mt + gid + 8 * h) * S + 8 * nt + 2 * tig) =
            make_float2(acc[2 * h] + upd[2 * h], acc[2 * h + 1] + upd[2 * h + 1]);
    }
}

// Warp 0: the 32x32 diagonal block of the panel at Pp (stride S) factored
// in place, lane q holding column q in registers; its rows also go to G
// (the panel's place in the global buffer) and the pivot scales rp and the
// reciprocal divisors 1/R[p][p] (clamped at 1e-30 for kClampDiv) of R'z = b
// to scales[0..31] and scales[32..63].  The pivot chain is lane p's own:
// its column's diagonal entry takes the updates R[q][p]^2 from its own
// registers, so the next pivot reaches the other lanes in one shuffle a
// pivot (the chain: the shuffle, the scale, a multiply and a fused
// multiply-add).  Row p of R reaches the lanes for the rest of the update
// through shared memory (rows: 32 rows of stride kRs, one a pivot, read as
// broadcast Float4 loads), off the chain.  Only the upper part of the block
// is meaningful (the rest is never read as a value).
template <bool kClampDiv>
__device__ __forceinline__ void factor_diagonal(float* Pp, int S, float* G,
                                                float* scales, float* rows) {
  const int lane = threadIdx.x & 31;
  float col[kPanel];                   // col[i]: row i of column lane
#pragma unroll
  for (int i = 0; i < kPanel; ++i) col[i] = Pp[i * S + lane];
  float dq = 0.0f, rpq = 0.0f;         // the pivot of row lane, its scale
  float d = __shfl_sync(kFull, col[0], 0);
#pragma unroll
  for (int p = 0; p < kPanel; ++p) {
    const float rp = pivot_scale(d);
    const float rq = col[p] * rp;      // R[p][lane], lane >= p
    col[p] = rq;
    dq = (lane == p) ? d : dq;
    rpq = (lane == p) ? rp : rpq;
    if (p + 1 < kPanel) {
      // lane p + 1's next pivot: its own entry less its own square, the
      // value the update below gives it
      d = __shfl_sync(kFull, fmaf(-rq, rq, col[p + 1]), p + 1);
      rows[p * kRs + lane] = rq;
      __syncwarp();
#pragma unroll
      for (int q4 = (p + 1) / 4; q4 < kPanel / 4; ++q4) {
        const Float4 v = *reinterpret_cast<const Float4*>(rows + p * kRs + 4 * q4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q4 + e > p) col[4 * q4 + e] = fmaf(-v.v[e], rq, col[4 * q4 + e]);
      }
    }
  }
  float diag = dq * rpq;
  if (kClampDiv) diag = nan_max(diag, kTiny);
  scales[lane] = rpq;
  scales[kPanel + lane] = 1.0f / diag;
#pragma unroll
  for (int p = 0; p < kPanel; ++p) {
    Pp[p * S + lane] = col[p];
    G[p * S + lane] = col[p];
  }
}

// One column c of a panel's strip right of its factored diagonal block,
// R[p][c] = (K[p][c] - sum_{q<p} R[q][p] R[q][c]) rp, in the global buffer
// G (stride S) in place; the b column (z of R'z = b) the same with the
// reciprocal divisors.  Rl: the diagonal block (stride kRs), then rp and
// the reciprocal divisors.
__device__ __forceinline__ void solve_column(float* G, int S, int c,
                                             const float* Rl,
                                             const float* mult) {
  float cell[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) cell[i] = __ldcg(G + i * S + c);
#pragma unroll
  for (int p = 0; p < kPanel; ++p) {
    const float x = cell[p] * mult[p];
    cell[p] = x;
#pragma unroll
    for (int q4 = p / 4; q4 < kPanel / 4; ++q4) {
      const Float4 v = *reinterpret_cast<const Float4*>(Rl + p * kRs + 4 * q4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q4 + e > p) cell[4 * q4 + e] -= v.v[e] * x;
    }
  }
#pragma unroll
  for (int i = 0; i < kPanel; ++i) G[i * S + c] = cell[i];
}

template <int C, bool kJacobi, bool kClampDiv>
__global__ void __launch_bounds__(kThreads, 1)
cluster_kernel(const float* K, const float* __restrict__ rhs,
               float* __restrict__ dx, float* gbuf, int n) {
  extern __shared__ __align__(16) float cluster_smem[];
  const Layout<C> L(n);
  const int P = L.P, np = L.np;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = static_cast<int>(cluster_rank());
  const int b = blockIdx.x / C;
  [[maybe_unused]] const bool clocked = blockIdx.x < C;   // problem 0's cluster
  const int nown = L.owned(r);
  const int most = L.most_owned();
  float* dinv = cluster_smem + L.panel_floats();
  float* xall = dinv + np;              // x of every row, as it is solved
  float* stage = xall + np;             // most x 32 x 32
  float* sums = stage + most * kPanel * kPanel;   // most x 32: R x = z's rests
  float* Rl = sums + most * kPanel;     // 32 x kRs, then 64 scales
  const float* Kb = K + static_cast<size_t>(b) * n * n;
  float* Gb = gbuf + static_cast<size_t>(b) * L.global_floats();
  auto panel = [&](int p) { return cluster_smem + L.local_offset(p); };
  auto gpanel = [&](int p) { return Gb + L.global_offset(p); };
  auto gscales = [&](int p) { return Gb + L.scales_offset(p); };

  // The strip of panel p, factored by its owner: its columns over every
  // thread of the cluster, a column a thread, from and into the global
  // buffer; between two cluster barriers.
  auto solve_strip = [&](int p) {
    const int S = L.stride(p);
    const int bcol = np - kPanel * p;
    float* G = gpanel(p);
    constexpr int kEach = (kPanel * kRs + 2 * kPanel + kThreads - 1) / kThreads;
    float v[kEach];
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      const int e = tid + j * kThreads;
      const int i = e / kRs, q = e - i * kRs;
      v[j] = (e >= kPanel * kRs + 2 * kPanel) ? 0.0f
             : (e >= kPanel * kRs) ? __ldcg(gscales(p) + e - kPanel * kRs)
             : (q >= i && q < kPanel) ? __ldcg(gpanel(p) + i * S + q) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kEach; ++j) {
      const int e = tid + j * kThreads;
      if (e < kPanel * kRs + 2 * kPanel) Rl[e] = v[j];
    }
    __syncthreads();
    // a contiguous range of columns a block
    const int each = (S - kPanel + C - 1) / C;
    const int end = kPanel + (r + 1) * each < S ? kPanel + (r + 1) * each : S;
    for (int c = kPanel + r * each + tid; c < end; c += kThreads) {
      if (c > bcol) {
        for (int i = 0; i < kPanel; ++i) G[i * S + c] = 0.0f;
      } else {
        solve_column(G, S, c, Rl, Rl + kPanel * kRs + (c == bcol ? kPanel : 0));
      }
    }
  };

  QPDO_SPAN_BEGIN();
  wait_for_prior_grids();
  for (int j = tid; j < np; j += kThreads)
    dinv[j] = (kJacobi && j < n) ? jacobi_scale(Kb[static_cast<size_t>(j) * (n + 1)]) : 1.0f;
  __syncthreads();
  // the block's panels: Khat (kkt) or K (chol) on and above the diagonal,
  // 0 below it, identity rows past n, the right-hand side in column np
  // (a thread a column of a panel, its 32 loads in flight at once)
  for (int t = 0; t < nown; ++t) {
    const int p = L.panel_of(r, t);
    float* Pp = panel(p);
    const int S = L.stride(p);
    const int i0 = kPanel * p;
    for (int c = tid; c < S; c += kThreads) {
      const int col = i0 + c;
      float v[kPanel];
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        const int row = i0 + i;
        v[i] = (col >= row && row < n && col < n)
                   ? Kb[static_cast<size_t>(row) * n + col]
                   : (col == np && row < n) ? rhs[static_cast<size_t>(b) * n + row]
                                            : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        const int row = i0 + i;
        float x = v[i];
        if (col < np) {
          if (col < row) {
            x = 0.0f;
          } else if (row < n && col < n) {
            if (kJacobi) {
              x = x * dinv[row] * dinv[col];
              if (row == col) x += kReg;
            }
          } else {
            x = (row == col) ? 1.0f : 0.0f;
          }
        } else if (col == np && row < n) {
          if (kJacobi) x *= dinv[row];
        }
        Pp[i * S + c] = x;
      }
    }
  }
  __syncthreads();
  QPDO_SPAN_IF(0, clocked && r == 0);  // load
  if (L.owner(0) == r) {
    float* Pp = panel(0);
    const int S = L.stride(0);
    if (warp == 0) {
      factor_diagonal<kClampDiv>(Pp, S, gpanel(0), gscales(0), Rl);
    } else {
      for (int i = 0; i < kPanel; ++i)
        for (int c = kPanel + tid - 32; c < S; c += kThreads - 32)
          gpanel(0)[i * S + c] = Pp[i * S + c];
    }
  }
  cluster_sync();
  solve_strip(0);
  cluster_sync();
  QPDO_SPAN_IF(1, clocked && r == 0);  // panel 0

  for (int k = 0; k + 1 < P; ++k) {
    const int Sk = L.stride(k);
    const float* Xk = gpanel(k);
    // the row operands of the block's panels below k, in fragment order
    // (a thread one fragment slot of each panel, its loads issued together)
    {
      const int mt = tid >> 7, ks = (tid >> 5) & 3;
      const int gid = lane >> 2, tig = lane & 3;
      for (int t = 0; t < nown; ++t) {
        const int p = L.panel_of(r, t);
        if (p <= k) continue;
        const float* src = Xk + kPanel * (p - k);
        Float4 v;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v.v[q] = -__ldcg(src + (8 * ks + tig + 4 * (q >> 1)) * Sk + 16 * mt + gid + 8 * (q & 1));
        *reinterpret_cast<Float4*>(stage + t * kStage + 4 * tid) = v;
      }
    }
    __syncthreads();
    QPDO_SPAN_STEP(2, clocked, k);          // staging
    const int next = k + 1;
    // panel k's update of the block's t-th panel, column tiles begin ..
    // (the b column's tile last), on count warps, this one the w-th
    auto update = [&](int t, int begin, float* out, int w, int count) {
      const int p = L.panel_of(r, t);
      RowOperand A;
      load_row_operand(stage + t * kStage, A);
      update_panel(panel(p), L.stride(p), begin, (np - kPanel * p) / 8 + 1, A,
                   Xk + kPanel * (p - k), Sk, out, w, count);
    };
    if (L.owner(next) == r) {
      // the look-ahead: warp 0 applies panel k's update to the next
      // panel's diagonal block (both of its operands are the staged rows)
      // and factors it while warps 1.. update the rest of the next panel
      // (into the global buffer too, for the strip) and the block's other
      // panels
      const int tn = L.slot(next);
      if (warp == 0) {
        update_diagonal(panel(next), L.stride(next), stage + tn * kStage);
        __syncwarp();
        QPDO_SPAN_STEP(11, clocked, k);     // the diagonal block's update
        factor_diagonal<kClampDiv>(panel(next), L.stride(next), gpanel(next),
                                   gscales(next), Rl);
        QPDO_SPAN_STEP(3, clocked, k);      // the diagonal block (warp 0)
      } else {
        update(tn, kPanel / 8, gpanel(next), warp - 1, kWarps - 1);
        for (int t = tn + 1; t < nown; ++t)
          update(t, 0, nullptr, warp - 1, kWarps - 1);
        QPDO_SPAN_STEP_BY(14, clocked, k, 32);   // the owner's update (warp 1)
      }
    } else {
      for (int t = 0; t < nown; ++t)
        if (L.panel_of(r, t) > k) update(t, 0, nullptr, warp, kWarps);
      QPDO_SPAN_STEP(4, clocked, k);        // the other blocks' update
    }
    cluster_sync();
    QPDO_SPAN_STEP(5, clocked, k);          // the first barrier of the step
    solve_strip(next);
    QPDO_SPAN_STEP(6, clocked, k);          // the strip
    cluster_sync();
    QPDO_SPAN_STEP(7, clocked, k);          // the second barrier of the step
  }

  // R x = z, a panel at a time from the last.  rest holds z less the sums
  // of the solved x over each row of the block's panels; the owner of a
  // panel pushes its x into every block's xall (distributed shared
  // memory) before the barrier that ends the panel.
  for (int t = 0; t < nown; ++t) {
    const int p = L.panel_of(r, t);
    if (tid < kPanel)
      sums[t * kPanel + tid] = __ldcg(gpanel(p) + tid * L.stride(p) + np - kPanel * p);
  }
  __syncthreads();
  for (int k = P - 1; k >= 0; --k) {
    const int o = L.owner(k);
    if (o == r && warp == 0) {
      const float* Pp = panel(k);
      const int S = L.stride(k);
      float row[kPanel];               // R[lane][p], p > lane
#pragma unroll
      for (int p = 0; p < kPanel; ++p) row[p] = (p > lane) ? Pp[lane * S + p] : 0.0f;
      float diag = Pp[lane * S + lane];
      if (kClampDiv) diag = nan_max(diag, kTiny);
      const float inv = 1.0f / diag;
      float acc = sums[L.slot(k) * kPanel + lane];
      float xq = acc * inv;
      QPDO_SPAN_STEP(12, clocked, k);       // the triangle's operands
#pragma unroll
      for (int p = kPanel - 1; p >= 0; --p) {
        const float xp = __shfl_sync(kFull, acc * inv, p);
        if (lane < p) acc -= row[p] * xp;
        if (lane == p) xq = xp;
      }
      // the chain (the test on xq keeps the mark after it)
      QPDO_SPAN_STEP(13, clocked && xq != 1.2345f, k);
      for (int q = 0; q < C; ++q)
        cluster_map(xall, static_cast<unsigned>(q))[kPanel * k + lane] = xq;
      const int i = kPanel * k + lane;
      if (i < n) dx[static_cast<size_t>(b) * n + i] = kJacobi ? xq * dinv[i] : xq;
    }
    // the block's earlier panels' columns over panel k, loaded before the
    // barrier: a warp kRowsAWarp rows, a lane a column
    float tile[kMaxOwned][kRowsAWarp];
#pragma unroll
    for (int t = 0; t < kMaxOwned; ++t) {
      const int p = L.panel_of(r, t);
      const bool mine = t < nown && p < k;
#pragma unroll
      for (int j = 0; j < kRowsAWarp; ++j)
        tile[t][j] = mine ? __ldcg(gpanel(p) + (warp + kWarps * j) * L.stride(p) +
                                   kPanel * (k - p) + lane)
                          : 0.0f;
    }
    QPDO_SPAN_STEP(8, clocked, k);          // the triangle's solve
    cluster_sync();
    QPDO_SPAN_STEP(9, clocked, k);          // the back substitution's barriers
    if (k == 0) break;
    // x of panel k times those columns out of the rows' rests, a fixed
    // reduction tree
    const float xk = xall[kPanel * k + lane];
#pragma unroll
    for (int t = 0; t < kMaxOwned; ++t) {
      if (t < nown && L.panel_of(r, t) < k) {
#pragma unroll
        for (int j = 0; j < kRowsAWarp; ++j) {
          float s = tile[t][j] * xk;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
          if (lane == 0) sums[t * kPanel + warp + kWarps * j] -= s;
        }
      }
    }
    __syncthreads();
    QPDO_SPAN_STEP(10, clocked, k);         // the sums
  }
}

int device_index() {
  int device = 0;
  return cudaGetDevice(&device) == cudaSuccess ? device : -1;
}

// Once per kernel instance and device: the dynamic shared memory grant and,
// for clusters above 8 blocks, the non-portable cluster size.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, int C, SharedGrant& grant,
                    std::mutex& lock, bool* nonportable) {
  cudaError_t err = grant_shared(reinterpret_cast<const void*>(kernel), bytes, grant);
  if (err != cudaSuccess || C <= 8) return err;
  const int device = device_index();
  if (device < 0) return cudaGetLastError();
  const std::lock_guard<std::mutex> hold(lock);
  if (device < kGrantDevices && nonportable[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device < kGrantDevices) nonportable[device] = true;
  return err;
}

template <int C, bool kJacobi, bool kClampDiv>
cudaError_t configure(int B, int n, cudaStream_t stream, bool dependent,
                      cudaLaunchConfig_t& config, cudaLaunchAttribute* attrs) {
  const Layout<C> L(n);
  const size_t bytes = L.shared_floats() * sizeof(float);
  if (bytes > kMaxSharedBytes || L.most_owned() > kMaxOwned)
    return cudaErrorInvalidValue;
  static SharedGrant grant;
  static std::mutex lock;
  static bool nonportable[kGrantDevices] = {};
  const cudaError_t err = prepare(cluster_kernel<C, kJacobi, kClampDiv>, bytes,
                                  C, grant, lock, nonportable);
  if (err != cudaSuccess) return err;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = kDependentLaunch;
  config = cudaLaunchConfig_t{};
  config.gridDim = dim3(C * B);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = dependent ? 2 : 1;
  return cudaSuccess;
}

template <int C, bool kJacobi, bool kClampDiv>
cudaError_t launch_cluster(const float* K, const float* rhs, float* dx,
                           float* gbuf, int B, int n, cudaStream_t stream,
                           bool dependent) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[2] = {};
  cudaError_t err = configure<C, kJacobi, kClampDiv>(B, n, stream, dependent,
                                                     config, attrs);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, cluster_kernel<C, kJacobi, kClampDiv>, K,
                           rhs, dx, gbuf, n);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int C>
int shared_bytes(int n) {
  const Layout<C> L(n);
  if (L.most_owned() > kMaxOwned) return -1;
  return static_cast<int>(L.shared_floats() * sizeof(float));
}

// 8 blocks where K fits them, else 16 (a non-portable cluster size), else 0
int cluster_size(int n) {
  if (n <= 0) return 0;
  auto fits = [](int bytes) {
    return bytes > 0 && static_cast<size_t>(bytes) <= kMaxSharedBytes;
  };
  if (fits(shared_bytes<8>(n))) return 8;
  if (fits(shared_bytes<16>(n))) return 16;
  return 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// gbuf: the panel buffers, read and written in pairs of floats
// (update_panel), so 16-byte aligned or refused
template <bool kJacobi, bool kClampDiv>
cudaError_t dispatch(int C, const float* K, const float* rhs, float* dx,
                     float* gbuf, int B, int n, cudaStream_t stream,
                     bool dependent) {
  if (!aligned(gbuf)) return cudaErrorInvalidValue;
  switch (C) {
#ifdef QPDO_CUDA_STUB
    // clusters of 2 and 4 blocks reach every branch of the emulation at
    // small n; the card takes 8 or 16 (cluster_size), and is spared their
    // compilation
    case 2: return launch_cluster<2, kJacobi, kClampDiv>(K, rhs, dx, gbuf, B, n, stream, dependent);
    case 4: return launch_cluster<4, kJacobi, kClampDiv>(K, rhs, dx, gbuf, B, n, stream, dependent);
#endif
    case 8: return launch_cluster<8, kJacobi, kClampDiv>(K, rhs, dx, gbuf, B, n, stream, dependent);
    case 16: return launch_cluster<16, kJacobi, kClampDiv>(K, rhs, dx, gbuf, B, n, stream, dependent);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
int max_active(int n) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attrs[2] = {};
  cudaError_t err = configure<C, true, false>(1, n, nullptr, false, config, attrs);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, cluster_kernel<C, true, false>, &config);
  return err != cudaSuccess ? -static_cast<int>(err) : count;
}

// K's share of kkt_solve_cluster's workspace, rounded up to 4 floats so
// that the panel buffer after it keeps the workspace's 16-byte alignment
// whatever B and n.
size_t formed_floats(int B, int n) {
  return (static_cast<size_t>(B) * n * n + 3) / 4 * 4;
}

}  // namespace

// The floats of the workspace of B problems of n: kkt_solve_cluster's
// (formed != 0: K, (B, n, n), rounded up to 4 floats, then every
// problem's panel buffer) or chol_solve_cluster's (the panel buffers).
extern "C" long long qpdo_cluster_work_floats(int B, int n, int formed) {
  const size_t panels = static_cast<size_t>(B) * Layout<1>(n).global_floats();
  return static_cast<long long>((formed ? formed_floats(B, n) : 0) + panels);
}

// The blocks of a cluster for n (8 or 16), 0 where K does not fit 16.
extern "C" int qpdo_kkt_cluster_size(int n) { return cluster_size(n); }

// How many clusters of the size for n the current device holds at once
// (kkt_solve_cluster's kernel; chol_solve_cluster's has the same shared
// memory); a negative CUDA error where the query fails, 0 where n has no
// cluster.
extern "C" int qpdo_kkt_cluster_max_active(int n) {
  switch (cluster_size(n)) {
    case 8: return max_active<8>(n);
    case 16: return max_active<16>(n);
    default: return 0;
  }
}

// work: qpdo_cluster_work_floats(B, n, 1) floats, 16-byte aligned; partial:
// kernel 1's partial sums, (B, S, n, n) floats for splits S > 1, else null;
// cluster: the blocks of a cluster (0: qpdo_kkt_cluster_size(n); 2 and 4
// only in the CPU emulation).
extern "C" int qpdo_kkt_solve_cluster_f32(const void* Q, const void* A,
                                          const void* w, const void* sigma,
                                          const void* rhs, void* dx, void* work,
                                          void* partial, int B, int m, int n,
                                          int splits, int cluster,
                                          void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (!aligned(work)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = cluster > 0 ? cluster : cluster_size(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = qpdo_formation_f32(A, w, Q, sigma, work, partial, B, m, n, splits, stream);
  if (err != 0) return err;
  float* K = static_cast<float*>(work);
  return static_cast<int>(dispatch<true, false>(
      C, K, static_cast<const float*>(rhs), static_cast<float*>(dx),
      K + formed_floats(B, n), B, n, st, true));
}

// work: qpdo_cluster_work_floats(B, n, 0) floats, 16-byte aligned.
extern "C" int qpdo_chol_solve_cluster_f32(const void* K, const void* rhs,
                                           void* dx, void* work, int B, int n,
                                           int cluster, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (!aligned(work)) return static_cast<int>(cudaErrorInvalidValue);
  const int C = cluster > 0 ? cluster : cluster_size(n);
  return static_cast<int>(dispatch<false, true>(
      C, static_cast<const float*>(K), static_cast<const float*>(rhs),
      static_cast<float*>(dx), static_cast<float*>(work), B, n,
      static_cast<cudaStream_t>(stream), false));
}

#ifdef QPDO_PHASE_CLOCKS
extern "C" int qpdo_kkt_cluster_phase_clocks(long long* out) {
  return read_phase_clocks(out);
}

extern "C" int qpdo_kkt_cluster_phase_clocks_reset() {
  return reset_phase_clocks();
}

// the spans of each block of problem 0's cluster, step by step
// ([block][step][slot], kStepClockBlocks x kStepClockSteps x kPhaseClocks)
extern "C" int qpdo_kkt_cluster_block_phase_clocks(long long* out) {
  return read_step_clocks(out);
}
#endif
