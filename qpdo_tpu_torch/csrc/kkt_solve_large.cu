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
// not bytes (K is written and read back once from L2 or HBM).  In
// practice the factor is n dependent pivot steps in one block per problem
// and its trailing updates go through L2: latency and L2 traffic, not the
// FMA rate, decide its time.  This route is meant to be right first.
//
// Design:
//  * K is formed by kernel 1 (formation.cu, float32, its rows split over
//    blocks where few problems have many rows) into the first B*n*n floats
//    of a workspace that the wrapper allocates; chol_solve_global copies
//    the upper triangle of the given K there.  The workspace's next 2*B*n
//    floats hold dinv and the right-hand side (b, then z, then x) of each
//    problem, so no size of n is refused for shared memory.
//  * Then one block of 256 threads per problem Jacobi-scales the upper
//    triangle in place, factors it by panels of kPanel = 32 rows of R and
//    runs both substitutions, all on K in global memory.  A panel:
//     - warp 0 loads the 32x32 diagonal block into shared memory, factors
//       it (a lane a column, one __syncwarp a step) and solves its part of
//       R'z = b with shuffles;
//     - every thread takes one column right of the block: the panel's 32
//       entries of R there, by a forward substitution against the block
//       (broadcast reads of shared memory, the column in registers), and
//       that column's update of b;
//     - the trailing matrix takes the panel's rank-32 update in 64x64
//       tiles (upper triangle only): the panel's strips over the tile's
//       rows and columns staged in shared memory, each thread a 4x4
//       micro-tile read from and written back to K.
//    Every entry of K takes its updates one pivot row at a time, in the
//    order of the plain version's unblocked recurrence.
//  * R x = z panel by panel from the last: each row's dot product with the
//    solved tail (a warp a row, a shuffle reduction), then warp 0 solves
//    the 32x32 block with shuffles.
// Every __syncthreads() is reached by all threads of the block; a failed
// problem (NaN or non-positive pivots) stays in its own block.

#include <cuda_runtime.h>

#include <cstddef>

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
constexpr int kTile = 64;             // edge of a trailing-update tile
constexpr int kMicro = 4;             // a thread's micro-tile is kMicro x kMicro
constexpr int kGrid = kTile / kMicro; // threads along a tile edge (16 x 16)
static_assert(kGrid * kGrid == kThreads, "one micro-tile a thread");
constexpr float kTiny = 1e-30f;
constexpr float kReg = 100.0f * 1.1920928955078125e-07f;   // 100 * eps32
// shared floats: the diagonal block, three panel vectors, two strips
constexpr size_t kSharedFloats = kPanel * kLd + 3 * kPanel + 2 * kPanel * kTile;

// max(a, t) that keeps a NaN in a (jnp.maximum, torch.clamp)
__device__ __forceinline__ float nan_max(float a, float t) {
  return (a < t) ? t : a;
}

__device__ __forceinline__ float jacobi_scale(float d) {
  return (d > 0.0f) ? 1.0f / sqrtf(d) : 1.0f;
}

// One block per problem b.  K: the workspace's matrices (B, n, n), of which
// the upper triangle is factored in place; vec: (B, 2, n), dinv and the
// right-hand side.  kJacobi: K holds the formed K (Jacobi-scale and shift
// it, scale rhs, unscale dx); else copy the upper triangle of Kin first.
template <bool kJacobi, bool kClampDiv>
__global__ void __launch_bounds__(kThreads)
factor_solve_global_kernel(const float* __restrict__ Kin,
                           const float* __restrict__ rhs,
                           float* __restrict__ dx, float* K, float* vec,
                           int n) {
  extern __shared__ __align__(16) float large_smem[];
  float* Ds = large_smem;              // kPanel x kLd: the diagonal block
  float* rs = Ds + kPanel * kLd;       // 1/sqrt(pivot) of the panel's rows
  float* zs = rs + kPanel;             // z of the panel's rows
  float* ss = zs + kPanel;             // the rows' dot products with x
  float* Xi = ss + kPanel;             // kPanel x kTile: strip over the tile's rows
  float* Xj = Xi + kPanel * kTile;     //   ... and over its columns

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  float* Kb = K + b * nn;
  float* dinv = vec + static_cast<size_t>(b) * 2 * n;
  float* v = dinv + n;                 // b, then z, then x
  const float* rb = rhs + static_cast<size_t>(b) * n;

  // ---- Khat = dinv K dinv + 100 eps32 I (upper triangle), or the given K ----
  if (kJacobi) {
    for (int i = tid; i < n; i += kThreads)
      dinv[i] = jacobi_scale(Kb[static_cast<size_t>(i) * n + i]);
    __syncthreads();
    for (int i = warp; i < n; i += kWarps) {
      float* row = Kb + static_cast<size_t>(i) * n;
      const float di = dinv[i];
      for (int j = i + lane; j < n; j += 32) {
        float x = row[j] * di * dinv[j];
        if (i == j) x += kReg;
        row[j] = x;
      }
    }
    for (int i = tid; i < n; i += kThreads) v[i] = rb[i] * dinv[i];
  } else {
    const float* Kg = Kin + b * nn;
    for (int i = warp; i < n; i += kWarps)
      for (int j = i + lane; j < n; j += 32)
        Kb[static_cast<size_t>(i) * n + j] = Kg[static_cast<size_t>(i) * n + j];
    for (int i = tid; i < n; i += kThreads) v[i] = rb[i];
  }
  __syncthreads();

  // ---- factor and R'z = b, a panel of kPanel rows at a time ----
  const int ty = tid / kGrid;
  const int tx = tid % kGrid;
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int pc = (n - k0 < kPanel) ? n - k0 : kPanel;
    const int t0 = k0 + pc;                    // first row past the panel
    float* Pk = Kb + static_cast<size_t>(k0) * n;   // the panel's first row

    // the diagonal block: lane q holds column q
    if (warp == 0) {
      for (int p = 0; p < pc; ++p)
        if (lane >= p && lane < pc)
          Ds[p * kLd + lane] = Pk[static_cast<size_t>(p) * n + k0 + lane];
      float zq = (lane < pc) ? v[k0 + lane] : 0.0f;
      __syncwarp();
      for (int p = 0; p < pc; ++p) {
        const float r = 1.0f / sqrtf(nan_max(Ds[p * kLd + p], kTiny));
        __syncwarp();
        if (lane >= p && lane < pc) Ds[p * kLd + lane] *= r;   // row p of R
        __syncwarp();
        if (lane < pc)
          for (int i = p + 1; i <= lane; ++i)
            Ds[i * kLd + lane] -= Ds[p * kLd + i] * Ds[p * kLd + lane];
        // z_p is final: every earlier row's update has reached lane p
        float diag = Ds[p * kLd + p];
        if (kClampDiv) diag = nan_max(diag, kTiny);
        const float zp = __shfl_sync(0xffffffffu, zq / diag, p);
        if (lane > p && lane < pc) zq -= zp * Ds[p * kLd + lane];
        if (lane == 0) {
          rs[p] = r;
          zs[p] = zp;
        }
        __syncwarp();
      }
      for (int p = 0; p < pc; ++p)
        if (lane >= p && lane < pc)
          Pk[static_cast<size_t>(p) * n + k0 + lane] = Ds[p * kLd + lane];
      if (lane < pc) v[k0 + lane] = zs[lane];
    }
    __syncthreads();

    // the panel's rows right of the block, a column a thread
    for (int j = t0 + tid; j < n; j += kThreads) {
      float x[kPanel];
      float vj = v[j];
#pragma unroll
      for (int p = 0; p < kPanel; ++p) {
        if (p < pc) {
          float a = Pk[static_cast<size_t>(p) * n + j];
#pragma unroll
          for (int q = 0; q < p; ++q) a -= Ds[q * kLd + p] * x[q];
          x[p] = a * rs[p];
          Pk[static_cast<size_t>(p) * n + j] = x[p];
          vj -= zs[p] * x[p];
        }
      }
      v[j] = vj;
    }
    __syncthreads();

    // the trailing matrix, upper triangle, in tile pairs (bi <= bj)
    const int nt = (n - t0 + kTile - 1) / kTile;
    const int pairs = nt * (nt + 1) / 2;
    for (int pair = 0; pair < pairs; ++pair) {
      int bi = 0, rest = pair;
      while (rest >= nt - bi) {
        rest -= nt - bi;
        ++bi;
      }
      const int i0 = t0 + bi * kTile;
      const int j0 = t0 + (bi + rest) * kTile;
      for (int e = tid; e < pc * kTile; e += kThreads) {
        const int p = e / kTile;
        const int c = e - p * kTile;
        const float* row = Pk + static_cast<size_t>(p) * n;
        Xi[e] = (i0 + c < n) ? row[i0 + c] : 0.0f;
        Xj[e] = (j0 + c < n) ? row[j0 + c] : 0.0f;
      }
      float acc[kMicro][kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int i = i0 + ty + kGrid * a;
          const int j = j0 + tx + kGrid * c;
          acc[a][c] = (i < n && j < n && j >= i) ? Kb[static_cast<size_t>(i) * n + j]
                                                 : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int p = 0; p < pc; ++p) {
        float xi[kMicro], xj[kMicro];
#pragma unroll
        for (int a = 0; a < kMicro; ++a) xi[a] = Xi[p * kTile + ty + kGrid * a];
#pragma unroll
        for (int c = 0; c < kMicro; ++c) xj[c] = Xj[p * kTile + tx + kGrid * c];
#pragma unroll
        for (int a = 0; a < kMicro; ++a)
#pragma unroll
          for (int c = 0; c < kMicro; ++c) acc[a][c] -= xi[a] * xj[c];
      }
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          const int i = i0 + ty + kGrid * a;
          const int j = j0 + tx + kGrid * c;
          if (i < n && j < n && j >= i) Kb[static_cast<size_t>(i) * n + j] = acc[a][c];
        }
      }
      __syncthreads();                 // the strips are free for the next pair
    }
  }

  // ---- R x = z, a panel at a time from the last ----
  for (int k0 = (n - 1) / kPanel * kPanel; k0 >= 0; k0 -= kPanel) {
    const int pc = (n - k0 < kPanel) ? n - k0 : kPanel;
    const int t0 = k0 + pc;
    const float* Pk = Kb + static_cast<size_t>(k0) * n;
    for (int p = warp; p < pc; p += kWarps) {
      const float* row = Pk + static_cast<size_t>(p) * n;
      float s = 0.0f;
      for (int k = t0 + lane; k < n; k += 32) s += row[k] * v[k];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ss[p] = s;
    }
    for (int e = tid; e < pc * kPanel; e += kThreads) {
      const int p = e / kPanel;
      const int q = e - p * kPanel;
      if (q >= p && q < pc) Ds[p * kLd + q] = Pk[static_cast<size_t>(p) * n + k0 + q];
    }
    __syncthreads();
    if (warp == 0) {
      float acc = (lane < pc) ? v[k0 + lane] - ss[lane] : 0.0f;
      for (int p = pc - 1; p >= 0; --p) {
        float diag = Ds[p * kLd + p];
        if (kClampDiv) diag = nan_max(diag, kTiny);
        const float xp = __shfl_sync(0xffffffffu, acc / diag, p);
        if (lane < p) acc -= Ds[lane * kLd + p] * xp;
        if (lane == p) v[k0 + p] = xp;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads)
    dx[static_cast<size_t>(b) * n + i] = kJacobi ? v[i] * dinv[i] : v[i];
}

template <bool kJacobi, bool kClampDiv>
int launch_factor(const float* Kin, const float* rhs, float* dx, float* work,
                  int B, int n, cudaStream_t stream) {
  float* K = work;
  float* vec = work + static_cast<size_t>(B) * n * n;
  const size_t bytes = kSharedFloats * sizeof(float);   // under 48 KB: no grant
  factor_solve_global_kernel<kJacobi, kClampDiv><<<B, kThreads, bytes, stream>>>(
      Kin, rhs, dx, K, vec, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: B*n*n + 2*B*n floats; partial: kernel 1's partial sums, (B, S, n, n)
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
  return launch_factor<true, false>(nullptr, static_cast<const float*>(rhs),
                                    static_cast<float*>(dx),
                                    static_cast<float*>(work), B, n,
                                    static_cast<cudaStream_t>(stream));
}

// work: B*n*n + 2*B*n floats.
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
