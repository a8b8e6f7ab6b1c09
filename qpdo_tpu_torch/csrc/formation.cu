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
// What bounds it on the H100: at the bench shape (B=256, m=150, n=100) one
// call is 2*m*n^2*B = 0.77 GFLOP over 15 MB of A in float32 (31 MB in
// double), about 50 FLOP per byte: compute-bound on the SIMT FMA units
// (no tensor cores here), and the tiles are small (n=100).
//
// Design: one block per (32x32 tile of K, problem).  The block walks over
// the m rows of A in chunks of 32, staging the tile's 32 row-side columns
// and its 32 column-side columns of A in shared memory; the column side is
// multiplied by w as it is loaded (the product order of the TPU kernel,
// A[k,i] * (w[k] * A[k,j])), so w∘A never reaches device memory.  Each of
// the 256 threads accumulates 4 entries of K in registers, in the input
// type (float32 accumulation matches the TPU kernel's
// preferred_element_type=f32).  The epilogue adds Q and, on the diagonal,
// sigma.  Symmetry, wgmma and TMA are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;           // edge of the K tile of one block
constexpr int kChunk = 32;          // rows of A per shared-memory stage
constexpr int kRows = 8;            // thread rows: each thread owns 4 entries
constexpr int kPerThread = kTile / kRows;
constexpr int kMaxGridZ = 65535;

template <typename T>
__global__ void __launch_bounds__(kTile * kRows)
formation_kernel(const T* __restrict__ A, const T* __restrict__ w,
                 const T* __restrict__ Q, const T* __restrict__ sigma,
                 T* __restrict__ K, int m, int n) {
  __shared__ T a_row[kChunk][kTile + 1];   // A[k, i0 + i]
  __shared__ T a_col[kChunk][kTile + 1];   // w[k] * A[k, j0 + j]

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x;              // 0..31: column of K in the tile
  const int ty = threadIdx.y;              // 0..7: first row of K in the tile
  const T* Ab = A + static_cast<size_t>(b) * m * n;
  const T* wb = w + static_cast<size_t>(b) * m;

  T acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) acc[r] = T(0);

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    for (int kk = ty; kk < kChunk; kk += kRows) {
      const int k = k0 + kk;
      const int i = i0 + tx;
      const int j = j0 + tx;
      const T* Ak = Ab + static_cast<size_t>(k) * n;
      a_row[kk][tx] = (k < m && i < n) ? Ak[i] : T(0);
      a_col[kk][tx] = (k < m && j < n) ? wb[k] * Ak[j] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const T aw = a_col[kk][tx];
#pragma unroll
      for (int r = 0; r < kPerThread; ++r)
        acc[r] += a_row[kk][ty + kRows * r] * aw;
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= n) return;
  const size_t base = static_cast<size_t>(b) * n * n;
  const T sig = sigma[b];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = i0 + ty + kRows * r;
    if (i < n) {
      const size_t o = base + static_cast<size_t>(i) * n + j;
      T v = acc[r] + Q[o];
      if (i == j) v += sig;
      K[o] = v;
    }
  }
}

template <typename T>
int launch_formation(const T* A, const T* w, const T* Q, const T* sigma,
                     T* K, int B, int m, int n, cudaStream_t stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 block(kTile, kRows);
  for (int b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const int nb = B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ;
    const dim3 grid(tiles, tiles, nb);
    formation_kernel<T><<<grid, block, 0, stream>>>(
        A + static_cast<size_t>(b0) * m * n, w + static_cast<size_t>(b0) * m,
        Q + static_cast<size_t>(b0) * n * n, sigma + b0,
        K + static_cast<size_t>(b0) * n * n, m, n);
  }
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* qpdo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
