// The TF32 tensor cores of sm_90a, for the trailing update of
// csrc/kkt_solve_cluster.cu (three TF32 passes with float32 sums):
//  * whether the fragment layouts of mma.sync m16n8k8 .tf32 that
//    csrc/tf32x3.cuh assumes hold (a product of values exact in TF32
//    against a plain loop: max err 0 when they do), whether
//    cvt.rna.tf32.f32 rounds to nearest, ties away from zero, on the 13
//    dropped bits (against a host model, over 65,536 bit patterns), how the
//    card sums a fragment product (against the order of the CPU stand-in,
//    csrc/tf32x3.cuh under QPDO_CUDA_STUB: the accumulator, then the 8
//    products in k order, each sum rounded), and the error of one and of
//    three passes on random operands against a float64 product;
//  * one SM's rate (one block, clock64) of mma.sync m16n8k8 .tf32 at 1, 4
//    and 8 warps (8 independent accumulators a warp), of wgmma.mma_async
//    m64n64k8 and m64n128k8 .tf32 at 1 and 2 warpgroups, in multiply-adds
//    a cycle, and of the split x -> (hi, lo) (cvt.rna, a subtract, a second
//    cvt.rna; or the same rounding by two integer instructions each) in
//    values a cycle; the whole card's mma.sync rate in TFLOP/s;
//  * the latency of a warp shuffle, of rsqrtf and of an FMA in a dependent
//    chain (the pivot chain of the factor's diagonal block), with warp 0
//    alone and with 7 other warps issuing mma.sync beside it.
// Build and run on a card with the CUDA toolkit:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/mma_tf32_probe \
//       scripts/mma_tf32_probe.cu && build/mma_tf32_probe
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// a shared-memory matrix descriptor without swizzle: 8-row core matrices of
// 16 bytes, the next one along K 128 bytes on, along M or N 256 bytes on
__device__ uint64_t descriptor(const void* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ float hashf(unsigned i) {        // in [-1, 1)
  i = i * 2654435761u + 0x9e3779b9u;
  i ^= i >> 15; i *= 2246822519u; i ^= i >> 13; i *= 3266489917u; i ^= i >> 16;
  return static_cast<float>(i >> 8) * (2.0f / 16777216.0f) - 1.0f;
}

// fragments of m16n8k8: A[gid + 8 (q & 1)][tig + 4 (q >> 1)] in a[q],
// B[tig + 4 q][gid] in b[q], D[gid + 8 (c >> 1)][2 tig + (c & 1)] in d[c]
__device__ float Aexact(int i, int k) { return 0.5f * ((i * 3 + k * 5) % 11 - 5); }
__device__ float Bexact(int k, int j) { return 0.25f * ((k * 7 + j * 3) % 13 - 6); }

__global__ void layout_check(float* out) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  uint32_t a[4], b[2];
  float d[4] = {0.5f, -0.25f, 1.0f, 2.0f};
  for (int q = 0; q < 4; ++q) a[q] = tf32_rna(Aexact(gid + 8 * (q & 1), tig + 4 * (q >> 1)));
  for (int q = 0; q < 2; ++q) b[q] = tf32_rna(Bexact(tig + 4 * q, gid));
  const float c0[4] = {d[0], d[1], d[2], d[3]};
  mma_tf32(d, a, b);
  float err = 0.0f;
  for (int c = 0; c < 4; ++c) {
    const int i = gid + 8 * (c >> 1), j = 2 * tig + (c & 1);
    float ref = c0[c];
    for (int k = 0; k < 8; ++k) ref += Aexact(i, k) * Bexact(k, j);
    err = fmaxf(err, fabsf(d[c] - ref));
  }
  out[lane] = err;
}

__global__ void rna_check(const uint32_t* in, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float x;
    memcpy(&x, &in[i], 4);
    out[i] = tf32_rna(x);
  }
}

// random operands: the card's fragment product against the stand-in's
// order (mismatching bits counted), and the errors of one and three passes
// against a float64 product, relative to max |A| |B| sums
__global__ void sum_order(float* out, int trials) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  __shared__ float A[16][8], Bm[8][8], C[16][8];
  float mism = 0.0f, e1 = 0.0f, e3 = 0.0f;
  for (int t = 0; t < trials; ++t) {
    for (int e = lane; e < 128; e += 32) {
      A[e / 8][e % 8] = hashf(t * 1000 + e);
      C[e / 8][e % 8] = hashf(t * 1000 + 500 + e);
    }
    for (int e = lane; e < 64; e += 32) Bm[e / 8][e % 8] = hashf(t * 1000 + 300 + e);
    __syncwarp();
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int q = 0; q < 4; ++q) {
      const float x = A[gid + 8 * (q & 1)][tig + 4 * (q >> 1)];
      ah[q] = tf32_rna(x);
      al[q] = tf32_rna(x - __uint_as_float(ah[q]));
    }
    for (int q = 0; q < 2; ++q) {
      const float x = Bm[tig + 4 * q][gid];
      bh[q] = tf32_rna(x);
      bl[q] = tf32_rna(x - __uint_as_float(bh[q]));
    }
    float one[4], three[4];
    for (int c = 0; c < 4; ++c) one[c] = three[c] = C[gid + 8 * (c >> 1)][2 * tig + (c & 1)];
    mma_tf32(one, ah, bh);
    // the stand-in's order of one pass: the accumulator, then k = 0..7
    for (int c = 0; c < 4; ++c) {
      const int i = gid + 8 * (c >> 1), j = 2 * tig + (c & 1);
      float s = C[i][j];
      for (int k = 0; k < 8; ++k)
        s = __fadd_rn(s, __fmul_rn(__uint_as_float(tf32_rna(A[i][k])),
                                   __uint_as_float(tf32_rna(Bm[k][j]))));
      mism += (s != one[c]) ? 1.0f : 0.0f;
    }
    mma_tf32(three, al, bh);
    mma_tf32(three, ah, bl);
    mma_tf32(three, ah, bh);
    for (int c = 0; c < 4; ++c) {
      const int i = gid + 8 * (c >> 1), j = 2 * tig + (c & 1);
      double ref = C[i][j], scale = fabs(C[i][j]);
      for (int k = 0; k < 8; ++k) {
        ref += static_cast<double>(A[i][k]) * Bm[k][j];
        scale += fabs(static_cast<double>(A[i][k]) * Bm[k][j]);
      }
      e1 = fmaxf(e1, static_cast<float>(fabs(one[c] - ref) / scale));
      e3 = fmaxf(e3, static_cast<float>(fabs(three[c] - ref) / scale));
    }
    __syncwarp();
  }
  out[3 * lane] = mism;
  out[3 * lane + 1] = e1;
  out[3 * lane + 2] = e3;
}

__global__ void mma_rate(float* out, long long* cycles, int iters) {
  uint32_t a[4], b[2];
  float d[8][4];
  for (int q = 0; q < 4; ++q) a[q] = tf32_rna(1.0f + threadIdx.x * 1e-3f + q);
  for (int q = 0; q < 2; ++q) b[q] = tf32_rna(0.5f + q * 1e-3f);
  for (int t = 0; t < 8; ++t)
    for (int c = 0; c < 4; ++c) d[t][c] = 0.0f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t) mma_tf32(d[t], a, b);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.0f;
  for (int t = 0; t < 8; ++t)
    for (int c = 0; c < 4; ++c) s += d[t][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}

template <int N>
__global__ void wgmma_rate(float* out, long long* cycles, int iters) {
  extern __shared__ __align__(128) float smem[];
  float* A = smem;                    // 64 x 8
  float* B = smem + 64 * 8;           // N x 8
  for (int e = threadIdx.x; e < 64 * 8 + N * 8; e += blockDim.x)
    smem[e] = __uint_as_float(tf32_rna(0.001f * (e % 17)));
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint64_t da = descriptor(A), db = descriptor(B);
  float d[N / 2];
  for (int c = 0; c < N / 2; ++c) d[c] = 0.0f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if constexpr (N == 64) wgmma_n64(d, da, db);
      else wgmma_n128(d, da, db);
    }
    wgmma_commit();
    wgmma_wait();
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.0f;
  for (int c = 0; c < N / 2; ++c) s += d[c];
  out[threadIdx.x] = s + wg;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// cvt.rna.tf32.f32's rounding by two integer instructions, a NaN kept (the
// canonical NaN 0x7fffffff would carry into the sign bit)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  const uint32_t r = (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
  return (x == x) ? r : __float_as_uint(x);
}

template <bool kBits>
__global__ void split_rate(float* out, long long* cycles, int iters) {
  float x[8];
  uint32_t acc = 0;
  for (int t = 0; t < 8; ++t) x[t] = 1.0f + threadIdx.x * 1e-5f + t * 1e-3f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint32_t hi = kBits ? tf32_bits(x[t]) : tf32_rna(x[t]);
      const float rest = x[t] - __uint_as_float(hi);
      const uint32_t lo = kBits ? tf32_bits(rest) : tf32_rna(rest);
      acc += hi ^ lo;
      x[t] += 1.1920929e-7f;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  out[threadIdx.x] = static_cast<float>(acc) + x[0];
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

// warp 0: a dependent chain of 256 steps of one kind (0: shuffle, 1:
// rsqrtf, 2: FMA); warps 1..: mma.sync while `busy`
template <int kKind>
__global__ void chain_latency(float* out, long long* cycles, int busy) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    float x = 1.0f + lane * 1e-3f;
    __syncwarp();
    const long long t0 = clock64();
#pragma unroll 16
    for (int s = 0; s < 256; ++s) {
      if constexpr (kKind == 0) x = __shfl_sync(0xffffffffu, x, (lane + 1) & 31);
      else if constexpr (kKind == 1) x = rsqrtf(x);
      else x = fmaf(x, 0.999f, 1e-3f);
    }
    const long long t1 = clock64();
    out[lane] = x;
    if (lane == 0) cycles[0] = t1 - t0;
  } else if (busy) {
    uint32_t a[4], b[2];
    float d[8][4] = {};
    for (int q = 0; q < 4; ++q) a[q] = tf32_rna(1.0f + q);
    for (int q = 0; q < 2; ++q) b[q] = tf32_rna(0.5f + q);
    for (int it = 0; it < 64; ++it) {
#pragma unroll
      for (int t = 0; t < 8; ++t) mma_tf32(d[t], a, b);
    }
    float s = 0.0f;
    for (int t = 0; t < 8; ++t) s += d[t][0];
    out[threadIdx.x] = s;
  }
}

static uint32_t host_rna(uint32_t u) {
  if ((u & 0x7f800000u) == 0x7f800000u) return u;   // inf, NaN: not compared
  uint32_t keep = u & ~0x1fffu;
  if ((u & 0x1fffu) >= 0x1000u) keep += 0x2000u;    // ties away from zero
  return keep;
}

int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 1 << 24);
  cudaMalloc(&cyc, 64);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  int clock_khz = 0;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  printf("device %s, %d SMs, max SM clock %.0f MHz\n", prop.name,
         prop.multiProcessorCount, clock_khz / 1e3);
  float h[96];
  layout_check<<<1, 32>>>(out);
  cudaDeviceSynchronize();
  cudaMemcpy(h, out, 32 * sizeof(float), cudaMemcpyDeviceToHost);
  float e = 0.0f;
  for (int i = 0; i < 32; ++i) e = fmaxf(e, h[i]);
  printf("layout m16n8k8 tf32: max err %.3e (%s)\n", e,
         cudaGetErrorString(cudaGetLastError()));

  const int n = 1 << 16;
  uint32_t *din, *dout;
  cudaMalloc(&din, n * 4);
  cudaMalloc(&dout, n * 4);
  static uint32_t hin[1 << 16], hout[1 << 16];
  for (int i = 0; i < n; ++i) {
    // every pattern of the low 13 bits once at a few exponents and signs,
    // ties (0x1000) among them
    const uint32_t low = static_cast<uint32_t>(i) & 0x1fffu;
    const uint32_t high = static_cast<uint32_t>(i) >> 13;   // 0..7
    hin[i] = ((high & 4u) << 29) | ((120u + 3u * (high & 3u)) << 23) |
             (0x2a5u << 13) * (high & 1u) | low;
  }
  hin[0] = 0x3f7fffffu;   // rounds up into the next binade
  hin[1] = 0xbf7ff000u;   // a tie, negative
  cudaMemcpy(din, hin, n * 4, cudaMemcpyHostToDevice);
  rna_check<<<n / 256, 256>>>(din, dout, n);
  cudaMemcpy(hout, dout, n * 4, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < n; ++i) bad += hout[i] != host_rna(hin[i]);
  printf("cvt.rna.tf32.f32 against round to nearest, ties away: %d of %d "
         "differ (%s)\n", bad, n, cudaGetErrorString(cudaGetLastError()));

  const int trials = 256;
  sum_order<<<1, 32>>>(out, trials);
  cudaDeviceSynchronize();
  cudaMemcpy(h, out, 96 * sizeof(float), cudaMemcpyDeviceToHost);
  float mism = 0.0f, e1 = 0.0f, e3 = 0.0f;
  for (int i = 0; i < 32; ++i) {
    mism += h[3 * i];
    e1 = fmaxf(e1, h[3 * i + 1]);
    e3 = fmaxf(e3, h[3 * i + 2]);
  }
  printf("fragment sums: %.0f of %d outputs differ from the stand-in's order "
         "(accumulator, then k = 0..7, each rounded); error against float64, "
         "relative to the sum of |terms|: one pass %.3e, three passes %.3e "
         "(%s)\n", mism, 128 * trials, e1, e3,
         cudaGetErrorString(cudaGetLastError()));

  const int iters = 4096;
  long long c = 0;
  for (int warps : {1, 4, 8}) {
    for (int rep = 0; rep < 2; ++rep) mma_rate<<<1, 32 * warps>>>(out, cyc, iters);
    cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
    const double fma = 1024.0 * 8 * iters * warps;
    printf("mma.sync m16n8k8 tf32, one SM, %d warps: %lld cycles, %.1f "
           "multiply-adds a cycle (three passes: %.1f) (%s)\n", warps, c,
           fma / c, fma / c / 3, cudaGetErrorString(cudaGetLastError()));
  }
  {
    const int blocks = prop.multiProcessorCount * 4;
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    mma_rate<<<blocks, 256>>>(out, cyc, iters);
    cudaEventRecord(e0);
    mma_rate<<<blocks, 256>>>(out, cyc, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double flops = 2.0 * 1024 * 8 * iters * (blocks * 8.0);
    printf("mma.sync m16n8k8 tf32, the whole card (%d blocks of 8 warps): "
           "%.3f ms, %.1f TFLOP/s (%s)\n", blocks, ms, flops / ms / 1e9,
           cudaGetErrorString(cudaGetLastError()));
  }
  const int witers = 1024;
  for (int N : {64, 128}) {
    for (int groups : {1, 2}) {
      const int bytes = (64 * 8 + N * 8) * 4;
      for (int rep = 0; rep < 2; ++rep) {
        if (N == 64) wgmma_rate<64><<<1, 128 * groups, bytes>>>(out, cyc, witers);
        else wgmma_rate<128><<<1, 128 * groups, bytes>>>(out, cyc, witers);
      }
      cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
      const double fma = 64.0 * N * 8 * 8 * witers * groups;
      printf("wgmma m64n%dk8 tf32, one SM, %d warpgroups: %lld cycles, %.1f "
             "multiply-adds a cycle (three passes: %.1f) (%s)\n", N, groups,
             c, fma / c, fma / c / 3, cudaGetErrorString(cudaGetLastError()));
    }
  }
  for (int bits = 0; bits < 2; ++bits) {
    for (int rep = 0; rep < 2; ++rep) {
      if (bits) split_rate<true><<<1, 256>>>(out, cyc, iters);
      else split_rate<false><<<1, 256>>>(out, cyc, iters);
    }
    cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
    printf("split x -> (hi, lo) by %s, one SM, 8 warps: %lld cycles, %.1f "
           "values a cycle (%s)\n", bits ? "integer rounding" : "cvt.rna", c,
           8.0 * iters * 256 / c, cudaGetErrorString(cudaGetLastError()));
  }
  const char* kinds[] = {"shuffle", "rsqrtf", "FMA"};
  for (int kind = 0; kind < 3; ++kind) {
    for (int busy = 0; busy < 2; ++busy) {
      for (int rep = 0; rep < 2; ++rep) {
        if (kind == 0) chain_latency<0><<<1, 256>>>(out, cyc, busy);
        if (kind == 1) chain_latency<1><<<1, 256>>>(out, cyc, busy);
        if (kind == 2) chain_latency<2><<<1, 256>>>(out, cyc, busy);
      }
      cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
      printf("chain of 256 %s, warp 0 %s: %.1f cycles a step (%s)\n",
             kinds[kind], busy ? "beside 7 warps of mma.sync" : "alone",
             c / 256.0, cudaGetErrorString(cudaGetLastError()));
    }
  }
  return 0;
}
