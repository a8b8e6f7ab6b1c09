// The float64 mma shapes of sm_90a: whether the fragment layouts that
// csrc/formation.cu assumes hold (each shape's product against a plain
// loop: max err 0 when they do), and each shape's throughput in TFLOP/s
// on a grid of 4 blocks of 8 warps an SM, 8 independent accumulators a
// warp.  Build and run on a card with the CUDA toolkit:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_f64_probe \
//       scripts/mma_f64_probe.cu && build/mma_f64_probe
#include <cstdio>
#include <cuda_runtime.h>

__device__ void mma884(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ void mma1684(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ void mma1688(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ void mma16816(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ double Aval(int i, int k) { return 1.0 + i * 0.5 + k * 0.03125 + (i * k % 7) * 0.25; }
__device__ double Bval(int k, int j) { return 2.0 - k * 0.125 + j * 0.0625 + (k * j % 5) * 0.5; }

// assumed layouts (tf32-style): A(M x K) row gid (+8 for odd a index), col tig (+4 per pair);
// B(K x N): row tig (+4 per index), col gid; C: row gid (+8 for c2,c3), col 2 tig + (i & 1)
template <int M, int K>
__global__ void layout_check(double* out) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  double a[8], b[4], d[4] = {0, 0, 0, 0};
  if (M == 8) {
    a[0] = Aval(gid, tig); b[0] = Bval(tig, gid);
    mma884(d, a, b);
  } else {
    for (int q = 0; q < K / 2; ++q) {        // a index q: row gid + 8 (q & 1), col tig + 4 (q >> 1)
      a[q] = Aval(gid + 8 * (q & 1), tig + 4 * (q >> 1));
    }
    for (int q = 0; q < K / 4; ++q) b[q] = Bval(tig + 4 * q, gid);
    if (K == 4) mma1684(d, a, b);
    if (K == 8) mma1688(d, a, b);
    if (K == 16) mma16816(d, a, b);
  }
  double err = 0;
  for (int c = 0; c < (M == 8 ? 2 : 4); ++c) {
    const int i = gid + 8 * (c >> 1), j = 2 * tig + (c & 1);
    double ref = 0;
    for (int k = 0; k < K; ++k) ref += Aval(i, k) * Bval(k, j);
    err = fmax(err, fabs(d[c] - ref));
  }
  out[lane] = err;
}

template <int SHAPE>
__global__ void throughput(double* out, int iters) {
  double a[8], b[4], d[8][4];
  for (int q = 0; q < 8; ++q) a[q] = 1.0 + threadIdx.x * 1e-3 + q;
  for (int q = 0; q < 4; ++q) b[q] = 0.5 + q * 1e-3;
  for (int t = 0; t < 8; ++t) for (int c = 0; c < 4; ++c) d[t][c] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (SHAPE == 0) mma884(d[t], a, b);
      if (SHAPE == 1) mma1684(d[t], a, b);
      if (SHAPE == 2) mma1688(d[t], a, b);
      if (SHAPE == 3) mma16816(d[t], a, b);
    }
  }
  double s = 0;
  for (int t = 0; t < 8; ++t) for (int c = 0; c < 4; ++c) s += d[t][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  double* out;
  cudaMalloc(&out, 1 << 24);
  double h[32];
  auto report = [&](const char* name) {
    cudaMemcpy(h, out, 32 * sizeof(double), cudaMemcpyDeviceToHost);
    double e = 0; for (double v : h) e = v > e ? v : e;
    printf("layout %s: max err %.3e (%s)\n", name, e, cudaGetErrorString(cudaGetLastError()));
  };
  layout_check<8, 4><<<1, 32>>>(out); cudaDeviceSynchronize(); report("m8n8k4");
  layout_check<16, 4><<<1, 32>>>(out); cudaDeviceSynchronize(); report("m16n8k4");
  layout_check<16, 8><<<1, 32>>>(out); cudaDeviceSynchronize(); report("m16n8k8");
  layout_check<16, 16><<<1, 32>>>(out); cudaDeviceSynchronize(); report("m16n8k16");
  const int iters = 4096, blocks = 132 * 4, threads = 256;
  const double fma_per[] = {256, 512, 1024, 2048};
  const char* names[] = {"m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16"};
  for (int sh = 0; sh < 4; ++sh) {
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      if (sh == 0) throughput<0><<<blocks, threads>>>(out, iters);
      if (sh == 1) throughput<1><<<blocks, threads>>>(out, iters);
      if (sh == 2) throughput<2><<<blocks, threads>>>(out, iters);
      if (sh == 3) throughput<3><<<blocks, threads>>>(out, iters);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
    }
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    const double flops = 2.0 * fma_per[sh] * 8 * iters * (blocks * threads / 32.0);
    printf("throughput %s: %.3f ms, %.1f TFLOP/s (%s)\n", names[sh], ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
