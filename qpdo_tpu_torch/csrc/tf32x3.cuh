// Float32 products on the TF32 tensor cores of sm_90a in three passes
// (csrc/kkt_solve_cluster.cu's trailing update).
//
// Each float32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// tf32 being cvt.rna.tf32.f32: round to nearest, ties away from zero, on
// the 13 low bits of the significand, which leaves 11 significant bits.
// x - hi is exact in float32, so hi + lo holds x to within 2^-22 of |x|.
// A product a b is then taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, each
// pass a mma.sync into the same float32 accumulator, the small terms
// first; the term lo_a lo_b (below 2^-22 |a b|) is dropped.  One pass,
// hi_a hi_b alone, keeps 11 bits of each operand and errs by ~1e-3 of a
// sum: it would break the 2e-5 contract of csrc/kkt_solve.cu at n = 1024;
// three passes err like another float32 order of summation (PERF.md §6,
// scripts/mma_tf32_probe.cu).
//
// The fragments of mma.sync.aligned.m16n8k8.row.col .tf32 with float32
// sums (gid = lane / 4, tig = lane % 4): a[q] holds A[gid + 8 (q & 1)]
// [tig + 4 (q >> 1)] of the 16 x 8 A, b[q] holds B[tig + 4 q][gid] of the
// 8 x 8 B, d[c] holds D[gid + 8 (c >> 1)][2 tig + (c & 1)] of the 16 x 8 D.
//
// Under QPDO_CUDA_STUB (tests/torch_cuda_stub) the split rounds as cvt.rna
// does, and the product gathers the warp's fragments through its exchange
// slots and sums each output in a fixed order: the accumulator, then the
// eight products in k order, each sum rounded to float32 (the products of
// two TF32 values are exact).  The card's tensor cores sum in their own
// order; both are held to the same tolerance, not to the same bits.

#pragma once

#include <cstdint>

// x rounded to TF32 (its 13 low significand bits 0), as a float32
__device__ __forceinline__ float tf32_round(float x) {
#ifdef QPDO_CUDA_STUB
  uint32_t u;
  std::memcpy(&u, &x, sizeof(u));
  if ((u & 0x7f800000u) != 0x7f800000u) {      // inf and NaN pass as they are
    const uint32_t keep = u & ~0x1fffu;
    // ties away from zero: the significand's magnitude rounds up, a carry
    // into the exponent included
    u = ((u & 0x1fffu) >= 0x1000u) ? keep + 0x2000u : keep;
  }
  float r;
  std::memcpy(&r, &u, sizeof(r));
  return r;
#else
  // (the same rounding written as an integer add and mask splits as fast
  // in scripts/mma_tf32_probe.cu, and made the route 30% slower: PERF.md)
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
#endif
}

// x = hi + lo (to within 2^-22 |x|), both TF32
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// d += A B, one pass of mma.sync m16n8k8 .tf32 (a and b TF32 already)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4],
                                         const float (&b)[2]) {
#ifdef QPDO_CUDA_STUB
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  uint64_t* slots = cuda_stub::warp_slots();
  // the card reads the 19 high bits of a .tf32 operand
  auto tf32_bits = [](float x) {
    uint32_t u;
    std::memcpy(&u, &x, sizeof(u));
    u &= ~0x1fffu;
    std::memcpy(&x, &u, sizeof(u));
    return x;
  };
  float A[16][8], B[8][8];
  // two floats of each lane at once: slot l holds lane l's pair
  auto gather = [&](float x, float y, auto&& place) {
    float pair[2] = {x, y};
    std::memcpy(&slots[lane], pair, sizeof(pair));
    __syncwarp();
    for (int l = 0; l < 32; ++l) {
      std::memcpy(pair, &slots[l], sizeof(pair));
      place(l >> 2, l & 3, pair[0], pair[1]);
    }
    __syncwarp();
  };
  gather(a[0], a[1], [&](int g, int t, float x, float y) {
    A[g][t] = tf32_bits(x);
    A[g + 8][t] = tf32_bits(y);
  });
  gather(a[2], a[3], [&](int g, int t, float x, float y) {
    A[g][t + 4] = tf32_bits(x);
    A[g + 8][t + 4] = tf32_bits(y);
  });
  gather(b[0], b[1], [&](int g, int t, float x, float y) {
    B[t][g] = tf32_bits(x);
    B[t + 4][g] = tf32_bits(y);
  });
  for (int c = 0; c < 4; ++c) {
    const int i = gid + 8 * (c >> 1), j = 2 * tig + (c & 1);
    float s = d[c];
    for (int k = 0; k < 8; ++k) s = s + A[i][k] * B[k][j];
    d[c] = s;
  }
#else
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
#endif
}

// d += A B in three passes: lo_a hi_b, hi_a lo_b, then hi_a hi_b (the
// small terms first)
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const float (&ahi)[4],
                                           const float (&alo)[4],
                                           const float (&bhi)[2],
                                           const float (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}
