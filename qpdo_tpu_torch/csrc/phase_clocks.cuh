// clock64() marks at the phase boundaries of a kernel, for a card that has
// no profiler at hand.  Compiled in only with -DQPDO_PHASE_CLOCKS
// (scripts/kernel_phase_clocks.py); otherwise every macro here is empty and
// the kernels are what they are without this file.
//
// Thread 0 of block (0, 0) records into qpdo_phase_clocks, one array per
// source file, which that file's qpdo_*_phase_clocks entry point copies out:
//  * QPDO_MARK(i) stores the clock at a point passed once: slot i.
//  * QPDO_LAPS_BEGIN(), QPDO_LAP(i), QPDO_LAPS_END() add up, over a loop,
//    the cycles since the lap before into slot i, in one function.
// The marks cost a few cycles each and hold instructions in place: a marked
// kernel computes the same values, not at the shipped kernel's time.

#pragma once

#ifdef QPDO_PHASE_CLOCKS

namespace {

constexpr int kPhaseClocks = 16;
__device__ long long qpdo_phase_clocks[kPhaseClocks];

__device__ __forceinline__ bool phase_clock_recorder() {
  return threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0;
}

inline int read_phase_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, qpdo_phase_clocks, sizeof(long long) * kPhaseClocks));
}

}  // namespace

#define QPDO_MARK(i) \
  if (phase_clock_recorder()) qpdo_phase_clocks[i] = clock64()
#define QPDO_LAPS_BEGIN()                     \
  long long qpdo_laps[kPhaseClocks] = {};     \
  long long qpdo_lap_last = clock64()
#define QPDO_LAP(i)                                    \
  do {                                                 \
    const long long qpdo_now = clock64();              \
    qpdo_laps[i] += qpdo_now - qpdo_lap_last;          \
    qpdo_lap_last = qpdo_now;                          \
  } while (0)
#define QPDO_LAPS_END()                                              \
  if (phase_clock_recorder()) {                                      \
    _Pragma("unroll")                                                \
    for (int qpdo_i = 0; qpdo_i < kPhaseClocks; ++qpdo_i)            \
      qpdo_phase_clocks[qpdo_i] = qpdo_laps[qpdo_i];                 \
  }

#else

#define QPDO_MARK(i)
#define QPDO_LAPS_BEGIN()
#define QPDO_LAP(i)
#define QPDO_LAPS_END()

#endif
