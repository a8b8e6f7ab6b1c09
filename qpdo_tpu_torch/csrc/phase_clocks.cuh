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
//  * QPDO_SPAN_BEGIN(), QPDO_SPAN(i) add the cycles since the span before
//    to slot i at once, so that a sequence of launches adds up there (the
//    launches of a stream run one after another); the file's
//    qpdo_*_phase_clocks_reset entry point sets the slots to 0 first.
//  * QPDO_SPAN_IF(i, cond) is QPDO_SPAN for thread 0 of every block where
//    cond holds (atomic adds): the blocks of one cluster, each adding the
//    spans that it spends in a phase.
//  * QPDO_SPAN_STEP(i, cond, step) is QPDO_SPAN_IF that also keeps the span
//    of each block (blockIdx.x < kStepClockBlocks) and step
//    (< kStepClockSteps) apart, in qpdo_step_clocks[block][step][i], so that the busiest
//    block of a step shows; QPDO_SPAN_STEP_BY(i, cond, step, thread) the
//    same for another recording thread of the block (one that works in
//    another phase than thread 0).  The file's qpdo_*_block_phase_clocks
//    entry point copies them out.
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

constexpr int kStepClockBlocks = 16;
constexpr int kStepClockSteps = 64;
constexpr int kStepClocks = kStepClockBlocks * kStepClockSteps * kPhaseClocks;
__device__ long long qpdo_step_clocks[kStepClocks];

inline int reset_phase_clocks() {
  static const long long zeros[kPhaseClocks] = {};
  static const long long step_zeros[kStepClocks] = {};
  const cudaError_t err =
      cudaMemcpyToSymbol(qpdo_phase_clocks, zeros, sizeof(zeros));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaMemcpyToSymbol(qpdo_step_clocks, step_zeros, sizeof(step_zeros)));
}

inline int read_step_clocks(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, qpdo_step_clocks, sizeof(long long) * kStepClocks));
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

#define QPDO_SPAN_BEGIN() long long qpdo_span_last = clock64()
#define QPDO_SPAN(i)                                                 \
  do {                                                               \
    const long long qpdo_now = clock64();                            \
    if (phase_clock_recorder())                                      \
      qpdo_phase_clocks[i] += qpdo_now - qpdo_span_last;             \
    qpdo_span_last = qpdo_now;                                       \
  } while (0)

#define QPDO_SPAN_IF(i, cond)                                        \
  do {                                                               \
    const long long qpdo_now = clock64();                            \
    if (threadIdx.x == 0 && (cond))                                  \
      atomicAdd(reinterpret_cast<unsigned long long*>(               \
                    &qpdo_phase_clocks[i]),                          \
                static_cast<unsigned long long>(qpdo_now - qpdo_span_last)); \
    qpdo_span_last = qpdo_now;                                       \
  } while (0)

#define QPDO_SPAN_STEP_BY(i, cond, step, thread)                     \
  do {                                                               \
    const long long qpdo_now = clock64();                            \
    if (threadIdx.x == (thread) && (cond)) {                         \
      const long long qpdo_span = qpdo_now - qpdo_span_last;         \
      atomicAdd(reinterpret_cast<unsigned long long*>(               \
                    &qpdo_phase_clocks[i]),                          \
                static_cast<unsigned long long>(qpdo_span));         \
      if (blockIdx.x < kStepClockBlocks && (step) < kStepClockSteps) \
        qpdo_step_clocks[(blockIdx.x * kStepClockSteps + (step)) *   \
                         kPhaseClocks + (i)] += qpdo_span;           \
    }                                                                \
    qpdo_span_last = qpdo_now;                                       \
  } while (0)
#define QPDO_SPAN_STEP(i, cond, step) QPDO_SPAN_STEP_BY(i, cond, step, 0)

#else

#define QPDO_MARK(i)
#define QPDO_LAPS_BEGIN()
#define QPDO_LAP(i)
#define QPDO_LAPS_END()
#define QPDO_SPAN_BEGIN()
#define QPDO_SPAN(i)
#define QPDO_SPAN_IF(i, cond)
#define QPDO_SPAN_STEP(i, cond, step)
#define QPDO_SPAN_STEP_BY(i, cond, step, thread)

#endif
