// Shared pieces of K2 ring_scatter, the owner-side bulk push (K1, K3 and K4
// use ring_copy.cuh).
//
// The kernel moves whole rows from a dense block into a lane's ring of
// `cap` rows, at a dynamic cut point that each thread turns into a
// physical row itself: row (start + i) mod cap.  A row is `wpr` words of
// type T (4-byte words where the row width allows, else 2 or 1 bytes), so
// one kernel serves f32, i32 and bf16 payloads alike.  The grid covers
// lanes (y) x words (x); both dimensions stride, so any lane count and
// block length launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring {

constexpr int kThreads = 256;

// x mod cap in [0, cap), also for negative x (Python's `%`, as the plain
// versions compute it).
__device__ __forceinline__ int64_t wrap(int64_t x, int64_t cap) {
  const int64_t r = x % cap;
  return r < 0 ? r + cap : r;
}

inline dim3 grid_for(int64_t words_per_lane, int lanes) {
  int64_t bx = (words_per_lane + kThreads - 1) / kThreads;
  if (bx < 1) bx = 1;
  if (bx > (1 << 20)) bx = 1 << 20;  // the loops stride over the rest
  const int by = lanes < 65535 ? lanes : 65535;
  return dim3((unsigned)bx, (unsigned)by);
}

}  // namespace ring

// Run the statement list with T bound to the unsigned word type of
// `word_bytes` (4, 2 or 1); any other width is refused.
#define RING_DISPATCH_WORD(word_bytes, ...)         \
  switch (word_bytes) {                             \
    case 4: {                                       \
      using T = uint32_t;                           \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case 2: {                                       \
      using T = uint16_t;                           \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    case 1: {                                       \
      using T = uint8_t;                            \
      __VA_ARGS__;                                  \
      break;                                        \
    }                                               \
    default:                                        \
      return (int)cudaErrorInvalidValue;            \
  }
