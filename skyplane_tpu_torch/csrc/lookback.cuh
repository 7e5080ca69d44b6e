// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan
// with Decoupled Look-back", 2016) over 64-bit status words, shared by the
// single-pass kernels (gear_compact, blockpack_encode). A tile's status word
// holds its flag in bits 32-33 and a 32-bit count in bits 0-31. A word
// carries its own count and publishes nothing else, so it is written and
// read relaxed, with no fence: a gpu-scope release or acquire would wait for
// the SM's stores in flight, and an acquire load would also invalidate the
// SM's L1 on every spin. Tiles are
// taken in row-major order from a global ticket when a block starts them, so
// every tile's predecessors have started and the look-back cannot deadlock.
#pragma once
#include <cstdint>

namespace {

constexpr int kLookback = 4;                           // status words a lane reads per look-back round
constexpr unsigned long long kAggregate = 1ull << 32;  // this tile's count
constexpr unsigned long long kInclusive = 2ull << 32;  // the row's count up to and including this tile

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// warp 0: tile `index`'s exclusive offset in its row, from the status words
// of the tiles in front of it (index > 0; its aggregate is published);
// publishes its inclusive prefix
__device__ long long look_back(unsigned long long* row_status, long long index, unsigned agg, int lane) {
  long long excl = 0;
  for (long long base = index - 1;; base -= 32 * kLookback) {
    unsigned long long s[kLookback];
#pragma unroll
    for (int i = 0; i < kLookback; ++i) {  // before the row: an inclusive 0, past tile 0's own
      const long long idx = base - lane * kLookback - i;
      s[i] = idx >= 0 ? load_relaxed(row_status + idx) : kInclusive;
    }
    int first = kLookback;  // this lane's nearest inclusive prefix
#pragma unroll
    for (int i = kLookback - 1; i >= 0; --i) {
      while ((s[i] >> 32) == 0) s[i] = load_relaxed(row_status + base - lane * kLookback - i);
      if ((s[i] >> 32) == 2) first = i;
    }
    const unsigned found = __ballot_sync(0xFFFFFFFFu, first < kLookback);
    const int last = found ? __ffs(found) - 1 : 31;  // tiles back to the nearest inclusive prefix
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < kLookback; ++i) {
      if (lane < last || (lane == last && i <= first)) sum += (unsigned)s[i];
    }
    excl += __reduce_add_sync(0xFFFFFFFFu, sum);
    if (found) break;
  }
  if (lane == 0) store_relaxed(row_status + index, kInclusive | (unsigned)(excl + agg));
  return excl;
}

}  // namespace
