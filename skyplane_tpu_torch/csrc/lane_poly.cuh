// The shared core of K-C segment_fp and K-D segment_fp_fixed: the 8-lane
// mod-(2^31-1) polynomial of 64-byte words as a u8 product on the tensor
// cores.
//
// A word at byte offset w0 that lies wholly inside a segment ending at c adds,
// per lane l,
//
//   sum_{k<64} b_{w0+k} r_l^(c-1-w0-k) = r_l^(c-w0-64) * W_l,
//   W_l = sum_{k<64} b_{w0+k} r_l^(63-k).
//
// W is the same function for every word: D = A x B with A the [words, 64] u8
// view of the bytes and B = word_limbs, a constant [64, 32] u8 matrix whose
// column 4l+q holds limb q (bits 8q..8q+7) of r_l^(63-k). Then
// W_l = sum_q D[., 4l+q] << 8q. Every D entry is < 64 * 255 * 255 < 2^22, so
// the s32 accumulator is exact, W_l < 2^22 * (1 + 2^8 + 2^16 + 2^24) < 2^47
// in u64, and one fold31 brings it to [0, M31). What is left per word and lane
// on the CUDA cores: the recombination, a fold, one power read and a mulmod.
// A word that a segment end cuts after m bytes takes a second product with
// its first m bytes zeroed (zero_below), which gives both pieces.
//
// The product is mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32: a warp
// takes a group of 16 words (1 KiB) per pass, 2 k-steps x 4 n-tiles = 8 mma.
// wgmma is not used: a byte-bound kernel needs about 1/2000 of the tensor
// rate that mma.sync already gives, and mma.sync takes A from registers.
//
// The k order inside the mma is free, as long as A and B use the same one:
// thread (g = lane/4, t = lane%4) feeds bytes 16t..16t+15 of word g (`lo`)
// and of word g+8 (`hi`), one 16-byte load each, so a warp reads its 1 KiB
// group as two 512-byte runs. With the PTX fragment layout (a0/a2: row g,
// k 4t..4t+3 / 16+4t..; a1/a3: row g+8; b0/b1: column g, k 4t.. / 16+4t..),
// mma k index 4t+e of k-step s is word byte 16t+8s+e and index 16+4t+e is
// byte 16t+8s+4+e. The B fragments are loaded once per CTA in that order.
//
// D comes back as c0,c1 = D[g][2t, 2t+1] and c2,c3 = D[g+8][2t, 2t+1] of each
// n-tile j: limbs 2(t&1), 2(t&1)+1 of lane 2j + t/2. Threads t and t^1 swap
// halves, so that after one shuffle an even t owns word g and an odd t word
// g+8, each with lanes t/2, 2+t/2, 4+t/2, 6+t/2 (value j is lane 2j + t/2).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "resident.cuh"
#include "u32.cuh"

namespace lane_poly {

constexpr int kLanes = 8;
constexpr int kWordBytes = 64;
constexpr int kGroupWords = 16;                        // the m of m16n8k32
constexpr int kGroupBytes = kGroupWords * kWordBytes;  // 1 KiB per warp pass
constexpr int kLimbCols = 4 * kLanes;                  // word_limbs is [64, 32]
constexpr unsigned kWarpAll = 0xFFFFFFFFu;
constexpr int kMaxSeg = 1 << 18;  // the power tables' length (MAX_SEGMENT_BYTES)

// B fragments for this thread: for n-tile j, column n = 8j + g, the four
// registers hold word bytes 16t .. 16t+15 of that column, 4 bytes each.
__device__ __forceinline__ void load_limbs(const uint8_t* __restrict__ limbs, uint32_t b[16]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) v |= (uint32_t)limbs[(16 * t + 4 * r + e) * kLimbCols + 8 * j + g] << (8 * e);
      b[4 * j + r] = v;
    }
  }
}

__device__ __forceinline__ void mma_u8(int d[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The word this thread owns after word_values: g for an even t, g + 8 for an odd t.
__device__ __forceinline__ int owned_word() {
  const int lane = threadIdx.x & 31;
  return (lane >> 2) + ((lane & 1) << 3);
}

// The lane of value j of this thread: 2j + t/2.
__device__ __forceinline__ int lane_of(int j) { return 2 * j + ((threadIdx.x & 3) >> 1); }

// W_l mod M31 for the owned word and lanes lane_of(0..3), as a value below
// 2^31 + 1 (M31 itself may stand for 0). Warp-wide: all 32 threads call it
// together. Each thread joins its two limbs of a word in 32 bits
// (d + (d' << 8) < 2^30); the pair of limbs 2 and 3 weighs 2^16, and
// 2^16 * h == (h >> 15) + ((h & 0x7FFF) << 16) (mod M31) since 2^31 == 1.
__device__ __forceinline__ void word_values(uint4 lo, uint4 hi, const uint32_t b[16], uint32_t w[4]) {
  const bool odd = threadIdx.x & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int d[4] = {0, 0, 0, 0};
    mma_u8(d, lo.x, hi.x, lo.y, hi.y, b[4 * j + 0], b[4 * j + 1]);  // word bytes 16t + 0..7
    mma_u8(d, lo.z, hi.z, lo.w, hi.w, b[4 * j + 2], b[4 * j + 3]);  // word bytes 16t + 8..15
    const uint32_t p_lo = (uint32_t)d[0] + ((uint32_t)d[1] << 8);  // word g
    const uint32_t p_hi = (uint32_t)d[2] + ((uint32_t)d[3] << 8);  // word g + 8
    const uint32_t got = __shfl_xor_sync(kWarpAll, odd ? p_lo : p_hi, 1);
    const uint32_t low = odd ? got : p_lo;    // limbs 0, 1 of the owned word
    const uint32_t high = odd ? p_hi : got;   // limbs 2, 3
    const uint32_t s = low + (high >> 15) + ((high & 0x7FFFu) << 16);  // < 2^30 + 2^15 + 2^31
    w[j] = (s & (uint32_t)SKYT_M31) + (s >> 31);
  }
}

// This thread's four lanes (lane_of(0..3)) of row `row` of a [rows][8] u32
// table whose rows hold lanes 0, 2, 4, 6, 1, 3, 5, 7: one 16-byte read.
__device__ __forceinline__ uint4 lane_row(const uint32_t* __restrict__ table, int row) {
  return __ldg(reinterpret_cast<const uint4*>(table + row * kLanes) + ((threadIdx.x & 3) >> 1));
}

// The power table by word (state.word_powers_from_powers) is [64][kMaxSeg /
// 64] such rows, row (x % 64, x / 64) holding r^x: a word's eight lanes share
// one 32-byte row, and the words of one segment read consecutive rows.
__device__ __forceinline__ int word_row(int x) { return (x & 63) * (kMaxSeg / 64) + (x >> 6); }

// r^x for this thread's lanes.
__device__ __forceinline__ uint4 lane_power(const uint32_t* __restrict__ wpow, int x) {
  return lane_row(wpow, word_row(x));
}

// r_l^x for all eight lanes, in lane order l = 0..7.
__device__ __forceinline__ void all_lane_powers(const uint32_t* __restrict__ wpow, int x, uint32_t p[kLanes]) {
  const uint4* r = reinterpret_cast<const uint4*>(wpow + word_row(x) * kLanes);
  const uint4 a = __ldg(r), c = __ldg(r + 1);
  p[0] = a.x, p[2] = a.y, p[4] = a.z, p[6] = a.w;
  p[1] = c.x, p[3] = c.y, p[5] = c.z, p[7] = c.w;
}

// v (16 bytes at word offsets o .. o+15) with the bytes below offset m zeroed.
__device__ __forceinline__ uint4 zero_below(uint4 v, int m, int o) {
  auto part = [&](uint32_t x, int q) {  // bytes o + 4q .. o + 4q + 3
    const int nz = m - o - 4 * q;
    return nz <= 0 ? x : (nz >= 4 ? 0u : x & (0xFFFFFFFFu << (8 * nz)));
  };
  return make_uint4(part(v.x, 0), part(v.y, 1), part(v.z, 2), part(v.w, 3));
}

__device__ __forceinline__ uint32_t lane_part(uint4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// a * b (each below 2^31 + 2) reduced to below 2^33 and congruent mod M31; a
// running u64 sum of such values is folded once, where it is stored.
__device__ __forceinline__ uint64_t mul_lazy31(uint32_t a, uint32_t b) {
  const uint64_t x = (uint64_t)a * b;
  return (x & SKYT_M31) + (x >> 31);
}

// The byte sum of the owned word (< 2^14). Warp-wide.
__device__ __forceinline__ uint32_t word_bytesum(uint4 lo, uint4 hi) {
  constexpr uint32_t kOnes = 0x01010101u;
  uint32_t s_lo = __dp4a(lo.x, kOnes, __dp4a(lo.y, kOnes, __dp4a(lo.z, kOnes, __dp4a(lo.w, kOnes, 0u))));
  uint32_t s_hi = __dp4a(hi.x, kOnes, __dp4a(hi.y, kOnes, __dp4a(hi.z, kOnes, __dp4a(hi.w, kOnes, 0u))));
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the four threads of a word
    s_lo += __shfl_xor_sync(kWarpAll, s_lo, off);
    s_hi += __shfl_xor_sync(kWarpAll, s_hi, off);
  }
  return (threadIdx.x & 1) ? s_hi : s_lo;
}

__device__ __forceinline__ bool any_nonzero(uint4 v) { return (v.x | v.y | v.z | v.w) != 0; }

// Where the per-(slot, lane) sums go: a CTA's shared accumulator for slots
// [s_lo, s_lo + cap), the device accumulator for the rest. A value is folded
// first; the shared accumulator keeps its low and high 16 bits in two u32
// counters, since a 64-bit shared atomic add is a compare-and-swap loop and a
// 32-bit one is one instruction (each counter stays exact for 2^16 adds,
// far more than a CTA makes to one entry).
struct Sink {
  uint32_t* s_acc;  // [cap][8][2]: low 16 bits, high 15 bits
  long long s_lo;
  int cap;
  unsigned long long* g_acc;  // [slots][8]

  __device__ __forceinline__ void add(long long slot, int lane, unsigned long long v) const {
    const uint32_t f = fold31(v);
    const long long i = slot - s_lo;
    if (i >= 0 && i < cap) {
      atomicAdd(&s_acc[(i * kLanes + lane) * 2], f & 0xFFFFu);
      atomicAdd(&s_acc[(i * kLanes + lane) * 2 + 1], f >> 16);
    } else {
      atomicAdd(&g_acc[slot * kLanes + lane], (unsigned long long)f);
    }
  }

  // After a __syncthreads: the shared sums into the device accumulator, one
  // folded atomic per nonzero (slot, lane) below slots_end.
  __device__ __forceinline__ void drain(long long slots_end) const {
    for (int i = threadIdx.x; i < cap * kLanes; i += blockDim.x) {
      const unsigned long long v = s_acc[2 * i] + ((unsigned long long)s_acc[2 * i + 1] << 16);
      if (v != 0 && s_lo + i / kLanes < slots_end)
        atomicAdd(&g_acc[(s_lo + i / kLanes) * kLanes + i % kLanes], (unsigned long long)fold31(v));
    }
  }
};

// Warp-wide: add each valid thread's four values (lanes lane_of(0..3)) to its
// slot, one warp reduction per distinct slot; threads 0 and 2 hold the sums.
__device__ __forceinline__ void warp_add(const Sink& sink, bool valid, long long slot, const unsigned long long v[4]) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(kWarpAll, valid && (v[0] | v[1] | v[2] | v[3]) != 0);
  while (pending) {
    const long long s = __shfl_sync(kWarpAll, slot, __ffs(pending) - 1);
    const bool mine = valid && slot == s;
    unsigned long long x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = mine ? v[j] : 0ull;
#pragma unroll
    for (int off = 1; off <= 16; off <<= 1) {
      if (off == 2) continue;  // keep t/2 apart: it picks the lanes
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] += __shfl_xor_sync(kWarpAll, x[j], off);
    }
    if ((lane & ~2) == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (x[j] != 0) sink.add(s, lane_of(j), x[j]);
    }
    pending &= ~__ballot_sync(kWarpAll, mine);
  }
}

// A warp's running sums for one slot, so that a run of groups inside one
// segment costs one warp reduction in all. Values are below 2^33; a caller
// keeps a run under 2^16 groups, so sums stay far below 2^64.
struct Run {
  long long slot = -1;
  unsigned long long v[4] = {0, 0, 0, 0};

  // Warp-wide.
  __device__ __forceinline__ void add(const Sink& sink, bool valid, long long s, const unsigned long long x[4]) {
    if (__all_sync(kWarpAll, !valid || s == slot)) {
      if (valid) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] += x[j];
      }
      return;
    }
    flush(sink);
    const unsigned vm = __ballot_sync(kWarpAll, valid);  // not 0: some valid thread differs
    const long long s0 = __shfl_sync(kWarpAll, s, __ffs(vm) - 1);
    if (__all_sync(kWarpAll, !valid || s == s0)) {
      slot = s0;
      if (valid) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = x[j];
      }
    } else {
      warp_add(sink, valid, s, x);
    }
  }

  __device__ __forceinline__ void flush(const Sink& sink) {
    warp_add(sink, true, slot, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 0;
  }
};

}  // namespace lane_poly
