// Arithmetic in GF(2^31 - 1) on the card: the device counterpart of
// skyplane_tpu/ops/u32.py (fold31 / addmod31 / mulmod31). The TPU version
// splits products into 16-bit limbs because the TPU has no 64-bit lanes;
// Hopper multiplies 32 x 32 -> 64 bits natively, so each helper is one wide
// product or sum and a fold. Results are canonical in [0, M31).
#pragma once
#include <cstdint>

#define SKYT_M31 0x7FFFFFFFull

// any x < 2^64 -> [0, M31), using 2^31 == 1 (mod M31)
__device__ __forceinline__ uint32_t fold31(uint64_t x) {
  x = (x >> 31) + (x & SKYT_M31);  // < 2^33 + 2^31
  x = (x >> 31) + (x & SKYT_M31);  // < 2^31 + 5
  return (uint32_t)(x >= SKYT_M31 ? x - SKYT_M31 : x);
}

__device__ __forceinline__ uint32_t addmod31(uint32_t a, uint32_t b) { return fold31((uint64_t)a + b); }

__device__ __forceinline__ uint32_t mulmod31(uint32_t a, uint32_t b) { return fold31((uint64_t)a * b); }
