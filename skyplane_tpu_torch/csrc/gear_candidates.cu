// K-A gear_candidates: Gear rolling hash + boundary-candidate mask + per-tile
// candidate counts over a padded [B, bucket] uint8 batch.
//
// Replaces the Pallas kernel skyplane_tpu/ops/pallas_kernels.py
// (_windowed_sum_kernel / gear_windowed_sum_pallas), together with the
// GEAR_TABLE gather (ops/gear.py gear_hash) and the top-bits test
// (ops/gear.py boundary_candidate_mask) that surround it in call A
// (ops/fused_cdc.py _candidates_impl).
//
// What bounds it on the H100: bytes. It reads each input byte once and writes
// one bit per byte plus one count per 8 KiB tile; the hash is a shift and an
// add per byte. The design keeps all of the hash state in registers: each
// thread owns one 32-byte word of the row and runs the sequential recurrence
// h = (h << 1) + G[b] over the 32 bytes in front of its word (its left
// halo; a zero prefix at the start of a row) and then over its own 32 bytes.
// Because the shift drops bits past 31, that is exactly the 32-tap windowed
// sum the TPU kernel builds with 5 log-doubling passes in VMEM. The 32 mask
// bits of a thread's word form one uint32, so the mask write is coalesced.
// The 1 KiB gear table sits in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // one 32-byte word per thread
constexpr int kTileBytes = kThreads * 32;   // 8 KiB per block; one count per tile

__device__ __forceinline__ uint32_t roll_word(uint32_t h, uint32_t word, const uint32_t* table) {
#pragma unroll
  for (int k = 0; k < 4; ++k) h = (h << 1) + table[(word >> (8 * k)) & 0xFFu];
  return h;
}

__global__ void gear_candidates_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ lens,
                                       const uint32_t* __restrict__ gear_table, uint32_t* __restrict__ mask,
                                       int32_t* __restrict__ counts, long long bucket, int mask_bits) {
  __shared__ uint32_t table[256];
  __shared__ int block_count;
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = gear_table[i];
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();

  const int row = blockIdx.y;
  const long long word = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pos0 = word * 32;
  const uint4* cur = reinterpret_cast<const uint4*>(data + (long long)row * bucket + pos0);

  uint32_t h = 0;
  if (word > 0) {  // left halo: the 32 bytes before this word
    const uint4 p0 = cur[-2];
    const uint4 p1 = cur[-1];
    const uint32_t halo[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int w = 0; w < 8; ++w) h = roll_word(h, halo[w], table);
  }
  const uint4 c0 = cur[0];
  const uint4 c1 = cur[1];
  const uint32_t own[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const long long n = lens[row];
  const int shift = 32 - mask_bits;
  uint32_t bits = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h = (h << 1) + table[(own[w] >> (8 * k)) & 0xFFu];
      const int bit = w * 4 + k;
      if ((h >> shift) == 0 && pos0 + bit < n) bits |= 1u << bit;
    }
  }
  mask[(long long)row * (bucket / 32) + word] = bits;
  atomicAdd(&block_count, __popc(bits));
  __syncthreads();
  if (threadIdx.x == 0) counts[(long long)row * gridDim.x + blockIdx.x] = block_count;
}

}  // namespace

// data [rows, bucket] u8 (16-byte aligned rows), lens [rows] i32, gear_table
// [256] u32, mask [rows, bucket/32] u32 (bit k of word w = position 32w+k),
// counts [rows, bucket/8192] i32. bucket % 8192 == 0. Returns a cudaError_t.
extern "C" int skyt_gear_candidates(const void* data, const void* lens, const void* gear_table, void* mask,
                                    void* counts, long long bucket, int rows, int mask_bits, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(bucket / kTileBytes), (unsigned)rows);
  gear_candidates_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint32_t*)gear_table, (uint32_t*)mask, (int32_t*)counts,
      bucket, mask_bits);
  return (int)cudaGetLastError();
}
