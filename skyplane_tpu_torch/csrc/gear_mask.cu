// K-A' gear_mask: Gear rolling hash + the full-width boundary-candidate mask,
// one byte (0 or 1) per input byte, over a [B, n] uint8 batch.
//
// The byte-mask form of the gear hash for datapath_step, which returns the
// whole [B, N] bool mask rather than compacted candidates (the gateway
// path's call A is K-AB, csrc/gear_compact.cu). Replaces the Pallas kernel
// skyplane_tpu/ops/pallas_kernels.py (_windowed_sum_kernel /
// gear_windowed_sum_pallas), with the GEAR_TABLE gather (ops/gear.py
// gear_hash) and the top-bits test (ops/gear.py boundary_candidate_mask)
// around it in ops/pipeline.py _datapath_step_impl.
//
// What bounds it on the H100: bytes. It reads each input byte once (plus the
// 32-byte halo in front of each thread's word, mostly from L1) and writes one
// byte per input byte. Each thread owns one 32-byte word and runs
// h = (h << 1) + G[b] over the 32 bytes in front of it and then over its own
// 32 bytes, all in registers; the shift drops bits past 31, so this is the
// 32-tap windowed sum exactly. The 32 mask bits are spread to 32 bytes and
// stored as two 16-byte vectors when the output rows are 16-byte aligned.
//
// Rows are read with stride n_pad (a multiple of 8192; the wrapper pads a
// row with zeros on the right, which changes no hash below n because the
// hash is causal) and written with stride n.
//
// Halo mode (the SPMD step's seq shards, skyplane_tpu_torch/parallel/
// datapath_spmd.py; the counterpart of _gear_hash_halo in
// skyplane_tpu/parallel/datapath_spmd.py, whose 31 gear values arrive by
// ppermute): `halo` holds [rows, 32] bytes, the left shard's last 32 bytes of
// each row, and word 0 of a row reads its 32 front bytes there instead of
// starting from h = 0. Every other word is unchanged, so the kernel's bytes
// grow by 32 a row. A null `halo` is the kernel without halo exactly (a
// chunk's first shard: its hash has a zero prefix, which 32 zero bytes would
// not give, since the table maps byte 0 to a nonzero value).
#include <cstdint>
#include <cuda_runtime.h>
#include "current_device.cuh"

namespace {

constexpr int kThreads = 256;              // one 32-byte word per thread
constexpr int kTileBytes = kThreads * 32;  // 8 KiB per block

// bits 0..3 of `nibble` -> bytes 0..3 of the result, each 0 or 1
__device__ __forceinline__ uint32_t spread_nibble(uint32_t nibble) {
  return (nibble | (nibble << 7) | (nibble << 14) | (nibble << 21)) & 0x01010101u;
}

__global__ void gear_mask_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ halo,
                                 const uint32_t* __restrict__ gear_table, uint8_t* __restrict__ out,
                                 long long n_pad, long long n, int mask_bits, int vec_out) {
  __shared__ uint32_t table[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) table[i] = gear_table[i];
  __syncthreads();

  const int row = blockIdx.y;
  const long long word = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long pos0 = word * 32;
  if (pos0 >= n) return;  // the padding past n: nothing to write
  const uint4* cur = reinterpret_cast<const uint4*>(data + (long long)row * n_pad + pos0);

  // the 32 bytes before this word: the row's own, or the left shard's for word 0
  const uint4* front = nullptr;
  if (word > 0) {
    front = cur - 2;
  } else if (halo != nullptr) {
    front = reinterpret_cast<const uint4*>(halo + (long long)row * 32);
  }
  uint32_t h = 0;
  if (front != nullptr) {
    const uint4 p0 = front[0];
    const uint4 p1 = front[1];
    const uint32_t prev[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int w = 0; w < 8; ++w) {
#pragma unroll
      for (int k = 0; k < 4; ++k) h = (h << 1) + table[(prev[w] >> (8 * k)) & 0xFFu];
    }
  }
  const uint4 c0 = cur[0];
  const uint4 c1 = cur[1];
  const uint32_t own[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const int shift = 32 - mask_bits;
  uint32_t bits = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h = (h << 1) + table[(own[w] >> (8 * k)) & 0xFFu];
      if ((h >> shift) == 0) bits |= 1u << (w * 4 + k);
    }
  }

  uint8_t* dst = out + (long long)row * n + pos0;
  if (vec_out && pos0 + 32 <= n) {
    uint4 v0, v1;
    v0.x = spread_nibble(bits & 0xFu);
    v0.y = spread_nibble((bits >> 4) & 0xFu);
    v0.z = spread_nibble((bits >> 8) & 0xFu);
    v0.w = spread_nibble((bits >> 12) & 0xFu);
    v1.x = spread_nibble((bits >> 16) & 0xFu);
    v1.y = spread_nibble((bits >> 20) & 0xFu);
    v1.z = spread_nibble((bits >> 24) & 0xFu);
    v1.w = spread_nibble((bits >> 28) & 0xFu);
    reinterpret_cast<uint4*>(dst)[0] = v0;
    reinterpret_cast<uint4*>(dst)[1] = v1;
  } else {
    for (int k = 0; k < 32 && pos0 + k < n; ++k) dst[k] = (uint8_t)((bits >> k) & 1u);
  }
}

}  // namespace

// data [rows, n_pad] u8 (n_pad % 8192 == 0, 16-byte aligned), halo null or
// [rows, 32] u8 (16-byte aligned), gear_table [256] u32, out [rows, n] u8
// (0/1), n <= n_pad. vec_out: out is 16-byte aligned and n % 16 == 0.
// Launches on the current device, which must be `device`. Returns a
// cudaError_t.
extern "C" int skyt_gear_mask(const void* data, const void* halo, const void* gear_table, void* out, long long n_pad,
                              long long n, int rows, int mask_bits, int vec_out, int device, void* stream) {
  cudaError_t err = check_current_device(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(n_pad / kTileBytes), (unsigned)rows);
  gear_mask_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)data, (const uint8_t*)halo,
                                                                (const uint32_t*)gear_table, (uint8_t*)out, n_pad,
                                                                n, mask_bits, vec_out);
  return (int)cudaGetLastError();
}
