// K-C segment_fp: 8-lane mod-(2^31-1) polynomial fingerprints of the
// variable-length CDC segments of a padded [B, bucket] uint8 batch,
// -> [B, n_slots, 8] canonical lanes.
//
// Replaces call B, skyplane_tpu/ops/fused_cdc.py _fp_body / _fp_impl and
// skyplane_tpu/ops/fingerprint.py segment_fingerprint_cumsum (XLA: per lane a
// gather of powers, a limb-split mulmod, a cumsum and two gathers over the
// whole batch).
//
// What bounds it on the H100: integer work and power-table traffic. Every
// nonzero byte takes 8 wide multiply-adds, each with a 4-byte read from the
// 8 MiB power table (L2-resident). The design: one block per (row, 4 KiB
// tile); each thread holds 16 bytes in registers. A block walks the few
// segments that overlap its tile (first one found by binary search over the
// row's ascending ends), accumulates b * r^(c-1-i) in u64 per lane with no
// reduction per byte (16 bytes x 2^39 < 2^43 per thread), reduces the block
// in shared memory, folds once, and adds the folded partial into a u64
// accumulator per (row, slot, lane) with an integer atomic. Integer sums are
// associative, so the result does not depend on block order; a second pass
// folds the accumulators to canonical u32. Zero bytes (zero pages, padding)
// add nothing and are skipped.
//
// Contract on ends (what FusedCDCFP builds): ascending real ends, then one
// `bucket` end for the zero padding when the chunk is shorter than the
// bucket, then `bucket` sentinels. Slot j spans [min(c_{j-1}, c_j), c_j) with
// c = clip(ends, 0, bucket); byte i of slot j uses power index
// min(c_j - 1 - i, max_seg - 1), exactly as _fp_body computes rev_pos.
#include <cstdint>
#include <cuda_runtime.h>

#include "u32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kTileBytes = kThreads * kBytesPerThread;  // 4 KiB per block
constexpr int kLanes = 8;

__device__ __forceinline__ long long clip_end(int e, long long bucket) {
  return e < 0 ? 0 : (e > bucket ? bucket : (long long)e);
}

__global__ void segment_fp_partial_kernel(const uint8_t* __restrict__ data, const int32_t* __restrict__ ends,
                                          const uint32_t* __restrict__ powers, unsigned long long* __restrict__ acc,
                                          long long bucket, int n_slots, int max_seg) {
  __shared__ unsigned long long s_red[kLanes][kThreads];
  __shared__ int s_first;
  const int row = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * kTileBytes;
  const long long t1 = t0 + kTileBytes;
  const int32_t* e = ends + (long long)row * n_slots;
  if (threadIdx.x == 0) {  // first slot whose end lies past t0
    int lo = 0, hi = n_slots;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (clip_end(e[mid], bucket) > t0) hi = mid; else lo = mid + 1;
    }
    s_first = lo;
  }
  const long long my0 = t0 + (long long)threadIdx.x * kBytesPerThread;
  const uint4 v = *reinterpret_cast<const uint4*>(data + (long long)row * bucket + my0);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  __syncthreads();

  for (int j = s_first; j < n_slots; ++j) {  // block-uniform walk over the tile's segments
    const long long c = clip_end(e[j], bucket);
    const long long s = j == 0 ? 0 : clip_end(e[j - 1], bucket);
    const long long lo = (s < c ? s : c) > t0 ? (s < c ? s : c) : t0;
    const long long hi = c < t1 ? c : t1;
    if (hi > lo) {
      unsigned long long sum[kLanes];
#pragma unroll
      for (int li = 0; li < kLanes; ++li) sum[li] = 0;
#pragma unroll
      for (int k = 0; k < kBytesPerThread; ++k) {
        const long long i = my0 + k;
        const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
        if (b != 0 && i >= lo && i < hi) {
          long long idx = c - 1 - i;
          if (idx > max_seg - 1) idx = max_seg - 1;
#pragma unroll
          for (int li = 0; li < kLanes; ++li) sum[li] += (unsigned long long)b * powers[(long long)li * max_seg + idx];
        }
      }
#pragma unroll
      for (int li = 0; li < kLanes; ++li) s_red[li][threadIdx.x] = sum[li];
      __syncthreads();
      for (int st = kThreads / 2; st > 0; st >>= 1) {
        if (threadIdx.x < st) {
#pragma unroll
          for (int li = 0; li < kLanes; ++li) s_red[li][threadIdx.x] += s_red[li][threadIdx.x + st];
        }
        __syncthreads();
      }
      if (threadIdx.x < kLanes) {
        const unsigned long long total = s_red[threadIdx.x][0];  // < 2^51
        if (total != 0)
          atomicAdd(&acc[((long long)row * n_slots + j) * kLanes + threadIdx.x], (unsigned long long)fold31(total));
      }
      __syncthreads();
    }
    if (c >= t1) break;
  }
}

__global__ void segment_fp_finalize_kernel(const unsigned long long* __restrict__ acc, int32_t* __restrict__ out,
                                           long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = (int32_t)fold31(acc[k]);
}

}  // namespace

// data [rows, bucket] u8 (bucket % 4096 == 0, 16-byte aligned rows), ends
// [rows, n_slots] i32, powers [8, max_seg] u32, acc [rows, n_slots, 8] u64
// scratch, out [rows, n_slots, 8] i32 (values < M31). Returns a cudaError_t.
extern "C" int skyt_segment_fp(const void* data, const void* ends, const void* powers, void* acc, void* out,
                               long long bucket, int rows, int n_slots, int max_seg, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_out = (long long)rows * n_slots * kLanes;
  err = cudaMemsetAsync(acc, 0, (size_t)n_out * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(bucket / kTileBytes), (unsigned)rows);
  segment_fp_partial_kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (const int32_t*)ends,
                                                       (const uint32_t*)powers, (unsigned long long*)acc, bucket,
                                                       n_slots, max_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned fin_blocks = (unsigned)((n_out + 255) / 256);
  segment_fp_finalize_kernel<<<fin_blocks, 256, 0, st>>>((const unsigned long long*)acc, (int32_t*)out, n_out);
  return (int)cudaGetLastError();
}
