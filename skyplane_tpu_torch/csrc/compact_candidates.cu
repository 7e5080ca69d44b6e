// K-B compact_candidates: per-tile candidate counts -> scan over the row ->
// the first `cap` candidate positions in ascending order, packed as
// [B, cap+1] int32 (sentinel `bucket` padding, TRUE count in column cap).
//
// Replaces the XLA compaction half of call A, skyplane_tpu/ops/fused_cdc.py
// _candidates_impl (cumsum of the mask, then a scatter-min of positions).
//
// What bounds it on the H100: bytes, and only few of them: the counts of the
// tiles in front of a block, its 1 KiB of mask words, and the packed output.
// The TPU got ascending order for free from its sequential grid; here blocks
// run in no order, so each block first sums the counts of the tiles before
// it (its exclusive offset; K-A wrote one count per 8 KiB tile), then scans
// the popcounts of its own 256 mask words in shared memory and writes its
// positions at offset + prefix. Blocks whose offset is already >= cap exit
// after that sum, so past the first few hundred KiB of a row the mask is
// never read. Block 0 of each row also writes the true count and the
// sentinel padding, which lands in slots no position can take.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one mask word (32 positions) per thread: the K-A tile

__device__ long long block_sum(long long v, long long* s) {
  s[threadIdx.x] = v;
  __syncthreads();
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) s[threadIdx.x] += s[threadIdx.x + st];
    __syncthreads();
  }
  const long long r = s[0];
  __syncthreads();
  return r;
}

__global__ void compact_candidates_kernel(const uint32_t* __restrict__ mask, const int32_t* __restrict__ counts,
                                          int32_t* __restrict__ out, long long bucket, int n_tiles, int cap) {
  __shared__ long long s_sum[kThreads];
  __shared__ int s_scan[kThreads];
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  const int32_t* row_counts = counts + (long long)row * n_tiles;
  int32_t* row_out = out + (long long)row * (cap + 1);

  long long part = 0;
  for (int i = threadIdx.x; i < tile; i += kThreads) part += row_counts[i];
  const long long offset = block_sum(part, s_sum);

  if (tile == 0) {
    long long tot = 0;
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) tot += row_counts[i];
    const long long total = block_sum(tot, s_sum);
    const int filled = total < cap ? (int)total : cap;
    for (int i = filled + threadIdx.x; i < cap; i += kThreads) row_out[i] = (int32_t)bucket;
    if (threadIdx.x == 0) row_out[cap] = (int32_t)total;
  }
  if (offset >= cap) return;  // block-uniform

  const long long word = (long long)tile * kThreads + threadIdx.x;
  uint32_t bits = mask[(long long)row * (bucket / 32) + word];
  const int c = __popc(bits);
  s_scan[threadIdx.x] = c;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // inclusive Hillis-Steele scan
    const int v = threadIdx.x >= off ? s_scan[threadIdx.x - off] : 0;
    __syncthreads();
    s_scan[threadIdx.x] += v;
    __syncthreads();
  }
  long long slot = offset + s_scan[threadIdx.x] - c;
  while (bits != 0 && slot < cap) {
    const int k = __ffs(bits) - 1;
    bits &= bits - 1;
    row_out[slot++] = (int32_t)(word * 32 + k);
  }
}

}  // namespace

// mask [rows, bucket/32] u32 and counts [rows, bucket/8192] i32 from K-A;
// out [rows, cap+1] i32. Returns a cudaError_t.
extern "C" int skyt_compact_candidates(const void* mask, const void* counts, void* out, long long bucket, int rows,
                                       int cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (int)(bucket / (kThreads * 32));
  dim3 grid((unsigned)n_tiles, (unsigned)rows);
  compact_candidates_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mask, (const int32_t*)counts, (int32_t*)out, bucket, n_tiles, cap);
  return (int)cudaGetLastError();
}
