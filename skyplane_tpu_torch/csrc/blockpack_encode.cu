// K-E blockpack_encode: block-suppress encode of a [B, n] uint8 batch ->
// tags [B, n/bb] u8 (0 zero, 1 constant, 2 literal), literals [B, n] u8 (the
// kept bytes as a dense prefix in block order, zero tail) and n_lit [B] i32.
//
// Replaces the XLA device function skyplane_tpu/ops/blockpack.py
// encode_device (an all-equal test per block, then a stable compaction by an
// int32 cumsum over every byte and a scatter), vmapped over the batch in
// ops/pipeline.py _datapath_step_impl.
//
// What bounds it on the H100: bytes. It must read the batch once and write
// the literals (the step's largest output) once. Blocks run in no order, so
// the stable compaction is three short launches instead of a cumsum over
// every byte:
//   1. classify: one warp per block compares every byte with the block's
//      first (16-byte loads when the rows allow it) and writes the tag;
//   2. scan: one 1024-thread block per row turns the tags into exclusive
//      literal offsets (a literal block keeps bb bytes, a constant block 1,
//      a zero block none) and n_lit; each thread scans a run of blocks
//      serially, so any number of blocks per row fits;
//   3. copy: one warp per block copies its kept bytes to its offset, one
//      byte per lane per step: a literal block lands at any byte offset
//      (each constant block before it shifts it by one), and byte stores of
//      consecutive lanes still coalesce. The same blocks zero the row's tail
//      [n_lit, n), spread evenly over them.
// bb is any divisor of n; nothing here needs a power of two.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // blocks per CTA in classify and copy
constexpr int kScanThreads = 1024;

constexpr uint8_t kTagZero = 0;
constexpr uint8_t kTagConst = 1;
constexpr uint8_t kTagLiteral = 2;

__global__ void classify_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ tags, long long n, int bb,
                                int n_blocks, int vec) {
  const int row = blockIdx.y;
  const int blk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* p = data + (long long)row * n + (long long)blk * bb;
  const uint32_t first = p[0];
  bool same = true;
  if (vec) {  // bb % 16 == 0 and 16-byte aligned rows
    const uint32_t rep = first * 0x01010101u;
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (int i = lane; i < bb / 16; i += 32) {
      const uint4 v = q[i];
      same &= (v.x == rep) & (v.y == rep) & (v.z == rep) & (v.w == rep);
    }
  } else {
    for (int i = lane; i < bb; i += 32) same &= p[i] == first;
  }
  same = __all_sync(0xFFFFFFFFu, same);
  if (lane == 0) tags[(long long)row * n_blocks + blk] = same ? (first == 0 ? kTagZero : kTagConst) : kTagLiteral;
}

__device__ __forceinline__ int kept_bytes(uint8_t tag, int bb) {
  return tag == kTagLiteral ? bb : (tag == kTagConst ? 1 : 0);
}

__global__ void scan_kernel(const uint8_t* __restrict__ tags, int32_t* __restrict__ offsets,
                            int32_t* __restrict__ n_lit, int bb, int n_blocks) {
  __shared__ long long s_warp[kScanThreads / 32];
  const int row = blockIdx.x;
  const uint8_t* t = tags + (long long)row * n_blocks;
  int32_t* o = offsets + (long long)row * n_blocks;
  const int per = (n_blocks + kScanThreads - 1) / kScanThreads;
  const int b0 = threadIdx.x * per;
  const int b1 = b0 + per < n_blocks ? b0 + per : n_blocks;
  long long mine = 0;
  for (int i = b0; i < b1; ++i) mine += kept_bytes(t[i], bb);

  // exclusive scan of the per-thread sums: within each warp, then across warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long inc = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_up_sync(0xFFFFFFFFu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    long long w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long v = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += v;
    }
    s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  long long run = (warp > 0 ? s_warp[warp - 1] : 0) + inc - mine;
  for (int i = b0; i < b1; ++i) {
    o[i] = (int32_t)run;
    run += kept_bytes(t[i], bb);
  }
  if (threadIdx.x == kScanThreads - 1) n_lit[row] = (int32_t)s_warp[31];
}

__global__ void copy_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ tags,
                            const int32_t* __restrict__ offsets, const int32_t* __restrict__ n_lit,
                            uint8_t* __restrict__ literals, long long n, int bb, int n_blocks) {
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  uint8_t* out = literals + (long long)row * n;
  const int blk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk < n_blocks) {
    const uint8_t tag = tags[(long long)row * n_blocks + blk];
    const uint8_t* src = data + (long long)row * n + (long long)blk * bb;
    uint8_t* dst = out + offsets[(long long)row * n_blocks + blk];
    if (tag == kTagLiteral) {
      for (int i = lane; i < bb; i += 32) dst[i] = src[i];
    } else if (tag == kTagConst && lane == 0) {
      dst[0] = src[0];
    }
  }
  // this CTA's share of the zero tail [n_lit, n)
  const long long span = (n + gridDim.x - 1) / gridDim.x;
  long long lo = (long long)blockIdx.x * span;
  const long long hi = lo + span < n ? lo + span : n;
  const long long tail = n_lit[row];
  if (lo < tail) lo = tail;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) out[i] = 0;
}

}  // namespace

// data [rows, n] u8; tags [rows, n/bb] u8; offsets [rows, n/bb] i32 scratch;
// literals [rows, n] u8; n_lit [rows] i32. n % bb == 0, n < 2^31. vec: bb %
// 16 == 0, n % 16 == 0 and data 16-byte aligned. Returns a cudaError_t.
extern "C" int skyt_blockpack_encode(const void* data, void* tags, void* offsets, void* literals, void* n_lit,
                                     long long n, int bb, int rows, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_blocks = (int)(n / bb);
  dim3 grid((unsigned)((n_blocks + kWarps - 1) / kWarps), (unsigned)rows);
  classify_kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (uint8_t*)tags, n, bb, n_blocks, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<rows, kScanThreads, 0, st>>>((const uint8_t*)tags, (int32_t*)offsets, (int32_t*)n_lit, bb, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  copy_kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (const uint8_t*)tags, (const int32_t*)offsets,
                                         (const int32_t*)n_lit, (uint8_t*)literals, n, bb, n_blocks);
  return (int)cudaGetLastError();
}
