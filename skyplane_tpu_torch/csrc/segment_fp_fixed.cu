// K-D segment_fp_fixed: 8-lane mod-(2^31-1) polynomial fingerprints of the
// FIXED-stride segments of a [B, n] uint8 batch, -> [B, n/seg, 8] canonical
// lanes: lane l of segment s is sum_i b_i * r_l^min(seg-1-i, max_seg-1).
//
// Replaces the Pallas kernel skyplane_tpu/ops/pallas_kernels.py
// (_segment_fp_kernel / segment_fp_fixed_pallas) and the XLA scatter-add path
// it falls back to (skyplane_tpu/ops/fingerprint.py fixed_stride_lanes ->
// segment_fingerprint_device). The Pallas kernel's domain (seg <= 2^16, and
// <= 8192 or a multiple of it) comes from Mosaic's tiling; this kernel takes
// every seg that divides n, up to 2^24 (where the reference's u32 limb sums
// would wrap). Power indices past max_seg - 1 are clamped, as JAX's gather
// clamps them on the XLA path.
//
// What bounds it on the H100: integer work, one 32 x 32 -> 64-bit
// multiply-add per nonzero byte and lane. Fixed strides need no search over
// segment ends and no atomics between segments: a block knows its (row,
// segment, column range) from its index. Each thread takes 16 bytes per step
// (one 16-byte load), skips them when all are zero, and reads the 16 powers
// of its columns per lane as four 16-byte loads: r^(seg-1-c) for c in
// [c0, c0+16) is a contiguous, aligned run of the power table, reversed, and
// every segment shares it, so it stays in L2. Sums stay in u64 registers
// (terms < 2^39, at most 2^16 of them per thread) and are folded once per
// thread, reduced across the block with warp shuffles, and added as one
// folded value per (segment, lane) into a u64 accumulator. Only when the
// batch has too few segments to fill the card is a segment split over
// several blocks; integer sums are associative, so the result does not
// depend on block order. A second pass folds to canonical u32.
#include <cstdint>
#include <cuda_runtime.h>

#include "u32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                    // bytes per thread per step
constexpr int kStep = kThreads * kVec;      // 4 KiB of columns per block step
constexpr int kLanes = 8;
constexpr int kWarps = kThreads / 32;

__global__ void segment_fp_fixed_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ powers,
                                        unsigned long long* __restrict__ acc, long long n, long long seg,
                                        int n_seg, int splits, long long cols_per_split, int max_seg, int vec) {
  __shared__ unsigned long long s_part[kWarps][kLanes];
  const int row = blockIdx.y;
  const int s = (int)(blockIdx.x / (unsigned)splits);
  const long long c_begin = (long long)(blockIdx.x % (unsigned)splits) * cols_per_split;
  const long long c_end = c_begin + cols_per_split < seg ? c_begin + cols_per_split : seg;
  const uint8_t* base = data + (long long)row * n + (long long)s * seg;

  unsigned long long sum[kLanes];
#pragma unroll
  for (int li = 0; li < kLanes; ++li) sum[li] = 0;

  if (vec) {  // seg % 16 == 0, n % 16 == 0, 16-byte aligned data, cols_per_split % kStep == 0
    for (long long c = c_begin + (long long)threadIdx.x * kVec; c < c_end; c += kStep) {
      const uint4 v = *reinterpret_cast<const uint4*>(base + c);
      if ((v.x | v.y | v.z | v.w) == 0) continue;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      const long long top = seg - 1 - c;  // power index of byte c; byte c + k takes top - k
      if (top <= max_seg - 1) {
        // indices top-15 .. top: 16 consecutive entries starting at a multiple of 16
#pragma unroll
        for (int li = 0; li < kLanes; ++li) {
          const uint4* p = reinterpret_cast<const uint4*>(powers + (long long)li * max_seg + (top - 15));
          const uint4 p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
          const uint32_t pw[16] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                                   p2.x, p2.y, p2.z, p2.w, p3.x, p3.y, p3.z, p3.w};
          unsigned long long acc_l = sum[li];
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
            acc_l += (unsigned long long)b * pw[15 - k];
          }
          sum[li] = acc_l;
        }
      } else {  // the clamped head of a segment longer than max_seg
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
          long long idx = top - k;
          if (idx > max_seg - 1) idx = max_seg - 1;
#pragma unroll
          for (int li = 0; li < kLanes; ++li) sum[li] += (unsigned long long)b * powers[(long long)li * max_seg + idx];
        }
      }
    }
  } else {  // any seg and n: one byte per thread per step, coalesced across the warp
    for (long long c = c_begin + threadIdx.x; c < c_end; c += kThreads) {
      const uint32_t b = base[c];
      if (b == 0) continue;
      long long idx = seg - 1 - c;
      if (idx > max_seg - 1) idx = max_seg - 1;
#pragma unroll
      for (int li = 0; li < kLanes; ++li) sum[li] += (unsigned long long)b * powers[(long long)li * max_seg + idx];
    }
  }

  // fold per thread (< 2^31), then sum the block: < 2^31 * 256 = 2^39
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int li = 0; li < kLanes; ++li) {
    unsigned long long x = fold31(sum[li]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, off);
    if (lane_id == 0) s_part[warp][li] = x;
  }
  __syncthreads();
  if (threadIdx.x < kLanes) {
    unsigned long long total = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) total += s_part[wi][threadIdx.x];
    if (total != 0)
      atomicAdd(&acc[((long long)row * n_seg + s) * kLanes + threadIdx.x], (unsigned long long)fold31(total));
  }
}

__global__ void segment_fp_fixed_finalize_kernel(const unsigned long long* __restrict__ acc,
                                                 int32_t* __restrict__ out, long long count) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < count) out[k] = (int32_t)fold31(acc[k]);
}

}  // namespace

// data [rows, n] u8, seg divides n, seg <= 2^24; powers [8, max_seg] u32;
// acc [rows, n/seg, 8] u64 scratch; out [rows, n/seg, 8] i32 (values < M31).
// splits * cols_per_split >= seg; vec as the kernel states. Returns a
// cudaError_t.
extern "C" int skyt_segment_fp_fixed(const void* data, const void* powers, void* acc, void* out, long long n,
                                     long long seg, int rows, int splits, long long cols_per_split, int max_seg,
                                     int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_seg = (int)(n / seg);
  const long long count = (long long)rows * n_seg * kLanes;
  err = cudaMemsetAsync(acc, 0, (size_t)count * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)n_seg * splits), (unsigned)rows);
  segment_fp_fixed_kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (const uint32_t*)powers,
                                                     (unsigned long long*)acc, n, seg, n_seg, splits, cols_per_split,
                                                     max_seg, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned fin_blocks = (unsigned)((count + 255) / 256);
  segment_fp_fixed_finalize_kernel<<<fin_blocks, 256, 0, st>>>((const unsigned long long*)acc, (int32_t*)out, count);
  return (int)cudaGetLastError();
}
