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
// What bounds it on the H100: the bytes it reads. The word path (seg a
// multiple of 64, 16-byte aligned data; every production stride) takes the
// 8 lanes of each 64-byte word from the tensor cores (lane_poly.cuh), so what
// is left on the CUDA cores is, per word and lane, a recombination, a fold,
// one power read r^(seg - (w0 mod seg) - 64) and a mulmod. No word crosses a
// segment, and since n % seg == 0, segment s of row r is the flat segment
// r * n/seg + s. One block per resident slot of the card takes a contiguous
// run of the flat batch, each warp a contiguous share of it, 1 KiB per pass,
// so a warp's words change segment once per seg / 1 KiB passes and sum in
// registers until then. Each warp keeps four passes in flight with cp.async
// in a ring of its own in shared memory (each thread copies the 32 bytes it
// feeds to the mma) and reads the next pass's powers from word_powers (the
// power table laid out by word: every index here is a multiple of 64, so
// the rows it reads, 128 KiB in all, stay in cache) before this pass's
// product. A thread tracks its word's segment and offset by increments,
// with no division on the way. More than 2^18 bytes before its segment's
// end a word is wholly clamped (seg and 2^18 are multiples of 64) and adds
// its byte sum times r^(max_seg-1). All-zero groups are skipped. At a
// segment change a warp adds its sums into the block's shared accumulator
// with one warp reduction; the block adds one folded value per (segment,
// lane) into a u64 accumulator with an integer atomic, and segments outside
// the block's shared window (strides under the block's span) go straight to
// the device accumulator. Integer sums are associative, so block order
// changes nothing; a second pass folds to canonical u32.
//
// Other strides (not a multiple of 64, or unaligned data) keep the byte path:
// one byte per thread per step, coalesced across the warp, a block per
// (segment, split), 8 multiply-adds with a table read per nonzero byte.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_poly.cuh"
#include "u32.cuh"

namespace {

using namespace lane_poly;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSinkSlots = 64;                   // segments in a block's shared window
constexpr long long kMaxGroupsPerBlock = 1 << 19;  // 2^16 per warp: running sums stay below 2^49

constexpr int kStages = 4;  // 1 KiB groups in flight per warp

// Warp-wide: start copying group grp of the flat batch into a ring stage,
// lane l taking bytes 16l and 512 + 16l (the ones it feeds to the mma, so no
// thread reads another's copy); bytes past the batch read as zero. One
// cp.async group, empty past the block's run.
__device__ __forceinline__ void stage_group(uint4* stage, const uint8_t* __restrict__ data, long long grp,
                                            long long g1, long long total) {
  const int lane = threadIdx.x & 31;
  if (grp < g1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long off = grp * kGroupBytes + h * (kGroupBytes / 2) + 16 * lane;
      if (off < total) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(&stage[h * 32 + lane]);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(data + off));
      } else {
        stage[h * 32 + lane] = make_uint4(0, 0, 0, 0);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads) segment_fp_fixed_words_kernel(
    const uint8_t* __restrict__ data, const uint8_t* __restrict__ limbs, const uint32_t* __restrict__ wpow,
    unsigned long long* __restrict__ acc, long long total, long long seg, long long n_groups,
    long long groups_per_block) {
  __shared__ uint4 s_ring[kWarps][kStages][kGroupBytes / 16];
  __shared__ uint32_t s_acc[kSinkSlots * kLanes * 2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g0 = (long long)blockIdx.x * groups_per_block;
  const long long g1 = g0 + groups_per_block < n_groups ? g0 + groups_per_block : n_groups;
  uint4(*ring)[kGroupBytes / 16] = s_ring[warp];
  // each warp takes a contiguous share of the block's groups, so its words stay in one segment for seg / 1 KiB passes
  const long long per_warp = groups_per_block / kWarps;
  const long long wg0 = g0 + warp * per_warp;
  const long long wg1 = wg0 + per_warp < g1 ? wg0 + per_warp : g1;
#pragma unroll
  for (int st = 0; st < kStages; ++st) stage_group(ring[st], data, wg0 + st, wg1, total);
  for (int i = threadIdx.x; i < kSinkSlots * kLanes * 2; i += kThreads) s_acc[i] = 0;
  uint32_t b[16];
  load_limbs(limbs, b);
  const Sink sink{s_acc, g0 * kGroupBytes / seg, kSinkSlots, acc};
  __syncthreads();

  // the owned word of this warp's group: its offset, its segment, its offset in the segment
  long long w0 = wg0 * kGroupBytes + owned_word() * kWordBytes;
  long long slot = w0 / seg;
  unsigned off = (unsigned)(w0 - slot * seg);
  // a word's powers: r^(seg - o - 64), a multiple of 64, within kMaxSeg of its segment's end; r^(kMaxSeg-1) before
  auto power_at = [&](unsigned o) {
    const long long rem = seg - o;
    return lane_power(wpow, rem > kMaxSeg ? kMaxSeg - 1 : (int)(rem - kWordBytes));
  };
  uint4 pcur = wg0 < wg1 && w0 < total ? power_at(off) : make_uint4(0, 0, 0, 0);
  Run run;
  int st = 0;
  for (long long grp = wg0; grp < wg1; ++grp) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    const uint4 lo = ring[st][lane];
    const uint4 hi = ring[st][32 + lane];
    // the next group's word and its powers, read now so they land while this group computes
    const long long w1 = w0 + kGroupBytes;
    long long slot1 = slot;
    unsigned off1 = off + kGroupBytes;
    if (off1 >= seg) {
      const unsigned q = off1 / (unsigned)seg;
      slot1 += q;
      off1 -= q * (unsigned)seg;
    }
    const uint4 pnxt =
        grp + 1 < wg1 && w1 < total ? power_at(off1) : make_uint4(0, 0, 0, 0);
    if (__any_sync(kWarpAll, any_nonzero(lo) || any_nonzero(hi))) {
      const bool valid = w0 < total;
      const bool clamped = seg - off > kMaxSeg;  // then every byte takes r^(kMaxSeg-1)
      uint32_t w[4];
      word_values(lo, hi, b, w);
      if (__any_sync(kWarpAll, valid && clamped)) {
        const uint32_t s = word_bytesum(lo, hi);
        if (clamped) {
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = s;
        }
      }
      unsigned long long v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (valid && w[j] != 0) ? mul_lazy31(w[j], lane_part(pcur, j)) : 0ull;
      run.add(sink, valid, slot, v);
    }
    stage_group(ring[st], data, grp + kStages, wg1, total);  // this stage is read
    st = st + 1 == kStages ? 0 : st + 1;
    w0 = w1;
    slot = slot1;
    off = off1;
    pcur = pnxt;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  run.flush(sink);
  __syncthreads();
  sink.drain((total + seg - 1) / seg);
}

__global__ void segment_fp_fixed_bytes_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ powers,
                                              unsigned long long* __restrict__ acc, long long n, long long seg,
                                              int n_seg, int splits, long long cols_per_split) {
  __shared__ unsigned long long s_part[kWarps][kLanes];
  const int row = blockIdx.y;
  const int s = (int)(blockIdx.x / (unsigned)splits);
  const long long c_begin = (long long)(blockIdx.x % (unsigned)splits) * cols_per_split;
  const long long c_end = c_begin + cols_per_split < seg ? c_begin + cols_per_split : seg;
  const uint8_t* base = data + (long long)row * n + (long long)s * seg;

  unsigned long long sum[kLanes];
#pragma unroll
  for (int li = 0; li < kLanes; ++li) sum[li] = 0;
  for (long long c = c_begin + threadIdx.x; c < c_end; c += kThreads) {
    const uint32_t bt = base[c];
    if (bt == 0) continue;
    long long idx = seg - 1 - c;
    if (idx > kMaxSeg - 1) idx = kMaxSeg - 1;
#pragma unroll
    for (int li = 0; li < kLanes; ++li) sum[li] += (unsigned long long)bt * powers[(long long)li * kMaxSeg + idx];
  }

  // fold per thread (< 2^31), then sum the block: < 2^31 * 256 = 2^39
  const int lane_id = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int li = 0; li < kLanes; ++li) {
    unsigned long long x = fold31(sum[li]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kWarpAll, x, off);
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

// data [rows, n] u8, seg divides n, seg <= 2^24; powers [8, max_seg] u32
// (max_seg == 2^18); limbs [64, 32] u8 (word_limbs); wpow [64, max_seg / 64,
// 8] u32 (word_powers, the same powers by word); acc [rows, n/seg, 8]
// u64 scratch; out [rows, n/seg, 8] i32 (values < M31). words != 0: the word
// path (seg % 64 == 0, data 16-byte aligned), one block per resident slot of
// the card, each over a contiguous run of the flat batch. Else the byte path,
// with splits * cols_per_split >= seg. Returns a cudaError_t.
extern "C" int skyt_segment_fp_fixed(const void* data, const void* powers, const void* limbs, const void* wpow,
                                     void* acc, void* out,
                                     long long n, long long seg, int rows, int splits, long long cols_per_split,
                                     int max_seg, int words, int device, void* stream) {
  if (max_seg != kMaxSeg) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_seg = (int)(n / seg);
  const long long count = (long long)rows * n_seg * kLanes;
  err = cudaMemsetAsync(acc, 0, (size_t)count * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (words) {
    long long target = 0;
    err = resident_blocks(segment_fp_fixed_words_kernel, kThreads, device, &target);
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)rows * n;
    const long long n_groups = (total + kGroupBytes - 1) / kGroupBytes;
    long long per_block = (n_groups + target - 1) / target;
    per_block = (per_block + kWarps - 1) / kWarps * kWarps;  // whole passes of the block's warps
    if (per_block > kMaxGroupsPerBlock) per_block = kMaxGroupsPerBlock;
    const long long blocks = (n_groups + per_block - 1) / per_block;
    segment_fp_fixed_words_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const uint8_t*)data, (const uint8_t*)limbs, (const uint32_t*)wpow, (unsigned long long*)acc, total, seg,
        n_groups, per_block);
  } else {
    dim3 grid((unsigned)((long long)n_seg * splits), (unsigned)rows);
    segment_fp_fixed_bytes_kernel<<<grid, kThreads, 0, st>>>((const uint8_t*)data, (const uint32_t*)powers,
                                                             (unsigned long long*)acc, n, seg, n_seg, splits,
                                                             cols_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned fin_blocks = (unsigned)((count + 255) / 256);
  segment_fp_fixed_finalize_kernel<<<fin_blocks, 256, 0, st>>>((const unsigned long long*)acc, (int32_t*)out, count);
  return (int)cudaGetLastError();
}
