// K-C segment_fp: 8-lane mod-(2^31-1) polynomial fingerprints of the
// variable-length CDC segments of a padded [B, bucket] uint8 batch,
// -> [B, n_slots, 8] canonical lanes.
//
// Replaces call B, skyplane_tpu/ops/fused_cdc.py _fp_body / _fp_impl and
// skyplane_tpu/ops/fingerprint.py segment_fingerprint_cumsum (XLA: per lane a
// gather of powers, a limb-split mulmod, a cumsum and two gathers over the
// whole batch).
//
// What bounds it on the H100: the bytes it reads. The lanes of each 64-byte
// word come from the tensor cores (lane_poly.cuh): per word and lane the CUDA
// cores do a recombination, a fold, one power read and a mulmod, not 64
// multiply-adds with 64 table reads. The design: one block per resident slot
// of the card (3 an SM), each walking 16 KiB tiles of the batch with the next
// tile's cp.async copy in flight. Per tile, 256 evenly spaced samples of the
// row's ascending ends place a chunk of 256 ends in shared memory that holds
// the tile's first segment j0; each thread then classifies one word by the
// first end c past its first byte w0 (a binary search in that chunk):
// - whole: c >= w0 + 64. Unclamped (c - w0 <= max_seg) it adds
//   W * r^(c - w0 - 64); wholly clamped (c - w0 - 64 >= max_seg - 1, the head
//   of a segment longer than 2^18) its byte sum * r^(max_seg - 1).
// - split: the word holds exactly one end c = w0 + m (0 < m < 64; about one
//   word a segment). A second product W' of the word with its first m bytes
//   zeroed gives both pieces: W' * r^(c2 - w0 - 64) to the next slot (end c2)
//   and (W - W') * r^-(64 - m) to this one (inverse_powers).
// - special: two or more ends inside the word, or the clamp begins inside it
//   (adversarial rows and garbage segments past 2^18). A warp takes such a
//   word, one byte a thread in two passes: each nonzero byte b at i adds
//   b * r^min(c_j - 1 - i, max_seg - 1) to the segment j it lies in (the
//   first end past i), and the warp sums the bytes of each segment with
//   __reduce_add_sync, the products split at bit 16 so that each 32-bit sum
//   is exact. A warp issues the table reads of its first special word before
//   its whole words and sums them after.
// - past the last end: nothing.
// Powers come from word_powers, the power table laid out by word (a word's
// eight lanes in one 32-byte row, consecutive words in consecutive rows). In
// the mma pass each warp takes two 1 KiB groups and keeps running sums while
// its words stay in one segment; sums go into a shared accumulator for the
// tile's first 32 segments (warp reductions, then 32-bit shared atomics) and,
// past those, straight into the device accumulator, and the block adds one
// folded value per (row, slot, lane) into a u64 accumulator with an integer
// atomic. Integer sums are associative, so the result does not depend on
// block order; a second pass folds the accumulators to canonical u32.
// All-zero groups (zero pages, padding) skip the product.
//
// Contract on ends (what FusedCDCFP builds): ascending real ends, then one
// `bucket` end for the zero padding when the chunk is shorter than the
// bucket, then `bucket` sentinels. Slot j spans [min(c_{j-1}, c_j), c_j) with
// c = clip(ends, 0, bucket); byte i of slot j uses power index
// min(c_j - 1 - i, max_seg - 1), exactly as _fp_body computes rev_pos.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_poly.cuh"
#include "u32.cuh"

namespace {

using namespace lane_poly;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;  // measured faster than 32 KiB tiles
constexpr int kTileWords = kTileBytes / kWordBytes;  // 256: one per thread
constexpr int kGroupsPerWarp = kTileBytes / kGroupBytes / kWarps;
constexpr int kSinkSlots = 32;
constexpr int kEndChunk = 256;
constexpr int kMinBlocks = 3;  // 80 registers a thread: 3 blocks an SM measured faster than 2 or 4

enum : uint8_t { kSkip = 0, kWhole = 1, kClamped = 2, kSplit = 3, kSpecial = 4 };

__device__ __forceinline__ int clip_end(int e, long long bucket) {
  return e < 0 ? 0 : (e > bucket ? (int)bucket : e);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Block-wide: start copying tile `tile` (row-major over rows x tiles_per_row)
// into buf; bytes past the bucket read as zero. One cp.async group.
__device__ __forceinline__ void stage_tile(uint4* buf, const uint8_t* __restrict__ data, long long tile,
                                           long long n_tiles, long long tiles_per_row, long long bucket) {
  if (tile < n_tiles) {
    const long long row = tile / tiles_per_row;
    const long long t0 = (tile - row * tiles_per_row) * kTileBytes;
    const uint8_t* src = data + row * bucket + t0;
    for (int i = threadIdx.x; i < kTileBytes / 16; i += kThreads) {
      if (t0 + 16LL * i < bucket)
        cp_async16(&buf[i], src + 16LL * i);
      else
        buf[i] = make_uint4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Block-wide: a start for the chunk of kEndChunk ends that holds the first
// slot past x, the number j0 of slots with clip(e[j]) <= x (ends ascending):
// 256 evenly spaced samples at a time narrow [lo, lo + len] around j0 until
// fewer than kEndChunk candidates are left (one round up to 65536 slots).
__device__ int chunk_start(const int32_t* __restrict__ e, int n_slots, long long x, long long bucket) {
  int lo = 0, len = n_slots;  // j0 lies in [lo, lo + len]
  while (len >= kEndChunk) {
    const int stride = (len + kThreads - 1) / kThreads;
    const long long off = (long long)threadIdx.x * stride;
    const int c = __syncthreads_count(off < len && clip_end(e[lo + off], bucket) <= x);
    if (c == 0) break;
    lo += (c - 1) * stride + 1;
    len = min(stride - 1, len - ((c - 1) * stride + 1));
  }
  return lo;
}

// One block per resident slot of the card; each walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., the next tile's copy in flight while it works
// on this one.
__global__ void __launch_bounds__(kThreads, kMinBlocks) segment_fp_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ ends, const uint8_t* __restrict__ limbs,
    const uint32_t* __restrict__ wpow, const uint32_t* __restrict__ ipow, unsigned long long* __restrict__ acc,
    long long bucket, int n_slots, long long tiles_per_row, long long n_tiles) {
  __shared__ uint4 s_tile[2][kTileBytes / 16];
  __shared__ int s_end[kEndChunk];
  __shared__ int s_slot[kTileWords];  // slot of the word's first byte
  __shared__ int s_pidx[kTileWords];  // power index of a whole word (of a split word's second piece)
  __shared__ uint8_t s_kind[kTileWords];
  __shared__ uint8_t s_split[kTileWords];  // where a split word's end lies, else 0
  __shared__ short s_special[kTileWords];
  __shared__ int s_n_special;
  __shared__ int s_j0;
  __shared__ uint32_t s_acc[kSinkSlots * kLanes * 2];

  uint32_t b[16];
  load_limbs(limbs, b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  stage_tile(s_tile[0], data, blockIdx.x, n_tiles, tiles_per_row, bucket);

  int buf = 0;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const long long row = tile / tiles_per_row;
    const long long t0 = (tile - row * tiles_per_row) * kTileBytes;
    const int32_t* e = ends + row * n_slots;
    for (int i = threadIdx.x; i < kSinkSlots * kLanes * 2; i += kThreads) s_acc[i] = 0;
    if (threadIdx.x == 0) s_n_special = 0;
    stage_tile(s_tile[buf ^ 1], data, tile + gridDim.x, n_tiles, tiles_per_row, bucket);

    // each word's slot: the first end past its first byte, found by a binary
    // search in a chunk of 256 ends in shared memory that holds the tile's
    // first slot (and, unless the tile holds more ends, all the others)
    int base = chunk_start(e, n_slots, t0, bucket);
    const long long w0 = t0 + (long long)threadIdx.x * kWordBytes;  // this thread's word
    int fs = -1;
    long long cf = 0, cf2 = -1;  // the ends of slots fs and fs + 1 (-1: not read yet)
    for (;; base += kEndChunk) {
      __syncthreads();
      s_end[threadIdx.x] = base + threadIdx.x < n_slots ? clip_end(e[base + threadIdx.x], bucket) : INT_MAX;
      __syncthreads();
      if (fs < 0) {
        int lo = 0, hi = kEndChunk;  // first index with s_end > w0
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_end[mid] <= w0) lo = mid + 1; else hi = mid;
        }
        if (lo < kEndChunk) {
          fs = base + lo;
          cf = s_end[lo];
          if (lo + 1 < kEndChunk) cf2 = s_end[lo + 1];
        }
      }
      if (s_end[kEndChunk - 1] > t0 + (kTileWords - 1) * kWordBytes || base + kEndChunk >= n_slots) break;
    }
    if (threadIdx.x == 0) s_j0 = fs;  // word 0 starts at t0: its slot is the tile's first
    uint8_t kind = kSkip;
    int pidx = 0, split = 0;
    if (w0 < bucket && fs >= 0 && fs < n_slots) {
      const long long rem = cf - w0;  // > 0
      if (rem < kWordBytes) {  // an end inside the word: split when it is the only one
        if (cf2 < 0) cf2 = fs + 1 < n_slots ? clip_end(e[fs + 1], bucket) : -1;
        const long long rem2 = cf2 - w0;
        if (fs + 1 < n_slots && rem2 >= kWordBytes && rem2 <= kMaxSeg) {
          kind = kSplit;
          split = (int)rem;
          pidx = (int)(rem2 - kWordBytes);
        } else {
          kind = kSpecial;
        }
      } else if (rem <= kMaxSeg) {
        kind = kWhole;
        pidx = (int)(rem - kWordBytes);
      } else if (rem - kWordBytes >= kMaxSeg - 1) {
        kind = kClamped;
        pidx = kMaxSeg - 1;
      } else {
        kind = kSpecial;  // the clamp begins inside the word
      }
    }
    s_kind[threadIdx.x] = kind;
    s_split[threadIdx.x] = (uint8_t)split;
    s_slot[threadIdx.x] = fs;
    s_pidx[threadIdx.x] = pidx;
    if (kind == kSpecial) s_special[atomicAdd(&s_n_special, 1)] = (short)threadIdx.x;
    asm volatile("cp.async.wait_group 1;\n" ::);  // this tile landed; the next may still be in flight
    __syncthreads();

    const long long slot_base = row * n_slots;
    const Sink sink{s_acc, slot_base + s_j0, kSinkSlots, acc};
    const uint4* tile_v = s_tile[buf];
    const uint8_t* tile_b = reinterpret_cast<const uint8_t*>(tile_v);
    const int n_special = s_n_special;

    // special words: a warp each, one byte a thread in two passes (bytes k and
    // k + 32). load() finds each byte's slot (ends from the chunk in shared
    // memory where it holds them) and issues its sixteen table reads; sum()
    // adds the bytes of each slot with one warp sum per slot. A warp's first
    // special word is loaded before its whole words and summed after them,
    // so the table reads land while the tensor cores work.
    struct Special {
      int jb[2];
      uint32_t bt[2], pv[2][kLanes];
    } sp;
    auto end_at = [&](int j) {
      return (unsigned)(j - base) < kEndChunk ? (long long)s_end[j - base] : (long long)clip_end(e[j], bucket);
    };
    auto load = [&](int task) {
      const int wi = s_special[task];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        const long long i = t0 + (long long)wi * kWordBytes + k;
        sp.bt[h] = tile_b[wi * kWordBytes + k];
        int j = s_slot[wi];  // the slot of the word's first byte; move past the ends at or before i
        long long c = end_at(j);
        while (c <= i && ++j < n_slots) c = end_at(j);
        if (j >= n_slots) sp.bt[h] = 0;
        sp.jb[h] = j;
        const long long idx = sp.bt[h] ? min(c - 1 - i, (long long)kMaxSeg - 1) : 0;
        all_lane_powers(wpow, (int)idx, sp.pv[h]);
      }
    };
    auto sum = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool valid = sp.bt[h] != 0;
        unsigned pending = __ballot_sync(kWarpAll, valid);
        while (pending) {  // slots ascend with k
          const int s = __shfl_sync(kWarpAll, sp.jb[h], __ffs(pending) - 1);
          const bool mine = valid && sp.jb[h] == s;
          const uint32_t m = mine ? sp.bt[h] : 0u;
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {  // b * r split at bit 16: warp sums < 2^29 and < 2^28
            const uint32_t lo = __reduce_add_sync(kWarpAll, m * (sp.pv[h][l] & 0xFFFFu));
            const uint32_t hi = __reduce_add_sync(kWarpAll, m * (sp.pv[h][l] >> 16));
            if (lane == 0 && (lo | hi) != 0) sink.add(slot_base + s, l, lo + ((unsigned long long)hi << 16));
          }
          pending &= ~__ballot_sync(kWarpAll, mine);
        }
      }
    };
    if (warp < n_special) load(warp);

    // whole words: two 1 KiB groups per warp on the tensor cores; both
    // groups' powers are read first, so their latency overlaps
    {
      uint4 pwr[kGroupsPerWarp];
#pragma unroll
      for (int p = 0; p < kGroupsPerWarp; ++p) {
        const int wi = (warp * kGroupsPerWarp + p) * kGroupWords + owned_word();
        const bool want = s_kind[wi] == kWhole || s_kind[wi] == kClamped || s_kind[wi] == kSplit;
        pwr[p] = want ? lane_power(wpow, s_pidx[wi]) : make_uint4(0, 0, 0, 0);
      }
      Run run;
#pragma unroll
      for (int p = 0; p < kGroupsPerWarp; ++p) {
        const int grp = warp * kGroupsPerWarp + p;
        const uint4 lo = tile_v[(grp * kGroupBytes + g * kWordBytes + 16 * t) / 16];
        const uint4 hi = tile_v[(grp * kGroupBytes + (g + 8) * kWordBytes + 16 * t) / 16];
        if (!__any_sync(kWarpAll, any_nonzero(lo) || any_nonzero(hi))) continue;
        const int wi = grp * kGroupWords + owned_word();
        const uint8_t k = s_kind[wi];
        const bool valid = k == kWhole || k == kClamped || k == kSplit;
        uint32_t w[4];
        word_values(lo, hi, b, w);
        if (__any_sync(kWarpAll, k == kClamped)) {
          const uint32_t s = word_bytesum(lo, hi);
          if (k == kClamped) {
#pragma unroll
            for (int j = 0; j < 4; ++j) w[j] = s;
          }
        }
        unsigned long long v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = (valid && w[j] != 0) ? mul_lazy31(w[j], lane_part(pwr[p], j)) : 0ull;
        const long long slot = slot_base + s_slot[wi];
        if (__any_sync(kWarpAll, k == kSplit)) {
          // W' of each split word with the bytes before its end zeroed: the
          // second piece adds W' * r^(c2 - w0 - 64) to the next slot, the first
          // (W - W') * r^-(64 - m) to this one
          uint32_t w2[4];
          const int m_lo = s_split[grp * kGroupWords + g], m_hi = s_split[grp * kGroupWords + g + 8];
          word_values(zero_below(lo, m_lo, 16 * t), zero_below(hi, m_hi, 16 * t), b, w2);
          unsigned long long v2[4] = {0, 0, 0, 0};
          if (k == kSplit) {
            const uint4 inv = lane_row(ipow, kWordBytes - s_split[wi]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v2[j] = mul_lazy31(w2[j], lane_part(pwr[p], j));
              v[j] = mul_lazy31(fold31((uint64_t)w[j] + 2 * SKYT_M31 - w2[j]), lane_part(inv, j));
            }
          }
          warp_add(sink, k == kSplit, slot + 1, v2);
        }
        run.add(sink, valid, slot, v);
      }
      run.flush(sink);
    }

    if (warp < n_special) sum();
    for (int task = warp + kWarps; task < n_special; task += kWarps) {
      load(task);
      sum();
    }

    __syncthreads();
    sink.drain(slot_base + n_slots);
    __syncthreads();  // s_acc, the word tables and this buffer are reused
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__global__ void segment_fp_finalize_kernel(const unsigned long long* __restrict__ acc, int32_t* __restrict__ out,
                                           long long n) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = (int32_t)fold31(acc[k]);
}

}  // namespace

// data [rows, bucket] u8 (bucket % 4096 == 0, 16-byte aligned rows), ends
// [rows, n_slots] i32, limbs [64, 32] u8 (word_limbs), wpow [64, max_seg /
// 64, 8] u32 (word_powers; max_seg == 2^18), ipow [64, 8] u32
// (inverse_powers), acc [rows, n_slots, 8] u64
// scratch, out [rows, n_slots, 8] i32 (values < M31). Returns a cudaError_t.
extern "C" int skyt_segment_fp(const void* data, const void* ends, const void* limbs, const void* wpow,
                               const void* ipow, void* acc, void* out, long long bucket, int rows, int n_slots,
                               int max_seg, int device, void* stream) {
  if (max_seg != kMaxSeg) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n_out = (long long)rows * n_slots * kLanes;
  err = cudaMemsetAsync(acc, 0, (size_t)n_out * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  err = resident_blocks(segment_fp_kernel, kThreads, device, &blocks);
  if (err != cudaSuccess) return (int)err;
  const long long tiles_per_row = (bucket + kTileBytes - 1) / kTileBytes;
  const long long n_tiles = tiles_per_row * rows;
  if (blocks > n_tiles) blocks = n_tiles;
  segment_fp_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      (const uint8_t*)data, (const int32_t*)ends, (const uint8_t*)limbs, (const uint32_t*)wpow, (const uint32_t*)ipow,
      (unsigned long long*)acc, bucket, n_slots, tiles_per_row, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned fin_blocks = (unsigned)((n_out + 255) / 256);
  segment_fp_finalize_kernel<<<fin_blocks, 256, 0, st>>>((const unsigned long long*)acc, (int32_t*)out, n_out);
  return (int)cudaGetLastError();
}
