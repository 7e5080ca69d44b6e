// K-AB gear_compact: call A of the gateway sender path in one pass. Gear
// rolling hash, boundary-candidate test, and the ordered compaction of the
// candidate positions, over a padded [B, bucket] uint8 batch ->
// [B, cap+1] int32: the first `cap` candidate positions of each row in
// ascending order, padded with `bucket`, and the TRUE candidate count (even
// past cap) in column cap.
//
// Replaces the Pallas kernel skyplane_tpu/ops/pallas_kernels.py:29/:48
// (_windowed_sum_kernel / gear_windowed_sum_pallas) with the GEAR_TABLE
// gather and the top-bits test of skyplane_tpu/ops/gear.py around it, and the
// XLA compaction of skyplane_tpu/ops/fused_cdc.py:91 (_candidates_impl: a
// cumsum of the mask and a scatter-min of the positions).
//
// What bounds it on the H100: bytes. Each input byte is read once; what is
// written is the packed rows and one 8-byte status word per chunk. The
// design answers that bound with one pass, one table read per byte, and the
// compaction kept off the hashing warps' path:
//
// - The hash. h_t = (h_{t-1} << 1) + G[b_t] mod 2^32 forgets bytes more than
//   32 back. Each thread owns one 32-byte word and runs the local state from
//   zero, L_k = (L_{k-1} << 1) + G[b_k], so F = L_31 is exactly the hash at
//   its last byte, and the true hash at byte k of the word is
//   h_k = (F_prev << (k+1)) + L_k with F_prev the left neighbour word's F
//   (everything further back shifts out). F_prev comes from __shfl_up_sync;
//   lane 0 of each warp forms it from the 32 bytes in front of the warp, one
//   byte a lane: F = sum_j G[b_j] << (31 - j), a warp sum (zero at the start
//   of a row). No word re-reads its left halo, and no barrier is needed.
// - The table. The 256 gear values sit in shared memory once per bank: entry
//   b for lane l at byte (b << 8) | (l << 2), so every lane reads its own
//   bank and a warp's table read is one pass whatever the bytes (a single
//   1 KiB copy costs about 3.5 passes on random bytes). One byte permute
//   (PRMT) of the data word and the lane makes the address. Blocks are
//   persistent, so each fills the table once.
// - The test. Most words hold no candidate: a word's 32 hashes go through a
//   minimum, and only a warp where some word's minimum passes the top-bits
//   test forms the candidate bits.
// - The compaction. A block takes 256 KiB chunks of a row (32 sub-tiles of
//   8 KiB, the next sub-tile's loads in flight while one is hashed) in
//   row-major order from a global ticket, taken when it starts the chunk, so
//   every chunk's predecessors have started; 8 rows of 8 MiB are 256 chunks,
//   one wave of two blocks an SM. It keeps the chunk's candidate bits in
//   shared memory and counts them per (sub-tile, warp), then finds the
//   chunk's offset in its row by a decoupled look-back (Merrill & Garland,
//   "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016): it
//   publishes its count as an aggregate in a 64-bit status word (flag and
//   value in one word, relaxed: lookback.cuh), and warp 0 reads the 128
//   chunks in front of it at once (four a lane), summing aggregates back to
//   the nearest inclusive prefix; then it
//   publishes its own. Chunk 0 of a row publishes its inclusive prefix at
//   once. Each warp writes its positions at offset + its prefix while below
//   cap (a span whose first slot is past cap writes none); the row's last
//   chunk writes the true count and the `bucket` padding. The mask and the
//   counts never reach device memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "resident.cuh"

namespace {

constexpr int kThreads = 256;              // one 32-byte word per thread
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = kThreads * 32;  // 8 KiB per sub-tile
constexpr int kSub = 32;
constexpr int kChunkBytes = kSub * kTileBytes;  // 256 KiB (ops/kernels.py GEAR_CHUNK)
constexpr int kTableBytes = 256 * 256;
constexpr int kSmemBytes = kTableBytes + kSub * kThreads * 4;  // the table, then the chunk's candidate bits
constexpr int kCounts = kSub * kWarps;
constexpr int kPerLane = kCounts / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// a chunk's status word (lookback.cuh): flag in bits 32-33, candidate count in bits 0-31
static_assert(kCounts % 32 == 0, "warp 0 scans whole lanes of counts");

// G[byte k of w] from this lane's bank; lane4 = lane * 4
__device__ __forceinline__ uint32_t gear(const unsigned char* table, uint32_t w, int k, uint32_t lane4) {
  return *reinterpret_cast<const uint32_t*>(table + __byte_perm(w, lane4, 0x5504u | (k << 4)));
}

struct Word {
  uint4 lo, hi;   // the thread's 32 bytes
  uint32_t halo;  // byte `lane` of the 32 in front of the warp
};

// a ticket's chunk: row, index in the row, first byte, sub-tiles (0: no chunk)
struct Chunk {
  long long row, index, start;
  int n_sub;
};

__device__ __forceinline__ Chunk chunk_of(long long t, long long n_chunks, long long total_chunks, long long bucket) {
  if (t >= total_chunks) return Chunk{0, 0, 0, 0};
  const long long row = t / n_chunks, index = t - row * n_chunks, start = index * kChunkBytes;
  const long long rest = (bucket - start) / kTileBytes;  // the row's last chunk may be short
  return Chunk{row, index, start, rest < kSub ? (int)rest : kSub};
}

// this thread's word of sub-tile j of chunk c, and its warp's halo byte
__device__ __forceinline__ Word fetch(const uint8_t* data, const Chunk& c, int j, long long bucket, int tid,
                                      int lane) {
  Word x{};
  if (j < c.n_sub) {
    const uint8_t* row_data = data + c.row * bucket;
    const long long pos0 = c.start + (long long)j * kTileBytes + tid * 32;
    const uint4* p = reinterpret_cast<const uint4*>(row_data + pos0);
    x.lo = p[0];
    x.hi = p[1];
    x.halo = pos0 - lane * 32 > 0 ? row_data[pos0 - lane * 32 - 32 + lane] : 0u;
  }
  return x;
}

// the candidate bits of one word: bit k set where the hash at its byte k has
// its top mask_bits zero (h < below)
__device__ __forceinline__ uint32_t word_bits(const Word& x, const unsigned char* table, uint32_t lane4, int lane,
                                              bool has_halo, uint32_t below) {
  const uint32_t w[8] = {x.lo.x, x.lo.y, x.lo.z, x.lo.w, x.hi.x, x.hi.y, x.hi.z, x.hi.w};
  uint32_t L[32];
  uint32_t h = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    h = (h << 1) + gear(table, w[k >> 2], k & 3, lane4);
    L[k] = h;
  }
  const uint32_t halo = __reduce_add_sync(kFull, has_halo ? gear(table, x.halo, 0, lane4) << (31 - lane) : 0u);
  uint32_t f_prev = __shfl_up_sync(kFull, L[31], 1);
  if (lane == 0) f_prev = halo;
#pragma unroll
  for (int k = 0; k < 31; ++k) L[k] += f_prev << (k + 1);  // now the true hashes
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = min(L[2 * i], L[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = min(m[i], m[i + 8]);
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = min(m[i], m[i + 4]);
  if (!__any_sync(kFull, min(min(m[0], m[1]), min(m[2], m[3])) < below)) return 0;
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) bits |= (uint32_t)(L[k] < below) << k;
  return bits;
}

__global__ void __launch_bounds__(kThreads, 2) gear_compact_kernel(
    const uint8_t* __restrict__ data, const int32_t* __restrict__ lens, const uint32_t* __restrict__ gear_table,
    int32_t* __restrict__ out, unsigned long long* __restrict__ ticket, unsigned long long* __restrict__ status,
    long long bucket, long long n_chunks, long long total_chunks, int mask_bits, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* table = smem;                                         // kTableBytes
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(smem + kTableBytes);  // [kSub][kThreads]
  __shared__ int s_count[kCounts];  // each (sub-tile, warp)'s candidate count
  __shared__ int s_pre[kCounts];    // and its exclusive prefix in the chunk
  __shared__ long long s_offset;    // the chunk's exclusive offset in its row
  __shared__ unsigned s_agg;        // the chunk's count
  __shared__ long long s_tile;      // the block's next ticket

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 256 * 8; i += kThreads) {  // entry b, lanes 4q..4q+3
    const uint32_t g = gear_table[i >> 3];
    *reinterpret_cast<uint4*>(table + (i >> 3) * 256 + (i & 7) * 16) = make_uint4(g, g, g, g);
  }
  if (tid == 0) s_tile = (long long)atomicAdd(ticket, 1ull);
  __syncthreads();

  const uint32_t lane4 = lane * 4;
  const uint32_t below = 1u << (32 - mask_bits);  // a candidate: h < 2^(32 - mask_bits)
  Chunk cur = chunk_of(s_tile, n_chunks, total_chunks, bucket);
  Word next = fetch(data, cur, 0, bucket, tid, lane);

  while (cur.n_sub > 0) {
    const long long n = lens[cur.row];
#pragma unroll 1
    for (int j = 0; j < cur.n_sub; ++j) {
      const Word x = next;
      next = fetch(data, cur, j + 1, bucket, tid, lane);
      const long long pos0 = cur.start + (long long)j * kTileBytes + tid * 32;
      uint32_t bits = word_bits(x, table, lane4, lane, pos0 - lane * 32 > 0, below);
      const long long lim = n - pos0;  // positions below n
      if (lim < 32) bits &= lim <= 0 ? 0u : (1u << lim) - 1u;
      s_bits[j * kThreads + tid] = bits;
      const unsigned c = __reduce_add_sync(kFull, __popc(bits));
      if (lane == 0) s_count[j * kWarps + warp] = (int)c;
    }
    __syncthreads();

    if (warp == 0) {  // the prefixes of the (sub-tile, warp) counts, the offset, the next ticket
      int v[kPerLane], local = 0;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int idx = lane * kPerLane + e;
        v[e] = idx < cur.n_sub * kWarps ? s_count[idx] : 0;
        local += v[e];
      }
      int incl = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      const unsigned agg = (unsigned)__shfl_sync(kFull, incl, 31);
      int run = incl - local;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        s_pre[lane * kPerLane + e] = run;
        run += v[e];
      }
      unsigned long long* row_status = status + cur.row * n_chunks;
      long long excl = 0;
      if (cur.index == 0) {
        if (lane == 0) store_relaxed(row_status, kInclusive | agg);
      } else {
        if (lane == 0) store_relaxed(row_status + cur.index, kAggregate | agg);
        excl = look_back(row_status, cur.index, agg, lane);
      }
      if (lane == 0) {
        s_offset = excl;
        s_agg = agg;
        s_tile = (long long)atomicAdd(ticket, 1ull);
      }
    }
    __syncthreads();  // s_pre, s_offset, s_agg and s_tile are set
    const Chunk done = cur;
    cur = chunk_of(s_tile, n_chunks, total_chunks, bucket);
    next = fetch(data, cur, 0, bucket, tid, lane);  // in flight during the writes

    const long long offset = s_offset;
    int32_t* row_out = out + done.row * (cap + 1);
    if (offset < cap) {
#pragma unroll 1
      for (int j = 0; j < done.n_sub; ++j) {
        const long long first = offset + s_pre[j * kWarps + warp];
        if (s_count[j * kWarps + warp] == 0 || first >= cap) continue;  // warp-uniform
        uint32_t bits = s_bits[j * kThreads + tid];
        const int c = __popc(bits);
        int incl = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int u = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += u;
        }
        const long long pos0 = done.start + (long long)j * kTileBytes + tid * 32;
        for (long long slot = first + incl - c; bits != 0 && slot < cap; ++slot) {
          const int k = __ffs(bits) - 1;
          bits &= bits - 1;
          row_out[slot] = (int32_t)(pos0 + k);
        }
      }
    }
    if (done.index == n_chunks - 1) {  // the row's last chunk: the true count and the padding
      const long long total = offset + s_agg;
      for (long long i = (total < cap ? total : cap) + tid; i < cap; i += kThreads) row_out[i] = (int32_t)bucket;
      if (tid == 0) row_out[cap] = (int32_t)total;
    }
  }
}

}  // namespace

// data [rows, bucket] u8 (16-byte aligned rows, bucket % 8192 == 0), lens
// [rows] i32, gear_table [256] u32, out [rows, cap+1] i32, scratch
// [scratch_words] u64: the ticket, then one status word per 256 KiB chunk of
// each row (ops/kernels.py GEAR_CHUNK), zeroed here on the stream. Returns a
// cudaError_t.
extern "C" int skyt_gear_compact(const void* data, const void* lens, const void* gear_table, void* out,
                                 void* scratch, long long scratch_words, long long bucket, int rows, int mask_bits,
                                 int cap, int device, void* stream) {
  const long long n_chunks = (bucket + kChunkBytes - 1) / kChunkBytes;
  const long long total = n_chunks * rows;
  if (bucket <= 0 || bucket % kTileBytes || scratch_words < total + 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[64] = {};
  if (device < 0 || device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(gear_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(scratch, 0, (size_t)(total + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  err = resident_blocks(gear_compact_kernel, kThreads, device, &blocks, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks > total) blocks = total;
  unsigned long long* ticket = (unsigned long long*)scratch;
  gear_compact_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, st>>>(
      (const uint8_t*)data, (const int32_t*)lens, (const uint32_t*)gear_table, (int32_t*)out, ticket, ticket + 1,
      bucket, n_chunks, total, mask_bits, cap);
  return (int)cudaGetLastError();
}
