// K-E blockpack_encode: block-suppress encode of a [B, n] uint8 batch ->
// tags [B, n/bb] u8 (0 zero, 1 constant, 2 literal), literals [B, n] u8 (the
// kept bytes as a dense prefix in block order, zero tail) and n_lit [B] i32.
//
// Replaces the XLA device function skyplane_tpu/ops/blockpack.py:44
// encode_device (an all-equal test per block, then a stable compaction by an
// int32 cumsum over every byte and a scatter), vmapped over the batch in
// ops/pipeline.py _datapath_step_impl.
//
// What bounds it on the H100: bytes. It must read the batch once and write
// the literals (zero tail included) and the tags once: about a device copy of
// the batch. The design is one pass, one launch (plus the memset of its
// scratch: the ticket, then one status word per tile):
//
// - Tiles and tickets. A tile is T = bb * max(1, kTile / bb) bytes of a row
//   (the row's last tile may be shorter). Persistent blocks take tiles from
//   a global ticket in index-major order (tile j of every row before tile
//   j+1 of any row): a tile's predecessors hold earlier tickets, so a
//   look-back never waits on a tile that no running block holds, and the
//   tiles in flight spread over the rows, so a look-back walks few of them.
// - One read. A tile lands in shared memory by one bulk copy (the TMA's 1-D
//   cp.async.bulk on an mbarrier) when its address and length are multiples
//   of 16, else by byte loads.
// - A pipeline one tile deep, so a look-back holds up neither a load nor an
//   aggregate. In each round warp 0 looks back (lookback.cuh) for the offset
//   of the block's previous tile while the workers (warps 1..) handle the
//   current one: thread 32 takes the next ticket and starts its bulk copy;
//   the workers classify the tile (a warp per block, 16-byte reads when bb %
//   16 == 0, for bb >= 32; a thread per run of blocks below), scan its kept
//   bytes per block (bb, 1 or 0) into local offsets and the tile's count,
//   publish the count at once and write the tags out as one run. Then the
//   previous tile is compacted and written. Three input buffers: the
//   previous, the current and the next tile's.
// - Status words without fences (lookback.cuh): a gpu-scope release or
//   acquire fence would wait for the SM's stores in flight, which held the
//   rounds more than any other step. Warps 0 and 1 issue no plain global
//   stores.
// - Literals in one run. The tile's kept bytes (whole literal blocks, one
//   byte per constant block) are compacted in shared memory, shifted to the
//   output's alignment mod 16 (a literal block moves by 4-byte funnel
//   shifts); then [off, E) with E = off + kept goes out with 16-byte
//   streaming stores over its aligned middle and byte stores at its two
//   ends, which may share a 16-byte word with the neighbouring tiles' runs.
// - The zero tail needs no wait. The tile also zeroes the mirrored range
//   [n - (start + T) + E, n - start + off): over a row these ranges partition
//   [n_lit, n) and touch no literal byte, so each tile writes exactly T bytes
//   and every output byte is written once. The row's last tile writes n_lit.
// - A block larger than kTile is a tile of its own: streamed through shared
//   memory to classify it, then read again for the copy once its tag and
//   offset are known. That path reads its bytes twice and is not pipelined;
//   the step's bb = 512 never takes it.
// kTile and kThreads (-D BP_TILE, BP_THREADS) were chosen on the card:
// PERF.md lists the variants.
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "resident.cuh"

#ifndef BP_TILE
#define BP_TILE 24576
#endif
#ifndef BP_THREADS
#define BP_THREADS 384
#endif

namespace {

constexpr int kTile = BP_TILE;  // T0 (ops/kernels.py BLOCKPACK_TILE)
constexpr int kThreads = BP_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kBuf = kTile + 16;  // an input buffer; the slack takes the funnel shift's over-read
constexpr int kCmp = kTile + 32;  // the compacted run, shifted by up to 15 bytes
constexpr int kWarpBlocks = kTile / 32;  // blocks of a tile when bb >= 32
constexpr int kSmemBytes = 3 * kBuf + kCmp + 2 * 4 * kWarpBlocks;  // three buffers, cmp, two s_blk halves
static_assert(kTile % 16 == 0 && kThreads % 32 == 0 && kWarps >= 3 && kWarps <= 32, "tile and block shape");

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint8_t kTagZero = 0;
constexpr uint8_t kTagConst = 1;
constexpr uint8_t kTagLiteral = 2;

// a ticket's tile: row, index in the row, first byte in the row, bytes (0: none)
struct Tile {
  long long row, index, start;
  int len;
};

// tickets run index-major: tile j of every row before tile j+1 of any row
__device__ __forceinline__ Tile tile_of(long long t, int rows, long long total, long long n, long long tile) {
  if (t >= total) return Tile{0, 0, 0, 0};
  const long long index = t / rows, row = t - index * rows, start = index * tile;
  return Tile{row, index, start, (int)(n - start < tile ? n - start : tile)};
}

__device__ __forceinline__ int kept_bytes(uint8_t tag, int bb) {
  return tag == kTagLiteral ? bb : (tag == kTagConst ? 1 : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// whether len bytes at src can land in shared memory by one bulk copy
__device__ __forceinline__ bool bulk_ok(const uint8_t* src, int len) {
  return reinterpret_cast<uintptr_t>(src) % 16 == 0 && len % 16 == 0;
}

// one thread: a bulk copy (the TMA) of len bytes at src into dst, completing on bar
__device__ __forceinline__ void issue_bulk(uint8_t* dst, const uint8_t* src, int len, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after generic writes to the buffer
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(len) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(len), "r"(smem_addr(bar))
               : "memory");
}

// Start loading len bytes at src into dst (shared memory): one bulk copy on
// bar when bulk_ok (returns true: wait on bar), else byte loads by the whole
// block (done at the next __syncthreads).
__device__ __forceinline__ bool load_tile(uint8_t* dst, const uint8_t* src, int len, uint64_t* bar, int tid) {
  const bool bulk = bulk_ok(src, len);
  if (bulk) {
    if (tid == 0) issue_bulk(dst, src, len, bar);
  } else {
    for (int i = tid; i < len; i += kThreads) dst[i] = src[i];
  }
  return bulk;
}

__device__ __forceinline__ void wait_bar(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}


// tag of the block at p (shared memory), one warp
__device__ __forceinline__ uint8_t classify_warp(const uint8_t* p, int bb, int lane) {
  const uint32_t first = p[0];
  bool same = true;
  if (bb % 16 == 0) {  // p is 16-byte aligned
    const uint32_t rep = first * 0x01010101u;
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (int i = lane; i < bb / 16; i += 32) {
      const uint4 v = q[i];
      same &= (v.x == rep) & (v.y == rep) & (v.z == rep) & (v.w == rep);
    }
  } else {
    for (int i = lane; i < bb; i += 32) same &= p[i] == first;
  }
  same = __all_sync(kFull, same);
  return same ? (first == 0 ? kTagZero : kTagConst) : kTagLiteral;
}

// tag of the block at p (shared memory), one thread
__device__ __forceinline__ uint8_t classify_thread(const uint8_t* p, int bb) {
  const uint8_t first = p[0];
  bool same = true;
  for (int i = 1; i < bb; ++i) same &= p[i] == first;
  return same ? (first == 0 ? kTagZero : kTagConst) : kTagLiteral;
}

// dst[0, len) = src[0, len) in shared memory, threads t of nt: whole 4-byte
// words of dst by funnel shifts of two aligned source words (src may read up
// to 4 bytes past len), bytes at its two ends
__device__ __forceinline__ void copy_shifted(uint8_t* dst, const uint8_t* src, int len, int t, int nt) {
  const int head = min((int)((4 - reinterpret_cast<uintptr_t>(dst) % 4) % 4), len);
  const int words = (len - head) / 4;
  const int tail = head + 4 * words;
  const uint8_t* s = src + head;
  const int r = (int)(reinterpret_cast<uintptr_t>(s) % 4);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(s - r);
  uint32_t* dw = reinterpret_cast<uint32_t*>(dst + head);
#pragma unroll 4
  for (int i = t; i < words; i += nt) dw[i] = __funnelshift_r(sw[i], sw[i + 1], 8 * r);
  if (t < head) dst[t] = src[t];
  if (t < len - tail) dst[tail + t] = src[tail + t];
}

// g[0, len) = src[0, len), src in shared memory at the same address mod 16,
// threads t of nt: 16-byte stores over the aligned middle, bytes at the ends
__device__ __forceinline__ void write_run(uint8_t* g, const uint8_t* src, long long len, int t, int nt) {
  const long long head = min((long long)((16 - reinterpret_cast<uintptr_t>(g) % 16) % 16), len);
  const long long words = (len - head) / 16;
  const long long tail = head + 16 * words;
  uint4* gw = reinterpret_cast<uint4*>(g + head);
  const uint4* sw = reinterpret_cast<const uint4*>(src + head);
  for (long long i = t; i < words; i += nt) __stcs(gw + i, sw[i]);  // streaming stores: evict first
  if (t < head) g[t] = src[t];
  if (t < len - tail) g[tail + t] = src[tail + t];
}

// g[0, len) = 0, the same stores
__device__ __forceinline__ void zero_run(uint8_t* g, long long len, int t, int nt) {
  const long long head = min((long long)((16 - reinterpret_cast<uintptr_t>(g) % 16) % 16), len);
  const long long words = (len - head) / 16;
  const long long tail = head + 16 * words;
  uint4* gw = reinterpret_cast<uint4*>(g + head);
  for (long long i = t; i < words; i += nt) __stcs(gw + i, make_uint4(0, 0, 0, 0));
  if (t < head) g[t] = 0;
  if (t < len - tail) g[tail + t] = 0;
}

__device__ __forceinline__ void bar_workers() {  // named barrier 1: the worker warps 1..
  asm volatile("bar.sync 1, %0;" ::"r"(kThreads - 32) : "memory");
}

// exclusive prefix of v over the worker threads (warps 1..); *total = their sum
__device__ __forceinline__ int worker_scan(int v, int* s_warp, int tid, int* total) {
  constexpr int kW = kWarps - 1;
  const int lane = tid & 31, w = (tid >> 5) - 1;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += u;
  }
  if (lane == 31) s_warp[w] = inc;
  bar_workers();
  if (w == 0) {
    int x = lane < kW ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += u;
    }
    if (lane < kW) s_warp[lane] = x;
  }
  bar_workers();
  *total = s_warp[kW - 1];
  return (w > 0 ? s_warp[w - 1] : 0) + inc - v;
}

// warp 0: publish the tile's count and find its offset in the row; lane 0
// also takes the block's next ticket
__device__ __forceinline__ void publish_and_offset(unsigned long long* status, const Tile& c, long long n_tiles,
                                                   unsigned agg, int lane, unsigned long long* ticket,
                                                   long long* s_offset, long long* s_next) {
  unsigned long long* row_status = status + c.row * n_tiles;
  long long off = 0;
  if (c.index == 0) {
    if (lane == 0) store_relaxed(row_status, kInclusive | agg);
  } else {
    if (lane == 0) store_relaxed(row_status + c.index, kAggregate | agg);
    off = look_back(row_status, c.index, agg, lane);
  }
  if (lane == 0) {
    *s_offset = off;
    *s_next = (long long)atomicAdd(ticket, 1ull);
  }
}

__global__ void __launch_bounds__(kThreads) blockpack_encode_kernel(
    const uint8_t* __restrict__ data, uint8_t* __restrict__ tags, uint8_t* __restrict__ literals,
    int32_t* __restrict__ n_lit, unsigned long long* __restrict__ ticket, unsigned long long* __restrict__ status,
    long long n, int bb, long long tile, long long n_tiles, long long total, int rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* cmp = smem + 3 * kBuf;                               // staged tags, then the compacted run
  int* s_blk = reinterpret_cast<int*>(smem + 3 * kBuf + kCmp);  // bb >= 32: local offset << 2 | tag, two halves
  __shared__ __align__(8) uint64_t s_bar[3];
  __shared__ int s_warp[kWarps];
  __shared__ long long s_offset, s_next;
  __shared__ int s_agg;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long nb = n / bb;
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&s_bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&s_bar[1])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&s_bar[2])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    s_next = (long long)atomicAdd(ticket, 1ull);
  }
  __syncthreads();
  Tile cur = tile_of(s_next, rows, total, n, tile);
  uint32_t phase = 0;  // bit b: the parity of buffer b's next bulk copy

  if (tile > kTile) {  // one block per tile, larger than a buffer: stream it twice through buffer 0
    while (cur.len > 0) {
      const uint8_t* src = data + cur.row * n + cur.start;
      const uint8_t first = src[0];
      bool same = true;
      for (int c = 0; c < cur.len; c += kTile) {
        const int len = min(kTile, cur.len - c);
        if (load_tile(smem, src + c, len, &s_bar[0], tid)) {
          wait_bar(&s_bar[0], phase & 1);
          phase ^= 1;
        }
        __syncthreads();
        for (int i = tid; i < len; i += kThreads) same &= smem[i] == first;
        if (!__syncthreads_and(same)) break;  // also frees the buffer
      }
      same = __syncthreads_and(same);
      const uint8_t tag = same ? (first == 0 ? kTagZero : kTagConst) : kTagLiteral;
      const unsigned agg = (unsigned)kept_bytes(tag, bb);
      if (warp == 0) publish_and_offset(status, cur, n_tiles, agg, lane, ticket, &s_offset, &s_next);
      if (tid == 32) tags[cur.row * nb + cur.index] = tag;
      __syncthreads();
      const long long off = s_offset;
      uint8_t* lit_row = literals + cur.row * n;
      if (tag == kTagLiteral) {
        for (int c = 0; c < cur.len; c += kTile) {
          const int len = min(kTile, cur.len - c);
          if (load_tile(smem, src + c, len, &s_bar[0], tid)) {
            wait_bar(&s_bar[0], phase & 1);
            phase ^= 1;
          }
          __syncthreads();
          uint8_t* g = lit_row + off + c;
          uint8_t* dst = cmp + reinterpret_cast<uintptr_t>(g) % 16;
          copy_shifted(dst, smem, len, tid, kThreads);
          __syncthreads();
          write_run(g, dst, len, tid, kThreads);
          __syncthreads();
        }
      } else if (tag == kTagConst && tid == 0) {
        lit_row[off] = first;
      }
      zero_run(lit_row + (n - cur.start - cur.len + off + agg), cur.len - agg, tid, kThreads);
      if (cur.start + cur.len == n && tid == 0) n_lit[cur.row] = (int32_t)(off + agg);
      cur = tile_of(s_next, rows, total, n, tile);
    }
    return;
  }

  // a round: cur is classified and published while next loads and warp 0
  // looks back for prev; then prev is compacted and written
  Tile prev{0, 0, 0, 0};
  int prev_agg = 0, prev_excl = 0;
  int slot = 0, half = 0;  // cur's buffer (prev's is slot - 1 mod 3), cur's half of s_blk
  bool bulk = cur.len > 0 && load_tile(smem, data + cur.row * n + cur.start, cur.len, &s_bar[0], tid);
  while (cur.len > 0 || prev.len > 0) {
    const int nxt = slot == 2 ? 0 : slot + 1, prv = slot == 0 ? 2 : slot - 1;
    const uint8_t* in = smem + slot * kBuf;
    if (cur.len > 0 && bulk) {
      wait_bar(&s_bar[slot], (phase >> slot) & 1);
      phase ^= 1u << slot;
    }
    __syncthreads();  // the byte loads are in; the last run has left cmp

    // warp 0 looks back for prev's offset while the workers (warps 1..) take
    // the next ticket and start its bulk copy (thread 32), classify cur (tags
    // staged in cmp; warps 2.. when bb >= 32, else worker t owns blocks
    // [b0, b1)), scan its kept bytes, publish its count (thread 32) and write
    // its tags out (warps 2..)
    int agg = 0, excl = 0;
    if (warp == 0) {
      long long off = 0;
      if (prev.len > 0 && prev.index > 0) off = look_back(status + prev.row * n_tiles, prev.index, prev_agg, lane);
      if (lane == 0) s_offset = off;
    } else if (cur.len > 0) {
      if (tid == 32) {
        s_next = (long long)atomicAdd(ticket, 1ull);
        const Tile nx = tile_of(s_next, rows, total, n, tile);
        const uint8_t* src = data + nx.row * n + nx.start;
        if (nx.len > 0 && bulk_ok(src, nx.len)) issue_bulk(smem + nxt * kBuf, src, nx.len, &s_bar[nxt]);
      }
      const int t = tid - 32, nt = kThreads - 32;
      const int nblk = cur.len / bb;
      const int q = (nblk + nt - 1) / nt;
      const int b0 = min(t * q, nblk), b1 = min(b0 + q, nblk);
      if (bb >= 32) {
        for (int k = warp - 2; warp >= 2 && k < nblk; k += kWarps - 2) {
          const uint8_t tg = classify_warp(in + k * bb, bb, lane);
          if (lane == 0) cmp[k] = tg;
        }
        bar_workers();
      } else {
        for (int k = b0; k < b1; ++k) cmp[k] = classify_thread(in + k * bb, bb);
      }
      int mine = 0;
      for (int k = b0; k < b1; ++k) mine += kept_bytes(cmp[k], bb);
      excl = worker_scan(mine, s_warp, tid, &agg);
      if (bb >= 32) {
        int* blk = s_blk + half * kWarpBlocks;
        int run = excl;
        for (int k = b0; k < b1; ++k) {
          blk[k] = run << 2 | cmp[k];
          run += kept_bytes(cmp[k], bb);
        }
      }
      if (tid == 32) {
        store_relaxed(status + cur.row * n_tiles + cur.index, (cur.index == 0 ? kInclusive : kAggregate) | (unsigned)agg);
        s_agg = agg;
      } else if (warp >= 2) {
        uint8_t* tag_out = tags + cur.row * nb + cur.start / bb;
        for (int i = tid - 64; i < nblk; i += kThreads - 64) tag_out[i] = cmp[i];
      }
    }
    __syncthreads();
    if (cur.len > 0) agg = s_agg;  // warp 0 carries it to its look-back next round
    const Tile next = cur.len > 0 ? tile_of(s_next, rows, total, n, tile) : Tile{0, 0, 0, 0};
    bool next_bulk = false;
    if (next.len > 0) {
      const uint8_t* src = data + next.row * n + next.start;
      next_bulk = bulk_ok(src, next.len);
      if (!next_bulk) {
        for (int i = tid; i < next.len; i += kThreads) smem[nxt * kBuf + i] = src[i];
      }
    }

    if (prev.len > 0) {  // compact prev into cmp, shifted to its output's alignment, and write it
      const long long off = s_offset;
      const uint8_t* pin = smem + prv * kBuf;
      const int nblk = prev.len / bb;
      uint8_t* g = literals + prev.row * n + off;
      uint8_t* dst = cmp + reinterpret_cast<uintptr_t>(g) % 16;
      if (bb >= 32) {
        const int* blk = s_blk + (half ^ 1) * kWarpBlocks;
        for (int k = warp; k < nblk; k += kWarps) {
          const int v = blk[k];
          const int t = v & 3, lo = v >> 2;
          if (t == kTagLiteral) {
            copy_shifted(dst + lo, pin + k * bb, bb, lane, 32);
          } else if (t == kTagConst && lane == 0) {
            dst[lo] = pin[k * bb];
          }
        }
      } else {
        const int t = tid - 32, nt = kThreads - 32;  // the workers' ownership of prev's blocks
        const int q = (nblk + nt - 1) / nt;
        const int b0 = t < 0 ? nblk : min(t * q, nblk), b1 = min(b0 + q, nblk);
        int run = prev_excl;
        for (int k = b0; k < b1; ++k) {
          const uint8_t* p = pin + k * bb;
          const uint8_t t = classify_thread(p, bb);
          if (t == kTagLiteral) {
            for (int i = 0; i < bb; ++i) dst[run + i] = p[i];
          } else if (t == kTagConst) {
            dst[run] = p[0];
          }
          run += kept_bytes(t, bb);
        }
      }
      __syncthreads();
      // the literal run [off, E) and the mirrored zero range
      if (warp >= 2) {  // warps 2..: the tile writes, as the tags
        const int t = tid - 64, nt = kThreads - 64;
        write_run(g, dst, prev_agg, t, nt);
        zero_run(literals + prev.row * n + (n - prev.start - prev.len + off + prev_agg), prev.len - prev_agg, t, nt);
        if (prev.start + prev.len == n && t == 0) n_lit[prev.row] = (int32_t)(off + prev_agg);
      }
    }
    prev = cur;
    prev_agg = agg;
    prev_excl = excl;
    cur = next;
    bulk = next_bulk;
    slot = nxt;
    half ^= 1;
  }
}

}  // namespace

// data [rows, n] u8 (any alignment; n % bb == 0, n < 2^31); tags [rows,
// n/bb] u8; literals [rows, n] u8; n_lit [rows] i32; scratch
// [scratch_words] u64: the ticket, then one status word per tile of each row
// (ops/kernels.py blockpack_tile_bytes), zeroed here on the stream. Returns a
// cudaError_t.
extern "C" int skyt_blockpack_encode(const void* data, void* tags, void* literals, void* n_lit, void* scratch,
                                     long long scratch_words, long long n, int bb, int rows, int device,
                                     void* stream) {
  if (n <= 0 || bb <= 0 || n % bb || rows <= 0) return (int)cudaErrorInvalidValue;
  const long long tile = (long long)bb * (kTile / bb > 1 ? kTile / bb : 1);
  const long long n_tiles = (n + tile - 1) / tile;
  const long long total = n_tiles * rows;
  if (scratch_words < total + 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[64] = {};
  if (device < 0 || device >= 64 || !smem_set[device]) {
    err = cudaFuncSetAttribute(blockpack_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(scratch, 0, (size_t)(total + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  long long blocks = 0;
  err = resident_blocks(blockpack_encode_kernel, kThreads, device, &blocks, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks > total) blocks = total;
  unsigned long long* ticket = (unsigned long long*)scratch;
  blockpack_encode_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, st>>>(
      (const uint8_t*)data, (uint8_t*)tags, (uint8_t*)literals, (int32_t*)n_lit, ticket, ticket + 1, n, bb, tile,
      n_tiles, total, rows);
  return (int)cudaGetLastError();
}
