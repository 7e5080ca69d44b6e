// Host helper shared by the persistent kernels (segment_fp, segment_fp_fixed,
// gear_compact).
#pragma once
#include <cstddef>
#include <cuda_runtime.h>

// Host: the blocks of `kernel` the whole card holds at once (SMs x resident
// blocks per SM at `threads` a block and `smem` bytes of dynamic shared
// memory), queried once per device and kept, so a launch pays no query.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, int device, long long* out, size_t smem = 0) {
  static long long cached[64] = {};
  const bool keep = device >= 0 && device < 64;
  if (keep && cached[device] > 0) {
    *out = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  *out = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (keep) cached[device] = *out;
  return cudaSuccess;
}
